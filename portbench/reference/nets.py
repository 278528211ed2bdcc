"""The configurations' networks in plain PyTorch, as dicts of named leaves.

Leaf names are those of the port's modules' ``state_dict`` (``h1.lin.w``,
``cell.r``, ...), so the benchmark can hand one set of weights to both
sides. Published definitions (EvoMotion's evo_motion_networks):

- MLP actor: two blocks LayerNorm(Mish(Linear)), then mu = tanh(Linear),
  sigma = softplus(Linear); critic: the two blocks, then Linear -> 1.
  Linear weights xavier-normal with gain 0.1, biases N(0, 0.1); LayerNorm
  gain 1, bias 0, eps 1e-5, biased variance.
- Liquid (LTC) cell: ``unfolding_steps`` fused ODE steps with dt = 1/steps,
  f = SiLU(W i + R x + b), x <- (x + dt f a) / (1 + dt (1/tau + f));
  W, R ~ N(0, 0.1/steps), b ~ N(0, 0.1), a = tau = 1; heads as above.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _linear(name, n_in, n_out):
    return [(f"{name}.w", (n_out, n_in), 0.1 * math.sqrt(2.0 / (n_in + n_out))),
            (f"{name}.b", (n_out,), 0.1)]


def _block(name, n_in, n_out):
    return _linear(f"{name}.lin", n_in, n_out) + [(f"{name}.ln.g", (n_out,), "ones"),
                                                  (f"{name}.ln.b", (n_out,), "zeros")]


def _cell(n_in, neurons, steps):
    std = 0.1 / steps
    return [("cell.w", (neurons, n_in), std), ("cell.r", (neurons, neurons), std),
            ("cell.b", (1, neurons), 0.1), ("cell.a", (1, neurons), "ones"),
            ("cell.tau", (1, neurons), "ones")]


def leaves(family: str, obs: int, act: int, agent: dict):
    """``(actor, critic)`` leaf specs ``(name, shape, std | "ones" | "zeros")``."""
    if family == "ppo_gae":
        h = agent["hidden_size"]
        return (_block("h1", obs, h) + _block("h2", h, h) + _linear("mu", h, act)
                + _linear("sigma", h, act),
                _block("h1", obs, h) + _block("h2", h, h) + _linear("out", h, 1))
    if family == "ppo_gae_liquid":
        n, k = agent["neuron_number"], agent["unfolding_steps"]
        return (_cell(obs, n, k) + _linear("mu", n, act) + _linear("sigma", n, act),
                _cell(obs, n, k) + _linear("out", n, 1))
    raise ValueError(f"no reference networks for {family}")


def init(specs, generator: torch.Generator, device) -> dict:
    """Weights of one network from ``generator``: one normal draw for every
    drawn leaf, split and scaled."""
    drawn = [(name, shape, std) for name, shape, std in specs if not isinstance(std, str)]
    total = sum(math.prod(shape) for _, shape, _ in drawn)
    z = torch.randn(total, generator=generator, device=device)
    out, at = {}, 0
    for name, shape, std in specs:
        if std == "ones":
            out[name] = torch.ones(shape, device=device)
        elif std == "zeros":
            out[name] = torch.zeros(shape, device=device)
        else:
            size = math.prod(shape)
            out[name] = (z[at:at + size] * std).reshape(shape)
            at += size
    return out


def matmul(a, b):
    """``a @ b`` in float32."""
    return a @ b


def tf32_round(x):
    """``x`` rounded to TF32's 10-bit mantissa, to nearest even; gradients
    pass through unchanged."""
    b = x.detach().contiguous().view(torch.int32)
    r = ((b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF).view(torch.float32)
    return x + (r - x.detach())


def matmul_tf32(a, b):
    """``a @ b`` as a TF32 tensor core computes it: inputs rounded to TF32,
    products summed in float32 (the control's precision)."""
    return tf32_round(a) @ tf32_round(b)


def _lin(p, name, x, mm):
    return mm(x, p[f"{name}.w"].T) + p[f"{name}.b"]


def _block_fwd(p, name, x, mm):
    h = _lin(p, f"{name}.lin", x, mm)
    h = h * torch.tanh(F.softplus(h))  # Mish
    mean = h.mean(-1, keepdim=True)
    var = ((h - mean) ** 2).mean(-1, keepdim=True)
    return (h - mean) / torch.sqrt(var + 1e-5) * p[f"{name}.ln.g"] + p[f"{name}.ln.b"]


def mlp_actor(p, obs, mm=matmul):
    h = _block_fwd(p, "h2", _block_fwd(p, "h1", obs, mm), mm)
    return torch.tanh(_lin(p, "mu", h, mm)), F.softplus(_lin(p, "sigma", h, mm))


def mlp_critic(p, obs, mm=matmul):
    return _lin(p, "out", _block_fwd(p, "h2", _block_fwd(p, "h1", obs, mm), mm), mm)


def ltc(p, x, inp, steps: int, mm=matmul):
    """The LTC cell: new hidden state from hidden state ``x`` and input ``inp``."""
    dt = 1.0 / steps
    wi = mm(inp, p["cell.w"].T)
    for _ in range(steps):
        f = F.silu(wi + mm(x, p["cell.r"].T) + p["cell.b"])
        x = (x + dt * f * p["cell.a"]) / (1.0 + dt * (1.0 / p["cell.tau"] + f))
    return x


def liquid_actor(p, x, obs, steps: int, mm=matmul):
    nx = ltc(p, x, obs, steps, mm)
    return torch.tanh(_lin(p, "mu", nx, mm)), F.softplus(_lin(p, "sigma", nx, mm)), nx


def liquid_critic(p, x, obs, steps: int, mm=matmul):
    nx = ltc(p, x, obs, steps, mm)
    return _lin(p, "out", nx, mm), nx

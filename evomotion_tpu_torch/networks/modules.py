"""Network modules in PyTorch (port of ``evomotion_tpu/networks/modules.py``).

Reference modules (evo_motion_networks/src/networks/*.cpp):
- Actor: Linear-Mish-LayerNorm x2 head, mu = Linear+Tanh, sigma =
  Linear+Softplus (actor.cpp:9-33)
- Critic: 2 blocks + Linear->1 (critic.cpp:8-21)
- QNetwork: 3 blocks on concat(state, action) (q_net.cpp:8-31)
- BatchNormQNetwork: BatchRenorm between every layer incl. the input
  (q_net_bn.cpp:9-33)
- weight init: xavier-normal gain 0.1, bias N(0, 0.1); LayerNorm ones/zeros
  (init.cpp:7-18)

Each module's parameters and buffers carry the names of the JAX package's
param and state pytrees, so ``state_dict`` keys are the JAX paths with ``.``
for ``/`` (``h1.lin.w`` is ``h1/lin/w``): ``convert`` and
``train.checkpoint`` carry weights across by name. Init draws from an
explicit ``torch.Generator`` (CPU, so a seed gives the same weights on every
device); the weights are built on the CPU and moved with ``.to(device)``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def mish(x):
    return x * torch.tanh(F.softplus(x))


def _normal(shape, std, generator):
    return torch.randn(shape, generator=generator) * std


class Linear(nn.Module):
    """torch::nn::Linear with the reference init (init.cpp:7-13): ``w``
    [out, in] xavier-normal with gain 0.1, ``b`` [out] N(0, 0.1)."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True, generator=None):
        super().__init__()
        std = 0.1 * math.sqrt(2.0 / (in_dim + out_dim))
        self.w = nn.Parameter(_normal((out_dim, in_dim), std, generator))
        self.b = nn.Parameter(_normal((out_dim,), 0.1, generator)) if bias else None

    def forward(self, x):
        return F.linear(x, self.w, self.b)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis: biased variance, eps 1e-5, gain ``g``
    and bias ``b``."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.g = nn.Parameter(torch.ones(dim))
        self.b = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return F.layer_norm(x, self.g.shape, self.g, self.b, self.eps)


class MlpBlock(nn.Module):
    """LayerNorm(Mish(Linear(x)))."""

    def __init__(self, in_dim: int, hidden: int, generator=None):
        super().__init__()
        self.lin = Linear(in_dim, hidden, generator=generator)
        self.ln = LayerNorm(hidden)

    def forward(self, x):
        return self.ln(mish(self.lin(x)))


class Actor(nn.Module):
    """(mu, sigma) = (tanh, softplus) heads over two blocks."""

    def __init__(self, state_dim: int, action_dim: int, hidden: int, generator=None):
        super().__init__()
        self.h1 = MlpBlock(state_dim, hidden, generator)
        self.h2 = MlpBlock(hidden, hidden, generator)
        self.mu = Linear(hidden, action_dim, generator=generator)
        self.sigma = Linear(hidden, action_dim, generator=generator)

    def forward(self, state):
        h = self.h2(self.h1(state))
        return torch.tanh(self.mu(h)), F.softplus(self.sigma(h))


class Critic(nn.Module):
    def __init__(self, state_dim: int, hidden: int, generator=None):
        super().__init__()
        self.h1 = MlpBlock(state_dim, hidden, generator)
        self.h2 = MlpBlock(hidden, hidden, generator)
        self.out = Linear(hidden, 1, generator=generator)

    def forward(self, state):
        return self.out(self.h2(self.h1(state)))


class QNetwork(nn.Module):
    def __init__(self, state_dim: int, action_dim: int, hidden: int, generator=None):
        super().__init__()
        self.h1 = MlpBlock(state_dim + action_dim, hidden, generator)
        self.h2 = MlpBlock(hidden, hidden, generator)
        self.h3 = MlpBlock(hidden, hidden, generator)
        self.out = Linear(hidden, 1, generator=generator)

    def forward(self, state, action):
        x = torch.cat([state, action], -1)
        return self.out(self.h3(self.h2(self.h1(x))))


class BatchRenorm(nn.Module):
    """Batch renormalization (networks/batch_renorm.cpp:7-59): eps 1e-5,
    momentum 0.01, affine, warmup 1e5 steps, r_max 1->3, d_max 0->5.

    In training mode the batch statistics normalize ``x`` (corrected by r
    and d against the running statistics) and the buffers ``running_mean``,
    ``running_std`` and ``step`` are updated in place; in eval mode the
    running statistics normalize and nothing changes."""

    def __init__(self, dim: int, eps: float = 1e-5, momentum: float = 0.01,
                 warmup_steps: int = 100_000):
        super().__init__()
        self.eps, self.momentum, self.warmup_steps = eps, momentum, warmup_steps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_std", torch.ones(dim))
        self.register_buffer("step", torch.zeros((), dtype=torch.int32))

    def forward(self, x):
        eps = self.eps
        if not self.training:
            y = (x - self.running_mean) / (self.running_std + eps)
            return self.weight * y + self.bias
        batch_mean = x.mean(0)
        batch_std = x.std(0, correction=0) + eps  # biased, as torch x.std(0, false)
        warm = self.warmup_steps
        t = torch.clamp_max(self.step, warm).float()
        r_max = 1.0 + t * (3.0 - 1.0) / warm
        d_max = 0.0 + t * (5.0 - 0.0) / warm
        with torch.no_grad():
            r = torch.clamp(batch_std / self.running_std, 1.0 / r_max, r_max)
            d = torch.clamp((batch_mean - self.running_mean) / (self.running_std + eps),
                            -d_max, d_max)
        y = (x - batch_mean) / batch_std * r + d
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_((1.0 - m) * self.running_mean + m * batch_mean)
            self.running_std.copy_((1.0 - m) * self.running_std + m * batch_std)
            self.step.copy_(torch.clamp_max(self.step + 1, warm))
        return self.weight * y + self.bias


class BatchNormQNetwork(nn.Module):
    """Q network with BatchRenorm before every layer (q_net_bn.cpp:9-33).
    ``train()`` / ``eval()`` select the BatchRenorm mode."""

    def __init__(self, state_dim: int, action_dim: int, hidden: int, generator=None):
        super().__init__()
        self.bn0 = BatchRenorm(state_dim + action_dim)
        self.bn1 = BatchRenorm(hidden)
        self.bn2 = BatchRenorm(hidden)
        self.bn3 = BatchRenorm(hidden)
        self.l1 = Linear(state_dim + action_dim, hidden, generator=generator)
        self.l2 = Linear(hidden, hidden, generator=generator)
        self.l3 = Linear(hidden, hidden, generator=generator)
        self.out = Linear(hidden, 1, generator=generator)

    def forward(self, state, action):
        x = self.bn0(torch.cat([state, action], -1))
        x = self.bn1(mish(self.l1(x)))
        x = self.bn2(mish(self.l2(x)))
        x = self.bn3(mish(self.l3(x)))
        return self.out(x)


# --- misc helpers ----------------------------------------------------------


def exp_module(x):
    """ExpModule (networks/misc.cpp; unused helper in the reference)."""
    return torch.exp(x)


def clamp_module(x, min_value: float, max_value: float):
    """ClampModule (networks/misc.cpp)."""
    return torch.clamp(x, min_value, max_value)


def count_parameters(module: nn.Module) -> int:
    """Parameters of ``module`` (buffers such as BatchRenorm's running
    statistics live in the JAX package's separate state tree, not here)."""
    return sum(p.numel() for p in module.parameters())


@torch.no_grad()
def hard_update(target: nn.Module, source: nn.Module) -> None:
    """functions.cpp hard_update: copy ``source``'s parameters into ``target``."""
    for t, s in zip(target.parameters(), source.parameters()):
        t.copy_(s)


@torch.no_grad()
def soft_update(target: nn.Module, source: nn.Module, tau: float) -> None:
    """functions.cpp soft_update (Polyak averaging), in place on ``target``."""
    for t, s in zip(target.parameters(), source.parameters()):
        t.copy_(tau * s + (1.0 - tau) * t)

"""Liquid-time-constant (LTC) recurrent cell and its wrappers (port of
``evomotion_tpu/networks/liquid.py``).

Reference: evo_motion_networks/src/networks/liquid_cell.cpp and the
liquid_{actor,critic}.cpp / q_net_liquid.cpp wrappers. Cell dynamics
(liquid_cell.cpp:52-63): ``unfolding_steps`` fused-ODE iterations with
dt = 1/steps:

    f(x, i) = SiLU(W i + R x + b)
    x <- (x + dt * f * a) / (1 + dt * (1/tau + f))

Learnable a, tau, b; W/R ~ N(0, 0.1/steps) without bias; b ~ N(0, 0.1);
a = tau = 1; first hidden state = SiLU(0) = 0. Each wrapper puts one
reference-initialized linear head (mu/sigma or value) on the cell output.

The modules keep the JAX param trees' names and shapes (``cell.w`` [n, in],
``cell.r`` [n, n], ``cell.b``, ``cell.a``, ``cell.tau`` [1, n]; heads
``mu``, ``sigma``, ``out`` as ``modules.Linear``), so ``convert`` and
``train.checkpoint`` carry them across by name. Every forward takes the
hidden state first and returns the new one last; leading axes are free
(``[B, n]`` or the trainers' ``[T, N, n]``). Init draws from an explicit
CPU ``torch.Generator`` in the JAX order (cell w, r, b; then the heads).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .modules import Linear, _normal


def first_x(neurons: int, batch: int, device=None) -> torch.Tensor:
    """The first hidden state of ``batch`` chains, [batch, neurons]: SiLU(0) = 0."""
    return torch.zeros((batch, neurons), device=device)


class LiquidCell(nn.Module):
    def __init__(self, input_dim: int, neurons: int, unfolding_steps: int, generator=None):
        super().__init__()
        std_w = 0.1 / unfolding_steps
        self.unfolding_steps = unfolding_steps
        self.w = nn.Parameter(_normal((neurons, input_dim), std_w, generator))
        self.r = nn.Parameter(_normal((neurons, neurons), std_w, generator))
        self.b = nn.Parameter(_normal((1, neurons), 0.1, generator))
        self.a = nn.Parameter(torch.ones((1, neurons)))
        self.tau = nn.Parameter(torch.ones((1, neurons)))

    def forward(self, x, state):
        """``unfolding_steps`` ODE iterations from hidden state ``x`` on input
        ``state``; returns the new hidden state."""
        dt = 1.0 / self.unfolding_steps
        wi = state @ self.w.T  # the input projection is loop-invariant
        for _ in range(self.unfolding_steps):
            f = F.silu(wi + x @ self.r.T + self.b)
            x = (x + dt * f * self.a) / (1.0 + dt * (1.0 / self.tau + f))
        return x


class LiquidActor(nn.Module):
    """(tanh(mu), softplus(sigma), new x) over an LTC cell."""

    def __init__(self, state_dim: int, action_dim: int, neurons: int, unfolding_steps: int,
                 generator=None):
        super().__init__()
        self.cell = LiquidCell(state_dim, neurons, unfolding_steps, generator)
        self.mu = Linear(neurons, action_dim, generator=generator)
        self.sigma = Linear(neurons, action_dim, generator=generator)

    def forward(self, x, state):
        new_x = self.cell(x, state)
        return torch.tanh(self.mu(new_x)), F.softplus(self.sigma(new_x)), new_x


class LiquidCritic(nn.Module):
    """(value, new x) over an LTC cell."""

    def __init__(self, state_dim: int, neurons: int, unfolding_steps: int, generator=None):
        super().__init__()
        self.cell = LiquidCell(state_dim, neurons, unfolding_steps, generator)
        self.out = Linear(neurons, 1, generator=generator)

    def forward(self, x, state):
        new_x = self.cell(x, state)
        return self.out(new_x), new_x


class LiquidQNet(nn.Module):
    """(Q, new x) over an LTC cell fed ``[state, action]``."""

    def __init__(self, state_dim: int, action_dim: int, neurons: int, unfolding_steps: int,
                 generator=None):
        super().__init__()
        self.cell = LiquidCell(state_dim + action_dim, neurons, unfolding_steps, generator)
        self.out = Linear(neurons, 1, generator=generator)

    def forward(self, x, state, action):
        new_x = self.cell(x, torch.cat([state, action], -1))
        return self.out(new_x), new_x

"""Environment layer of the port: batch-native envs in PyTorch.

Port of ``evomotion_tpu/envs/base.py``. An env is ``reset(n_envs, generator)``
and ``step(state, action, generator)`` over a batch, env axis first; the
reference's blocking reset settle loops become a per-env settling phase
inside ``step`` (``valid=False`` transitions), so the batch never stalls.

Every env takes its physics step at construction: the batched step (slim
rows, the fused sweep kernel) or the per-env step (fat rows, the fat-row
sweep kernel) that the JAX package runs on one unbatched world. The
cartpoles use the per-env step; ``RobotWalk`` selects it with
``per_env_step=True``. The sequential tier (the CLI's ``run``) is a batch
of one on the per-env step.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def env_rand(shape, generator, device) -> torch.Tensor:
    """U(0,1) draws for an env batch (one process, no mesh)."""
    return torch.rand(shape, generator=generator, device=device)


class StepResult(NamedTuple):
    obs: torch.Tensor  # [B, obs]
    reward: torch.Tensor  # [B] f32
    done: torch.Tensor  # [B] bool
    valid: torch.Tensor  # [B] bool: False while the env is settling
    # True on the done step iff the episode ended by reaching the win horizon
    win: torch.Tensor  # [B] bool


def get_value(parameters: dict[str, str], key: str, default):
    """Typed parameter lookup with defaults.

    Mirrors EnvironmentFactory::get_value (environment.h:86-96,
    env_factory.cpp:22-41): parse the string by the default's type."""
    if key not in parameters:
        return default
    raw = parameters[key]
    if isinstance(default, bool):
        if raw in ("true", "false"):
            return raw == "true"
        raise ValueError(raw)
    if isinstance(default, int):
        return int(raw)
    if isinstance(default, float):
        return float(raw)
    return raw


def where(mask, a, b):
    """Per-env select over (nested) NamedTuples of tensors; mask [B] bool."""
    if isinstance(a, tuple):
        return type(a)(*(where(mask, x, y) for x, y in zip(a, b)))
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)), a, b)


def pick(x, i: int):
    """Env ``i`` of (nested) NamedTuples of tensors, as a batch of one."""
    if isinstance(x, tuple):
        return type(x)(*(pick(y, i) for y in x))
    return x[i:i + 1]


def draws(table, reset_idx, n: int, generator, device):
    """``n`` U(0,1) draws per env for a reset: rows of the mt19937 reset
    table at ``reset_idx`` (wrapping) when the env has one, else from the
    ``torch.Generator`` (in the global batch's shape inside a mesh,
    ``parallel.mesh.env_rand``). Returns [B, n] on ``device``."""
    if table is not None:
        return table[reset_idx.long() % table.shape[0]]
    if generator is None:
        raise ValueError("an env without mt_seed needs a torch.Generator")
    u = env_rand((reset_idx.shape[0], n), generator, generator.device)
    return u.to(device)

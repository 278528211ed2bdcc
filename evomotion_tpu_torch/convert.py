"""Carry models, state and weights across from the JAX package, as numpy arrays.

This is the port's "weights and state carried across": the tests build one
model and states with the JAX package, hand them over through these
functions, and step both packages from the same inputs. Nothing here
imports the JAX package; inputs are objects with the right attributes (a JAX
``PhysicsModel``, ``PhysicsState`` or ``RobotEnvState``) or mappings of field
name to array. Arrays keep their shapes: one world (the JAX per-env
layout, what ``engine.physics_step`` steps with the per-env step) or a batch
with the env axis FIRST (a vmapped JAX state).

Network weights: a JAX param or state pytree is nested dicts of arrays whose
paths are the names of the port module's parameters and buffers
(``networks.modules``: ``h1/lin/w`` is ``h1.lin.w``), so one pair of
functions serves the actor, critic, Q and BN-Q networks and BatchRenorm:
``params_tree`` / ``load_params`` for parameters, ``state_tree`` /
``load_state`` for buffers (BatchRenorm's running statistics and step).
``adam_tree`` / ``load_adam`` map a ``torch.optim.Adam`` over a module's
parameters to an optax Adam state and back: ``count`` is the step, ``mu``
and ``nu`` are ``exp_avg`` and ``exp_avg_sq``. Two layouts: the JAX
trainers' and agents' ``optax.chain(clip_by_global_norm, adam)``, ``((),
(adam, ()))`` with keys ``1/0/count``, and the plain ``optax.adam`` of the
SAC and CrossQ agents without a clip, ``(adam, ())`` with keys
``0/count``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from .envs.robot import RobotEnvState
from .physics.engine import PhysicsState
from .physics.model import PhysicsModel


def _field(src, name):
    return src[name] if isinstance(src, dict) else getattr(src, name)


def model_from_arrays(src) -> PhysicsModel:
    """The port's PhysicsModel with every field of ``src`` (numpy arrays are
    copied; tuples and scalars carried as they are)."""
    kw = {}
    for f in dataclasses.fields(PhysicsModel):
        v = _field(src, f.name)
        kw[f.name] = np.array(v) if isinstance(v, np.ndarray) else v
    return PhysicsModel(**kw)


def _tensor(x, device, dtype=None):
    a = np.asarray(x)
    if dtype is None:
        dtype = torch.int32 if a.dtype.kind in "iu" else (
            torch.bool if a.dtype.kind == "b" else torch.float32)
    return torch.as_tensor(a, dtype=dtype, device=device).contiguous()


def physics_state(src, device) -> PhysicsState:
    """PhysicsState arrays of one world or of a batch (env axis first) as
    port tensors."""
    return PhysicsState(*(_tensor(_field(src, f), device) for f in PhysicsState._fields))


def robot_env_state(src, device) -> RobotEnvState:
    """RobotEnvState arrays of one world or of a batch (env axis first) as
    port tensors; the JAX state's PRNG ``key`` has no counterpart and is
    dropped."""
    kw = {}
    for f in RobotEnvState._fields:
        v = _field(src, f)
        kw[f] = physics_state(v, device) if f == "physics" else _tensor(v, device)
    return RobotEnvState(**kw)


# --- network weights and optimizer state ------------------------------------


def _nested(named) -> dict:
    """``{"a.b.c": x}`` -> ``{"a": {"b": {"c": x}}}``."""
    out: dict = {}
    for name, x in named:
        *path, leaf = name.split(".")
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = x
    return out


def _at(tree, name):
    for k in name.split("."):
        tree = tree[k]
    return tree


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def params_tree(module: nn.Module) -> dict:
    """The module's parameters as the JAX package's param pytree (nested
    dicts of numpy arrays)."""
    return _nested((n, _numpy(p)) for n, p in module.named_parameters())


def state_tree(module: nn.Module) -> dict:
    """The module's buffers as the JAX package's state pytree (BatchRenorm:
    ``running_mean``, ``running_std``, ``step``)."""
    return _nested((n, _numpy(b)) for n, b in module.named_buffers())


@torch.no_grad()
def _copy_into(named, tree):
    for name, t in named:
        src = torch.tensor(np.asarray(_at(tree, name)))
        if tuple(src.shape) != tuple(t.shape):
            raise ValueError(f"{name}: shape {tuple(src.shape)}, module has {tuple(t.shape)}")
        t.copy_(src.to(dtype=t.dtype))


def load_params(module: nn.Module, tree) -> nn.Module:
    """Copies a JAX param pytree into the module's parameters (in place)."""
    _copy_into(module.named_parameters(), tree)
    return module


def load_state(module: nn.Module, tree) -> nn.Module:
    """Copies a JAX state pytree into the module's buffers (in place)."""
    _copy_into(module.named_buffers(), tree)
    return module


def adam_tree(opt: torch.optim.Adam, module: nn.Module, clip: bool = True) -> tuple:
    """``opt``'s state over ``module``'s parameters as an optax state:
    ``(clip state, (adam state, lr state))`` for ``optax.chain(
    clip_by_global_norm, adam)`` (``clip``), else ``(adam state, lr
    state)`` for a plain ``optax.adam``; ``count`` int32, ``mu`` and ``nu``
    param pytrees (zeros before the first step)."""
    named = list(module.named_parameters())
    st = [opt.state.get(p, {}) for _, p in named]
    count = int(st[0]["step"]) if st and "step" in st[0] else 0

    def moments(key):
        return _nested((n, _numpy(s[key]) if key in s else np.zeros(tuple(p.shape), np.float32))
                       for (n, p), s in zip(named, st))

    adam = ({"count": np.int32(count), "mu": moments("exp_avg"), "nu": moments("exp_avg_sq")},
            ())
    return ((), adam) if clip else adam


@torch.no_grad()
def load_adam(opt: torch.optim.Adam, module: nn.Module, tree) -> torch.optim.Adam:
    """Fills ``opt``'s state over ``module``'s parameters from an optax
    state in either layout of :func:`adam_tree` (told apart by where
    ``count`` is)."""
    adam = tree[0] if "count" in _keys(tree[0]) else tree[1][0]
    count = float(np.asarray(adam["count"]))
    for name, p in module.named_parameters():
        opt.state[p] = {
            "step": torch.tensor(count, dtype=torch.float32),
            "exp_avg": torch.tensor(np.asarray(_at(adam["mu"], name))).to(p),
            "exp_avg_sq": torch.tensor(np.asarray(_at(adam["nu"], name))).to(p),
        }
    return opt


def _keys(node):
    """The field names of a dict or NamedTuple (an optax state), else ()."""
    if isinstance(node, dict):
        return node.keys()
    return getattr(node, "_fields", ())

"""Carry models and state across from the JAX package, as numpy arrays.

This is the port's "weights and state carried across": the tests build one
model and states with the JAX package, hand them over through these
functions, and step both packages from the same inputs. Nothing here
imports the JAX package; inputs are objects with the right attributes (a JAX
``PhysicsModel``, ``PhysicsState`` or ``RobotEnvState``) or mappings of field
name to array. Arrays keep their shapes: one world (the JAX per-env
layout, what ``engine.physics_step`` steps with the per-env step) or a batch
with the env axis FIRST (a vmapped JAX state).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

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

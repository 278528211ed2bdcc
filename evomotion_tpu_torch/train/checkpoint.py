"""Per-component checkpointing in the JAX package's key scheme (port of
``evomotion_tpu/train/checkpoint.py``).

Reference: evo_motion_networks/include/evo_motion_networks/saver.h:14-45:
one archive per module or optimizer, a file per component (actor.th,
critic_1_optimizer.th, ...). Here, as in the JAX package, each component is
one ``<name>.npz`` whose keys are the tree paths joined by ``/``: dict keys,
sequence indices and NamedTuple field names (``h1/lin/w``; an optax chain's
Adam state as ``1/0/count``, ``1/0/mu/<param path>``, ``1/0/nu/<param
path>``); a tree that is a single leaf has the key ``''``. A directory written
by either package loads in the other.

A tree is nested dicts, lists, tuples and NamedTuples over tensors, numpy
arrays and Python numbers. An ``nn.Module`` stands for its parameter tree
(``convert.params_tree``): ``load_component`` fills its parameters in place.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

from ..convert import load_params, params_tree


def _children(node):
    if isinstance(node, dict):
        return list(node.items())
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def _numpy(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """``{path: array}`` of every leaf of ``tree``, paths joined by ``/``."""
    kids = _children(tree)
    if kids is None:
        return {prefix: _numpy(tree)}
    flat = {}
    for k, child in kids:
        flat.update(_flatten(child, f"{prefix}/{k}" if prefix else str(k)))
    return flat


def _unflatten_like(flat, like, prefix: str = ""):
    """``like``'s structure with each leaf read from ``flat`` at its path,
    cast to the leaf's dtype and shape: a tensor stays a tensor on its
    device, an array an array, a Python number a number."""
    kids = _children(like)
    if kids is None:
        arr = np.asarray(flat[prefix])
        if torch.is_tensor(like):
            t = torch.as_tensor(arr).to(device=like.device, dtype=like.dtype)
            return t.reshape(like.shape)
        if isinstance(like, np.ndarray):
            return arr.astype(like.dtype).reshape(like.shape)
        return type(like)(arr)
    vals = [_unflatten_like(flat, child, f"{prefix}/{k}" if prefix else str(k))
            for k, child in kids]
    if isinstance(like, dict):
        return dict(zip(like.keys(), vals))
    if hasattr(like, "_fields"):
        return type(like)(*vals)
    return type(like)(vals)


def save_component(folder: str, name: str, tree) -> None:
    """save_torch equivalent: one file per component, named like the
    reference (actor.th -> actor.npz)."""
    if isinstance(tree, nn.Module):
        tree = params_tree(tree)
    os.makedirs(folder, exist_ok=True)
    np.savez(os.path.join(folder, f"{name}.npz"), **_flatten(tree))


def load_component(folder: str, name: str, like):
    """load_torch equivalent: restores into the structure of ``like``. A
    module ``like`` gets its parameters filled in place and is returned."""
    with np.load(os.path.join(folder, f"{name}.npz")) as data:
        flat = dict(data.items())
    if isinstance(like, nn.Module):
        load_params(like, _unflatten_like(flat, params_tree(like)))
        return like
    return _unflatten_like(flat, like)

"""Data parallelism over the env batch with ``torch.distributed`` (port of
``evomotion_tpu/parallel/mesh.py``).

As in the JAX package, the parallelism is over the env axis: W ranks (one
process each) step their own rows of the env batch, while the networks,
their optimizer states, the generator and the replay rings are replicated.
A train step on W ranks computes what the same step computes in one
process at the same global batch N and seed, up to f32 summation order.
JAX gets this from XLA's sharding propagation; here the trainers call the
collectives below, each a no-op outside an active mesh, so a trainer run
without a mesh is the one-process trainer unchanged:

- every random draw of the env batch (actions, reset tilts) is drawn in
  its global shape ``[N, ...]`` from the replicated generator and each rank
  keeps its rows (:func:`env_rand`), so the draws equal the one-process
  run's and the ranks' generators stay in lockstep (a local-shape draw
  would advance a CUDA generator's Philox offset by a local amount);
- the batched PPOs (``ppo_batched``, ``ppo_liquid_batched``) take their
  GAE statistics, loss denominators, obs statistics and metrics over the
  global batch (:func:`psum`) and sum their gradients over the ranks
  before clipping (:func:`all_reduce_grads`);
- the ring trainers (``offpolicy_batched``, ``onpolicy_step_batched``)
  gather each rollout into its global ``[T, N, ...]`` block
  (:func:`gather_env`), so the replicated ring takes identical writes on
  every rank and equals the one-process ring; every rank then runs the same
  updates, whose gradients and BatchRenorm statistics are rank 0's
  everywhere (:func:`replicate`, from ``agents.base.ComponentAgent._step``)
  so that no nondeterministic kernel can split the replicas.

The collectives are ``all_reduce`` (sum) and ``broadcast`` only: gloo runs
no other on CUDA tensors. A rollout is gathered by one broadcast per rank,
not by an all-reduce of a zero-filled buffer, so that every bit arrives as
it left (-0.0 + 0.0 is +0.0). A failed collective raises.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch
import torch.distributed as dist

from ..device import resolve

# train-state fields whose leaves carry the env batch on dim 0: JAX's four,
# and the port's per-env hidden states of the liquid trainers (which JAX
# leaves to XLA's propagation)
_ENV_BATCH_FIELDS = ("env_state", "obs", "prev_valid", "ep_steps", "actor_x", "critic_x", "xs")

_ACTIVE: list["EnvMesh"] = []


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None, process_id: int | None = None,
                         backend: str | None = None, device=None) -> torch.device:
    """Joins this process to the process group and returns its device.

    With ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id`` the group meets at ``tcp://<coordinator_address>``, as
    ``jax.distributed.initialize`` takes them; with none of the three it
    reads ``torchrun``'s environment (``env://``). The device is ``cuda``
    unless ``device`` says otherwise (``cpu``), the card the rank's
    ``LOCAL_RANK`` picks among the visible ones (two ranks may share one).
    The backend is ``nccl`` on ``cuda`` and ``gloo`` on the CPU, or the one
    named: NCCL refuses two ranks on one card, which need ``gloo``."""
    given = [x is not None for x in (coordinator_address, num_processes, process_id)]
    if any(given) and not all(given):
        raise ValueError("give all of coordinator_address, num_processes and process_id, "
                         "or none (torchrun's environment)")
    dev = resolve(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))
                           % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if all(given):
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)
    else:
        dist.init_process_group(backend, init_method="env://")
    return dev


@dataclasses.dataclass
class EnvMesh:
    """One rank's view of the env axis: its process ``group`` (None: the
    default one), ``rank`` and ``world`` size, and its ``device``. Inside
    ``with mesh:`` the trainers' collectives run over the group."""

    group: Any
    rank: int
    world: int
    device: torch.device

    def rows(self, n_envs: int) -> slice:
        """This rank's rows ``[r N / W, (r + 1) N / W)`` of an ``n_envs`` batch;
        ``ValueError`` when W does not divide N (as JAX's ``NamedSharding``)."""
        if n_envs % self.world:
            raise ValueError(f"{n_envs} envs do not split evenly over {self.world} ranks")
        n = n_envs // self.world
        return slice(self.rank * n, (self.rank + 1) * n)

    def __enter__(self):
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc):
        _ACTIVE.remove(self)


def make_env_mesh(device=None, group=None) -> EnvMesh:
    """The env mesh over ``group`` (default: the whole process group, which
    :func:`initialize_multihost` has joined) for a rank on ``device``. A plain
    process group, not ``init_device_mesh``, whose default backend on
    ``cuda`` is NCCL."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize_multihost first")
    return EnvMesh(group, dist.get_rank(group), dist.get_world_size(group), resolve(device))


def current() -> EnvMesh | None:
    """The innermost active mesh, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def _map_rows(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_rows(v, fn) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_rows(v, fn) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_rows(v, fn) for v in tree)
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def shard_train_state(state, mesh: EnvMesh):
    """This rank's train state: the env-batch fields (``_ENV_BATCH_FIELDS``)
    cut to its rows, everything else (networks, optimizers, generator,
    rings, counters) shared with ``state``, which is left as it is."""
    fields = [f.name for f in dataclasses.fields(state) if f.name in _ENV_BATCH_FIELDS]
    n_envs = state.obs.shape[0]
    rows = mesh.rows(n_envs)
    for name in fields:
        for leaf in _leaves(getattr(state, name)):
            if leaf.dim() == 0 or leaf.shape[0] != n_envs:
                raise ValueError(f"{name}: a leaf of shape {tuple(leaf.shape)} does not "
                                 f"carry the {n_envs}-env batch on dim 0")
    return dataclasses.replace(state, **{
        name: _map_rows(getattr(state, name), lambda t: t[rows].clone()) for name in fields})


def unshard_train_state(state, mesh: EnvMesh):
    """The inverse of :func:`shard_train_state`: the env-batch fields
    gathered from every rank into the global batch (a collective: every
    rank calls it), e.g. to save a full train state from rank 0."""
    fields = [f.name for f in dataclasses.fields(state) if f.name in _ENV_BATCH_FIELDS]
    trees = [getattr(state, name) for name in fields]
    leaves = [x for t in trees for x in _leaves(t)]
    with mesh:
        full = iter(gather_env(leaves, 0))
    return dataclasses.replace(state, **{
        name: _map_rows(tree, lambda _: next(full)) for name, tree in zip(fields, trees)})


def make_sharded_train_step(trainer, mesh: EnvMesh, timer=None):
    """``(step, state)``: the trainer's train step run inside ``mesh`` and
    this rank's shard of a fresh train state (every rank inits the whole
    batch from the same seed, then keeps its rows)."""
    step = trainer.train_step_fn(timer=timer)

    def run(state, *args, **kwargs):
        with mesh:
            return step(state, *args, **kwargs)

    return run, shard_train_state(trainer.init(), mesh)


# -- the collectives of the trainers (no-ops outside an active mesh) ------------


def env_rand(shape, generator, device) -> torch.Tensor:
    """U(0,1) draws for an env batch, ``shape`` = [n, ...] with n this rank's
    envs: drawn as [W n, ...] from ``generator`` (replicated), this rank's
    rows kept."""
    mesh = current()
    if mesh is None:
        return torch.rand(shape, generator=generator, device=device)
    n = shape[0]
    u = torch.rand((n * mesh.world, *shape[1:]), generator=generator, device=device)
    return u[mesh.rank * n:(mesh.rank + 1) * n]


def psum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks (a new tensor); ``x`` itself outside a
    mesh."""
    mesh = current()
    if mesh is None:
        return x
    x = x.clone()
    dist.all_reduce(x, group=mesh.group)
    return x


def _flat_apply(tensors, collective) -> None:
    """Runs ``collective`` on one flat f32 buffer holding ``tensors`` and
    copies the result back into them."""
    tensors = list(tensors)
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    collective(flat)
    i = 0
    for t in tensors:
        t.copy_(flat[i:i + t.numel()].view_as(t))
        i += t.numel()


def all_reduce_grads(params) -> None:
    """Sums the gradients of ``params`` over the ranks, in place (one
    collective); a no-op outside a mesh."""
    mesh = current()
    if mesh is None:
        return
    _flat_apply((p.grad for p in params if p.grad is not None),
                lambda flat: dist.all_reduce(flat, group=mesh.group))


def replicate(tensors) -> None:
    """Gives every rank rank 0's values of ``tensors`` (f32), in place (one
    collective); a no-op outside a mesh."""
    mesh = current()
    if mesh is None:
        return
    src = dist.get_global_rank(mesh.group, 0) if mesh.group is not None else 0
    _flat_apply(tensors, lambda flat: dist.broadcast(flat, src, group=mesh.group))


_EXACT_IN_F32 = (torch.float32, torch.bool, torch.int32)


def gather_env(xs, dim: int) -> list[torch.Tensor]:
    """Each tensor of ``xs`` with its env axis ``dim`` gathered from every
    rank: [..., n, ...] -> [..., W n, ...], rank r's rows at ``[r n, (r + 1)
    n)``, every bit as it left its rank. The tensors travel as one f32
    buffer (f32, bool, or int32 below 2^24), one broadcast per rank; the
    inputs themselves outside a mesh."""
    xs = list(xs)
    mesh = current()
    if mesh is None:
        return xs
    for x in xs:
        if x.dtype not in _EXACT_IN_F32:
            raise TypeError(f"gather_env: {x.dtype} does not travel exactly as f32")
    lead, n = xs[0].shape[:dim], xs[0].shape[dim]
    nl = int(torch.Size(lead).numel())
    cols = [x.reshape(nl, n, -1) for x in xs]
    widths = [c.shape[-1] for c in cols]
    buf = torch.empty((mesh.world, nl, n, sum(widths)), device=xs[0].device)
    buf[mesh.rank] = torch.cat([c.float() for c in cols], -1)
    for r in range(mesh.world):
        src = dist.get_global_rank(mesh.group, r) if mesh.group is not None else r
        dist.broadcast(buf[r], src, group=mesh.group)
    full = buf.permute(1, 0, 2, 3).reshape(nl, mesh.world * n, -1)
    out = []
    for x, part in zip(xs, torch.split(full, widths, -1)):
        shape = (*lead, mesh.world * n, *x.shape[dim + 1:])
        out.append(part.reshape(shape).to(x.dtype))
    return out

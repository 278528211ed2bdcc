"""The colored-phase ``solver="xla"`` branch of the per-env step.

Port of the XLA path of ``_physics_step_impl`` in
``evomotion_tpu/physics/engine.py`` (:1612-1629, :1658-1796, :1880-2027).
Its rows are the per-env step's own (:mod:`.perenv`: fat rows, the dense
member narrowphase, the warm starts, the step tail); only the two solves
differ. Where the ``"pallas"`` branch sweeps the rows one by one in Bullet's
order, this branch runs Gauss-Seidel over groups of rows that touch
disjoint dynamic bodies, one group after the other:

- the split-impulse push pass: ``n_iterations`` passes over the floor
  contact normals, one K-slot at a time (all pairs of a slot together),
  then ``n_iterations`` passes over the member contact normals, one slot of
  one color of ``model.dyn_pair_color`` at a time;
- the velocity iterations, ``n_iterations`` times: the joint rows phase by
  phase (``model.phase_table``), the floor normals slot by slot, the floor
  friction by slot and direction, then the member normals of every color,
  the first friction direction of every color, then the second; each
  friction row clamped to +-mu times its normal's impulse, read live.

The JAX code gathers and scatters through one-hot matrices (a TPU device);
here they are index gathers and ``index_add_``. Within one group a dynamic
body takes at most one term, and the static bodies' rows carry zero
velocity deltas, so the two round alike apart from the order of the
12-term dot products. Padding slots of the phase table are dropped.

Both solves take and return the fat rows' canonical order, with the call
signature of :class:`.perenv.FatSolver`, so the per-env step runs either.
The physics step runs this branch when ``model.solver == "xla"``, for one
world and for a batch alike (the JAX package has no vmap rule for it: a
vmapped call batches the per-env code). It launches no hand-written
kernel: a dozen small PyTorch ops per group, on the state's device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import engine as E
from .model import MAX_CONTACTS_PER_PAIR, PhysicsModel

# fat-row columns (perenv._pack_rows): J of both bodies, Minv J^T of both
# bodies, rhs, lo, hi, 1 / (J Minv J^T)
_J, _DV, _RHS, _LO, _HI, _IE = slice(0, 12), slice(12, 24), 24, 25, 26, 27


class _Group(NamedTuple):
    """Rows solved together: rows [n] (canonical ids), their bodies [n, 2]
    and, for friction rows, their normal rows and friction coefficients."""

    rows: np.ndarray
    bodies: np.ndarray
    parent: np.ndarray | None = None
    mu: np.ndarray | None = None


class _Step(NamedTuple):
    off: int  # first position in visit order
    n: int
    bodies: torch.Tensor  # [n, 2] int64
    flat: torch.Tensor  # [2n] int64
    parent_off: int  # visit position of the normals (friction), else -1
    mu: torch.Tensor | None  # [n, 1]


class PhaseSolver:
    """Colored Gauss-Seidel over fat rows ``[NR, 28, B]``: ``blocks`` is a
    list of (iterations, groups); each block runs its groups in order that
    many times, then the next block starts. Every row belongs to exactly one
    group. A call takes canonical rows, velocities [NB, 6, B] and initial
    impulses [NR, B] and returns (velocities, impulses) in canonical order."""

    def __init__(self, blocks: list[tuple[int, list[_Group]]], n_rows: int, device):
        dev = torch.device(device)
        order = np.concatenate(
            [np.zeros(0, np.int64)] + [g.rows for _, groups in blocks for g in groups]
        ).astype(np.int64)
        if sorted(order.tolist()) != list(range(n_rows)):
            raise ValueError("phase groups must cover every row exactly once")
        visit = np.empty(n_rows, np.int64)
        visit[order] = np.arange(n_rows)
        self.order = torch.as_tensor(order, device=dev)
        self.blocks = []
        for n_iters, groups in blocks:
            steps = []
            for g in groups:
                off = int(visit[g.rows[0]])
                n = len(g.rows)
                assert (visit[g.rows] == off + np.arange(n)).all()
                b = torch.as_tensor(np.asarray(g.bodies, np.int64).reshape(n, 2), device=dev)
                p_off, mu = -1, None
                if g.parent is not None:
                    p_off = int(visit[g.parent[0]])
                    assert (visit[g.parent] == p_off + np.arange(n)).all()
                    mu = torch.as_tensor(np.asarray(g.mu, np.float32)[:, None], device=dev)
                steps.append(_Step(off, n, b, b.reshape(-1), p_off, mu))
            self.blocks.append((n_iters, steps))

    @property
    def n_groups(self) -> int:
        """Dependent Gauss-Seidel steps per call."""
        return sum(n_iters * len(steps) for n_iters, steps in self.blocks)

    def __call__(self, rows, vel6, lam0):
        b = rows.shape[-1]
        rs = rows.index_select(0, self.order)
        j, dv = rs[:, _J], rs[:, _DV]
        rhs, lo, hi, ie = rs[:, _RHS], rs[:, _LO], rs[:, _HI], rs[:, _IE]
        lam = lam0.index_select(0, self.order)
        v = vel6.clone()
        for n_iters, steps in self.blocks:
            for _ in range(n_iters):
                for s in steps:
                    a, e = s.off, s.off + s.n
                    jv = torch.linalg.vecdot(j[a:e], v[s.bodies].reshape(s.n, 12, b), dim=1)
                    old = lam[a:e]
                    cand = torch.addcmul(old, rhs[a:e] - jv, ie[a:e])
                    if s.mu is None:
                        new = torch.clamp(cand, lo[a:e], hi[a:e])
                    else:
                        lim = s.mu * lam[s.parent_off:s.parent_off + s.n]
                        new = torch.clamp(cand, -lim, lim)
                    d = new - old
                    old.copy_(new)
                    v.index_add_(0, s.flat, (dv[a:e] * d[:, None]).reshape(2 * s.n, 6, b))
        out = torch.empty_like(lam)
        out[self.order] = lam
        return v, out


def _floor_pairs(model: PhysicsModel):
    """(dynamic body, static body, friction) of each floor pair."""
    pair = model.pair_body
    if not len(pair):
        z = np.zeros(0, np.int64)
        return z, z, np.zeros(0, np.float32)
    pairs = pair[model.inv_mass[pair[:, 1]] == 0.0]
    fric = np.clip(model.friction[pairs[:, 0]] * model.friction[pairs[:, 1]], 0, 10)
    return pairs[:, 0], pairs[:, 1], fric.astype(np.float32)


def _slot_groups(base, n_pair, k, a, b):
    """Rows base + pair * k + slot, one group per slot."""
    ids = np.arange(n_pair) * k
    return [_Group(base + ids + kk, np.stack([a, b], 1)) for kk in range(k)]


def _member_groups(model: PhysicsModel, base):
    """Member normal rows base + pair * kd + slot: one group per (color, slot)."""
    dp, kd = model.dyn_pair_body, model.member_manifold_k
    return [
        _Group(base + np.asarray(c, np.int64) * kd + kk, dp[np.asarray(c, np.int64)])
        for c in model.dyn_pair_color for kk in range(kd)
    ]


def push_solver(model: PhysicsModel, n_pair: int, n_dyn: int, device) -> PhaseSolver:
    """The push pass over the per-env step's push rows [floor NP*K | member
    NDC]: all floor iterations, then all member iterations
    (engine.py:1615-1629, :1750-1796)."""
    k = MAX_CONTACTS_PER_PAIR
    fa, fb, _ = _floor_pairs(model)
    blocks = []
    if n_pair:
        blocks.append((model.n_iterations, _slot_groups(0, n_pair, k, fa, fb)))
    if n_dyn:
        blocks.append((model.n_iterations, _member_groups(model, n_pair * k)))
    return PhaseSolver(blocks, n_pair * k + n_dyn, device)


def full_solver(model: PhysicsModel, n_pair: int, n_dyn: int, device) -> PhaseSolver:
    """The velocity iterations over the per-env step's rows in canonical
    order [joints | floor normals | member normals | floor friction (pair,
    slot, dir) | member friction (point, dir)] (engine.py:1918-1978)."""
    k = MAX_CONTACTS_PER_PAIR
    nrj = model.n_rows
    ja, jb = E._static_row_bodies(model)
    groups = []
    for phase in model.phase_table:
        rows = phase[phase < nrj].astype(np.int64)  # padding slots: rid == n_rows
        if len(rows):
            groups.append(_Group(rows, np.stack([ja[rows], jb[rows]], 1)))
    fa, fb, fric = _floor_pairs(model)
    base_n = nrj
    base_mn = nrj + n_pair * k
    base_f = base_mn + n_dyn
    base_mf = base_f + n_pair * k * 2
    normals = _slot_groups(base_n, n_pair, k, fa, fb) if n_pair else []
    groups += normals
    for kk, g in enumerate(normals):
        for ti in range(2):
            groups.append(_Group(base_f + (g.rows - base_n) * 2 + ti, g.bodies, g.rows, fric))
    if n_dyn:
        members = _member_groups(model, base_mn)
        groups += members
        dp = model.dyn_pair_body
        kd = model.member_manifold_k
        fric_d = np.clip(model.friction[dp[:, 0]] * model.friction[dp[:, 1]], 0, 10)
        for ti in range(2):
            for g in members:
                pts = g.rows - base_mn
                groups.append(_Group(base_mf + pts * 2 + ti, g.bodies, g.rows,
                                     fric_d[pts // kd].astype(np.float32)))
    n_full = nrj + n_pair * k * 3 + n_dyn * 3
    return PhaseSolver([(model.n_iterations, groups)], n_full, device)


def phase_solvers(model: PhysicsModel, st, device):
    """(push, full) solves of the xla branch for :func:`.perenv.step_perenv`;
    push is None when the model has no contact pairs."""
    push = push_solver(model, st.n_pair, st.n_dyn, device) if st.n_pair or st.n_dyn else None
    return push, full_solver(model, st.n_pair, st.n_dyn, device)

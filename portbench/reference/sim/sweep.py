"""Fused sequential-impulse sweep over slim env-last rows, plain version.

Frozen from the port's ``kernels/sweep.py`` (kernel #1's plain version):
``n_iters`` passes over the constraint rows, visited in the order the caller
laid them out, envs independent. Each visit is a step on ``[B]`` vectors;
no kernel, on any device.

Row layout (``ROW_J`` / ``ROW_S``): J columns ``[NR_pad, 12, B]`` (bf16 or
f32: a_lin, a_ang, b_lin, b_ang) and f32 scalars ``[NR_pad, 4, B]``
(rhs, lo, hi, rhs_push). Minv*J^T and 1/(J Minv J^T) are recomputed per row
from the world inverse inertia ``iinv9 [NB*9, B]`` and static inverse masses.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

ROW_J = 12
ROW_S = 4
_SRHS, _SLO, _SHI, _SRHSP = 0, 1, 2, 3  # indices into the scalar rows

# row bound kinds (static per row)
KIND_JOINT = 0  # bounds streamed per env (limit/motor rows are state-dependent)
KIND_NORMAL = 1  # [0, +inf)
KIND_FRICTION = 2  # +-mu * lam[parent]



def check_groups(groups, idx6_a, idx6_b, parent, skip_b, n_rows: int, chunk: int):
    """Raise ValueError unless ``groups`` (``((start, size), ...)``) keep
    the invariant under which a group's load-then-store phases compute what
    visiting its rows one at a time computes:

    - the groups tile ``[0, n_rows)`` in order;
    - no group crosses a boundary of ``chunk`` rows;
    - within a group, the bodies the rows write (body A, and body B unless
      ``skip_b``) are pairwise disjoint between rows;
    - every friction row's parent lies in an earlier group."""
    idx6_a, idx6_b = np.asarray(idx6_a)[:n_rows], np.asarray(idx6_b)[:n_rows]
    skip_b, parent = np.asarray(skip_b, bool)[:n_rows], np.asarray(parent)[:n_rows]
    group_of = np.empty(n_rows, np.int64)
    end = 0
    for g, (start, size) in enumerate(groups):
        if start != end or size < 1 or start + size > n_rows:
            raise ValueError(f"groups must tile [0, {n_rows}) in order: group {g} is "
                             f"({start}, {size}) after row {end}")
        if start // chunk != (start + size - 1) // chunk:
            raise ValueError(f"group {g} ({start}, {size}) crosses a {chunk}-row chunk")
        group_of[start:start + size] = g
        end = start + size
        bodies = set()
        for r in range(start, start + size):
            mine = {int(idx6_a[r]) // 6} | (set() if skip_b[r] else {int(idx6_b[r]) // 6})
            if bodies & mine:
                raise ValueError(f"group {g} ({start}, {size}): row {r} shares body "
                                 f"{sorted(bodies & mine)} with an earlier row of the group")
            bodies |= mine
    if end != n_rows:
        raise ValueError(f"groups must tile [0, {n_rows}) in order: they end at {end}")
    fr = np.nonzero(parent >= 0)[0]
    late = fr[group_of[parent[fr]] >= group_of[fr]]
    if len(late):
        raise ValueError(f"friction row {int(late[0])}: its parent {int(parent[late[0]])} "
                         "is not in an earlier group")


class SweepMeta(NamedTuple):
    """Static per-row sweep metadata in the forms both versions take."""

    rows: tuple  # per-row Python tuples of the same fields (plain version)
    n_push: int  # push-impulse slots (contact normal rows), at least 1
    groups: tuple | None = None  # checked ((start, size), ...); None: one row at a time


def row_table(idx6_a, idx6_b, parent, kind, skip_b, n_rows: int) -> np.ndarray:
    """[n_rows, 6] int32 per-row table ia6, ib6, kind, parent, skip_b,
    push_slot; a contact normal row's push slot counts the normal rows
    before it (the fused split-impulse pass's compact accumulator)."""
    kind = np.asarray(kind[:n_rows], np.int64)
    normal = kind == KIND_NORMAL
    push_slot = np.where(normal, np.cumsum(normal) - 1, -1)
    return np.stack(
        [np.asarray(idx6_a[:n_rows], np.int64), np.asarray(idx6_b[:n_rows], np.int64), kind,
         np.asarray(parent[:n_rows]), np.asarray(skip_b[:n_rows]).astype(np.int64), push_slot],
        1,
    ).astype(np.int32).reshape(n_rows, 6)


def checked_groups(groups, chunk, idx6_a, idx6_b, parent, skip_b, n_rows: int):
    """``groups`` as a tuple of int pairs once :func:`check_groups` has
    passed them against ``chunk``, the chunk they were built for; None
    stays None."""
    if groups is None:
        return None
    if chunk is None:
        raise ValueError("groups need the chunk they were built for")
    groups = tuple((int(s), int(z)) for s, z in groups)
    check_groups(groups, idx6_a, idx6_b, parent, skip_b, n_rows, chunk)
    return groups


def make_sweep_meta(inv_mass, idx6_a, idx6_b, parent, mu, kind, skip_b,
                    n_rows: int, device, groups=None, chunk=None) -> SweepMeta:
    """Per-row tables for the first ``n_rows`` rows, on ``device`` once per
    model. ``groups`` (the scheduled order's) are checked here, once, by
    :func:`check_groups` against ``chunk``, the chunk they were built for."""
    groups = checked_groups(groups, chunk, idx6_a, idx6_b, parent, skip_b, n_rows)
    inv_mass = np.asarray(inv_mass, np.float32)
    mi = row_table(idx6_a, idx6_b, parent, kind, skip_b, n_rows)
    idx6_a, idx6_b = mi[:, 0].astype(np.int64), mi[:, 1].astype(np.int64)
    normal = mi[:, 2] == KIND_NORMAL
    mf = np.stack(
        [np.asarray(mu[:n_rows], np.float32), inv_mass[idx6_a // 6],
         inv_mass[idx6_b // 6]], 1
    ).astype(np.float32).reshape(n_rows, 3)
    rows = tuple(
        (int(a), int(b), int(k), int(p), bool(s), int(ps), float(m), float(ma), float(mb))
        for (a, b, k, p, s, ps), (m, ma, mb) in zip(mi.tolist(), mf.tolist())
    )
    return SweepMeta(
        rows=rows,
        n_push=max(int(normal.sum()), 1),
        groups=groups,
    )


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


def _dv(im, ii, j):
    """[im * j_lin, Iinv * j_ang] for one body: ii [9, B], j [6, B] -> [6, B]."""
    ang = (ii.view(3, 3, -1) * j[None, 3:6]).sum(1)
    return torch.cat([im * j[0:3], ang], 0)


def clamp_impulse(kind, cand, lo, hi, mu, lam, parent, zero):
    """A row's new impulse from its candidate: the joint row's streamed
    bounds, ``[0, inf)`` for a contact normal, ``+-mu * lam[parent]`` for a
    friction row (the parent's impulse as it stands)."""
    if kind == KIND_JOINT:
        return torch.minimum(torch.maximum(cand, lo), hi)
    if kind == KIND_NORMAL:
        return torch.maximum(cand, zero)
    lim = mu * lam[parent]
    return torch.minimum(torch.maximum(cand, -lim), lim)


def visit_row(v, lam, at, j, dva, dvb, ia6, ib6, rhs, ie, clamp):
    """One row visit of a sequential-impulse pass, on ``[B]`` vectors:
    ``new = clamp(lam[at] + (rhs - J.v) * ie)`` and both bodies' new
    velocities from the values in ``v`` [NB*6, B] (body B left out where
    ``ib6`` is None). Returns the stores, ``(tensor, index, value)``, for the
    caller to make."""
    a6 = slice(ia6, ia6 + 6)
    va = v[a6]
    jv = (j[0:6] * va).sum(0)
    if ib6 is not None:
        b6 = slice(ib6, ib6 + 6)
        vb = v[b6]
        jv = jv + (j[6:12] * vb).sum(0)
    old = lam[at]
    new = clamp(old + (rhs - jv) * ie)
    d = new - old
    stores = [(lam, at, new), (v, a6, va + dva * d)]
    if ib6 is not None:
        stores.append((v, b6, vb + dvb * d))
    return stores


def run_groups(groups, n_rows: int, visit):
    """One pass of a plain sweep: per group (one row each where ``groups``
    is None), ``visit(r)`` gives each row's stores from the values before
    the group (load phase), and they are made after it (store phase), as
    the TPU kernels' groups mode does."""
    for start, size in groups if groups is not None else ((r, 1) for r in range(n_rows)):
        stores = [s for r in range(start, start + size) for s in visit(r)]
        for dst, at, val in stores:
            dst[at] = val


def sweep_plain(row_j, row_s, vel6, lam0, iinv9, meta: SweepMeta, n_iters: int):
    """Loop-over-rows version of the sweep, in ``meta.groups`` (see
    :func:`run_groups`); returns (vel6', lam', push_vel6)."""
    v = vel6.clone()
    lam = lam0.clone()
    pv = torch.zeros_like(vel6)
    plam = torch.zeros((meta.n_push, vel6.shape[1]), dtype=vel6.dtype, device=vel6.device)
    zero = torch.zeros((), dtype=vel6.dtype, device=vel6.device)

    def visit(r):
        ia6, ib6, kind, parent, skip_b, pslot, mu, im_a, im_b = meta.rows[r]
        rd = row_j[r].float()  # [12, B]
        rs = row_s[r]  # [4, B]
        ia9 = ia6 // 6 * 9
        dva = _dv(im_a, iinv9[ia9:ia9 + 9], rd[0:6])
        eff = (rd[0:6] * dva).sum(0)
        dvb = ib = None
        if not skip_b:
            ib, ib9 = ib6, ib6 // 6 * 9
            dvb = _dv(im_b, iinv9[ib9:ib9 + 9], rd[6:12])
            eff = eff + (rd[6:12] * dvb).sum(0)
        ie = torch.where(eff > 1e-12, 1.0 / torch.clamp(eff, min=1e-12), zero)
        stores = visit_row(
            v, lam, r, rd, dva, dvb, ia6, ib, rs[_SRHS], ie,
            lambda c: clamp_impulse(kind, c, rs[_SLO], rs[_SHI], mu, lam, parent, zero))
        if pslot >= 0:  # the split-impulse pass: its own accumulators
            stores += visit_row(pv, plam, pslot, rd, dva, dvb, ia6, ib, rs[_SRHSP], ie,
                                lambda c: torch.maximum(c, zero))
        return stores

    for _ in range(n_iters):
        run_groups(meta.groups, len(meta.rows), visit)
    return v, lam, pv


def solver_sweep_envlast_slim(row_j, row_s, vel6, lam0, iinv9, meta: SweepMeta,
                              n_iters: int):
    """The fused sweep's plain version on any device; returns
    (vel6', lam', push_vel6), all f32 ``[*, B]``. Rows ``len(meta.rows)``
    and beyond (padding) are not visited and keep their ``lam0``."""
    return sweep_plain(row_j, row_s, vel6, lam0, iinv9, meta, n_iters)

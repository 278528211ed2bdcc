"""Fused sequential-impulse sweep over slim env-last rows: CUDA kernel + plain version.

Port of ``solver_sweep_envlast_slim`` (evomotion_tpu/physics/solver_pallas.py:508,
kernel ``_sweep_kernel_envlast_slim``). ``n_iters`` passes over the constraint
rows, visited in the order the caller laid them out, envs independent; see
``csrc/sweep_envlast_slim.cu`` for the per-row arithmetic.

Groups (the ``scheduled`` row order): :func:`make_sweep_meta` takes the
TPU kernel's ``groups``, ``((start, size), ...)`` runs of rows whose
velocity loads all happen before any of their stores, and checks the
invariant that makes that the same as visiting the rows one at a time (see
:func:`check_groups`), against the chunk the groups were built for. The
plain version does the group semantics literally, load phase then store
phase (:func:`run_groups`); the CUDA kernel visits the rows one at a time,
which the check makes equal.

:func:`solver_sweep_envlast_slim` dispatches on where its tensors lie:

- CUDA tensors: launches the hand-written kernel (built by ``nvcc`` into a
  shared library with a plain C interface at first use, loaded with ctypes)
  with the launch :func:`plan` of the shapes, or raises. There is no
  fallback.
- CPU tensors: runs :func:`sweep_plain`, a loop over rows in which each step
  works on ``[B]`` vectors. It repeats the kernel's arithmetic and is the
  reference the kernel is held against on the card.

Row layout (``ROW_J`` / ``ROW_S``): J columns ``[NR_pad, 12, B]`` (bf16 or
f32: a_lin, a_ang, b_lin, b_ang) and f32 scalars ``[NR_pad, 4, B]``
(rhs, lo, hi, rhs_push). Minv*J^T and 1/(J Minv J^T) are recomputed per row
from the world inverse inertia ``iinv9 [NB*9, B]`` and static inverse masses.

Launch plan (:func:`plan`, see :mod:`.ring`): the kernel keeps each env's
velocities and push velocities (one spare body each), impulses of the
visited rows, push impulses and inverse-inertia table in shared memory
(``2 * (nb6 + 6) + n_rows + n_push + 9 * nb`` floats), and streams the rows
through a ring of 8-row stages (J box, scalar box, the rows' block of
``SweepMeta.table``, and 1/eff, which a third warp of the block adds). The
spider at B=2048 gets 16 envs per block (128 blocks), 3 stages with bf16 J,
2 with f32 J.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from . import ring
from .build import NvccLibrary

ROW_J = 12
ROW_S = 4
_SRHS, _SLO, _SHI, _SRHSP = 0, 1, 2, 3  # indices into the scalar rows

# row bound kinds (static per row)
KIND_JOINT = 0  # bounds streamed per env (limit/motor rows are state-dependent)
KIND_NORMAL = 1  # [0, +inf)
KIND_FRICTION = 2  # +-mu * lam[parent]

_META_WORDS = 12  # per-row words of SweepMeta.table
_THREADS = 96  # the kernel's block: consumer, producer and 1/eff warps


def plan(nb6: int, nr_pad: int, n_rows: int, n_push: int, j_bytes: int,
         smem_optin: int) -> ring.Plan:
    """The kernel's launch plan for these shapes (``j_bytes`` 2 for bf16 J,
    4 for f32) within ``smem_optin`` bytes of shared memory per block;
    raises ValueError when none fits."""
    if j_bytes not in (2, 4) or nb6 % 6 or not 0 <= n_rows <= nr_pad or n_push < 1:
        raise ValueError(f"sweep plan: bad shapes nb6={nb6} nr_pad={nr_pad} "
                         f"n_rows={n_rows} n_push={n_push} j_bytes={j_bytes}")

    def stage(envs):  # J box, scalar box, metadata, 1/eff box
        return (ring.align(ring.STAGE_ROWS * ROW_J * envs * j_bytes)
                + ring.align(ring.STAGE_ROWS * ROW_S * envs * 4)
                + ring.align(ring.STAGE_ROWS * _META_WORDS * 4)
                + ring.align(ring.STAGE_ROWS * envs * 4))

    return ring.plan(stage, 2 * (nb6 + 6) + n_rows + n_push + 9 * (nb6 // 6), (j_bytes, 4),
                     _THREADS, smem_optin, "sweep kernel")


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

    # [ceil8(NR), 12] int32, the kernel's (ring.stage_table): bodies, kind,
    # bounding row, push slot, and the bits of f32 mu, inv_mass_a, inv_mass_b
    table: torch.Tensor
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
        table=torch.as_tensor(ring.stage_table(mi, mf, _META_WORDS), device=device),
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


# ---------------------------------------------------------------------------
# CUDA kernel: build, load, launch
# ---------------------------------------------------------------------------


class SweepKernel(NvccLibrary):
    """The nvcc-built sweep library and its launch count.

    ``launches`` is a plain integer that :meth:`launch` raises by one per
    kernel launch and nothing else touches, so a run can show that its main
    path went through the kernel. ``last`` holds the plan and copy path of
    the latest launch."""

    def __init__(self):
        super().__init__("sweep_envlast_slim.cu")
        self.launches = 0
        self.last = None
        self._lib = None

    def lib(self):
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            p = ctypes.c_void_p
            i = ctypes.c_int
            lib.sweep_envlast_slim_launch.argtypes = [
                p, i, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, p,
            ]
            lib.sweep_envlast_slim_launch.restype = ctypes.c_int
            lib.sweep_envlast_slim_smem_bytes.argtypes = [i, i, i, i, i, i]
            lib.sweep_envlast_slim_smem_bytes.restype = ctypes.c_longlong
            lib.sweep_envlast_slim_blocks_per_sm.argtypes = [i, i, i]
            lib.sweep_envlast_slim_blocks_per_sm.restype = ctypes.c_int
            lib.sweep_envlast_slim_max_smem_per_block.argtypes = []
            lib.sweep_envlast_slim_max_smem_per_block.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def plan_for(self, row_j, vel6, meta: SweepMeta) -> ring.Plan:
        """The launch plan of these inputs on the current card."""
        return plan(vel6.shape[0], row_j.shape[0], len(meta.rows), meta.n_push,
                    row_j.element_size(), self.lib().sweep_envlast_slim_max_smem_per_block())

    def blocks_per_sm(self, pl: ring.Plan) -> int:
        """Resident blocks per SM of the plan's kernel instance on the
        current card, as the CUDA runtime reckons them."""
        n = self.lib().sweep_envlast_slim_blocks_per_sm(int(pl.elt_bytes[0] == 2), pl.envs,
                                                        pl.smem_bytes)
        if n < 0:
            raise RuntimeError(f"sweep kernel occupancy query failed: cudaError {-n} ({pl})")
        return n

    def launch(self, row_j, row_s, vel6, lam0, iinv9, meta: SweepMeta, n_iters: int):
        nr_pad, _, b = row_j.shape
        nb6 = vel6.shape[0]
        n_rows = len(meta.rows)
        lib = self.lib()
        pl = self.plan_for(row_j, vel6, meta)
        copy = ("plain" if any(t.data_ptr() % 16 for t in (row_j, row_s, meta.table))
                else pl.copy(b))
        vel_out = torch.empty_like(vel6)
        lam_out = torch.empty_like(lam0)
        push_out = torch.empty_like(vel6)
        err = lib.sweep_envlast_slim_launch(
            row_j.data_ptr(), int(row_j.dtype == torch.bfloat16), row_s.data_ptr(),
            vel6.data_ptr(), lam0.data_ptr(), iinv9.data_ptr(), meta.table.data_ptr(),
            vel_out.data_ptr(), lam_out.data_ptr(), push_out.data_ptr(),
            b, nb6, nr_pad, n_rows, n_iters, meta.n_push,
            pl.envs, pl.stages, pl.smem_bytes, int(copy == "tma"),
            torch.cuda.current_stream(vel6.device).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"sweep kernel launch failed: cudaError {err} ({pl}, {copy})")
        self.launches += 1
        self.last = (pl, copy)
        return vel_out, lam_out, push_out


KERNEL = SweepKernel()


def _check(row_j, row_s, vel6, lam0, iinv9, meta: SweepMeta):
    if row_j.dim() != 3 or row_j.shape[1] != ROW_J:
        raise ValueError(f"row_j must be [NR_pad, {ROW_J}, B], got {tuple(row_j.shape)}")
    nr_pad, _, b = row_j.shape
    nb6 = vel6.shape[0]
    want = {
        "row_s": (row_s, (nr_pad, ROW_S, b), (torch.float32,)),
        "vel6": (vel6, (nb6, b), (torch.float32,)),
        "lam0": (lam0, (nr_pad, b), (torch.float32,)),
        "iinv9": (iinv9, (nb6 // 6 * 9, b), (torch.float32,)),
        "row_j": (row_j, (nr_pad, ROW_J, b), (torch.float32, torch.bfloat16)),
        "table": (meta.table, (-(-len(meta.rows) // ring.STAGE_ROWS) * ring.STAGE_ROWS,
                               _META_WORDS), (torch.int32,)),
    }
    dev = row_j.device
    for name, (t, shape, dtypes) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
        if t.dtype not in dtypes:
            raise TypeError(f"{name}: dtype {t.dtype}, expected one of {dtypes}")
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, row_j on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if nb6 % 6 or len(meta.rows) > nr_pad:
        raise ValueError(f"bad sizes: nb6={nb6}, rows={len(meta.rows)} > {nr_pad}")


def solver_sweep_envlast_slim(row_j, row_s, vel6, lam0, iinv9, meta: SweepMeta,
                              n_iters: int):
    """The fused sweep; returns (vel6', lam', push_vel6), all f32 ``[*, B]``.

    Rows ``len(meta.rows)`` and beyond (padding) are not visited and
    keep their ``lam0``. Rows are visited in their order in the arrays, in
    ``meta.groups`` where the meta has them (checked when it was made). On
    CUDA tensors this launches the kernel or raises; on CPU tensors it runs
    the plain version."""
    _check(row_j, row_s, vel6, lam0, iinv9, meta)
    if row_j.device.type == "cuda":
        return KERNEL.launch(row_j, row_s, vel6, lam0, iinv9, meta, n_iters)
    if row_j.device.type == "cpu":
        return sweep_plain(row_j, row_s, vel6, lam0, iinv9, meta, n_iters)
    raise ValueError(f"sweep: unsupported device {row_j.device}")

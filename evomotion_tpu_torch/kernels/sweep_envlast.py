"""Fused sweep over fat env-last rows with the split-impulse pass: CUDA kernel + plain version.

Port of ``solver_sweep_envlast`` (evomotion_tpu/physics/solver_pallas.py:300,
kernel ``_sweep_kernel_envlast``): the fat-row sweep of ``solver_sweep`` in
the env-last layout, with the push pass fused in. ``n_iters`` passes over the
first ``n_rows`` rows, visited strictly in order within each env, envs
independent; see ``csrc/solver_sweep_envlast.cu`` for the per-row
arithmetic. The JAX wrapper takes ``groups`` but its kernel ignores them
(it walks every row one at a time), so this port takes none.

Row layout (``ROW_FP`` = 29 f32 per row, computed by the caller), env LAST:
``rows [NR_pad, 29, B]``: J (12: a_lin, a_ang, b_lin, b_ang), dv_a (6),
dv_b (6), rhs, lo, hi, inv_eff, rhs_push; ``vel6 [NB*6, B]``,
``lam0 [NR_pad, B]``. Returns (vel6', lam', push_vel6).

:func:`solver_sweep_envlast` dispatches on where its tensors lie:

- CUDA tensors: launches the hand-written kernel (built by ``nvcc`` into a
  shared library with a plain C interface at first use, loaded with ctypes)
  with the launch :func:`plan` of the shapes, or raises. There is no
  fallback.
- CPU tensors: runs :func:`sweep_envlast_plain`, a loop over rows in which
  each step works on ``[B]`` vectors. It repeats the kernel's arithmetic and
  is the reference the kernel is held against on the card.

Launch plan (:func:`plan`, see :mod:`.ring`): the kernel keeps each env's
velocities and push velocities (one spare body each), impulses of the
visited rows and push impulses in shared memory (``2 * (nb6 + 6) + n_rows +
n_push`` floats) and streams the rows, with their block of
``EnvlastMeta.table``, through a ring of 8-row stages. The spider's full
sweep at B=2048 gets 16 envs per block (128 blocks) and 2 stages;
``prof_kernel``'s 2,048-row contact case gets 8 envs per block.

Nothing in the physics step calls it: the profilers of
:mod:`evomotion_tpu_torch.tools` do, as the JAX package's ``tools/`` do.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from . import ring
from .build import NvccLibrary
from .sweep import KIND_NORMAL, clamp_impulse, row_table, run_groups, visit_row

ROW_FP = 29
_J, _DVA, _DVB, _RHS, _LO, _HI, _IEF, _RHSP = 0, 12, 18, 24, 25, 26, 27, 28
_META_WORDS = 8  # per-row words of EnvlastMeta.table
_THREADS = 64  # the kernel's block: consumer and producer warps


def plan(nb6: int, nr_pad: int, n_rows: int, n_push: int, smem_optin: int) -> ring.Plan:
    """The kernel's launch plan for these shapes within ``smem_optin`` bytes
    of shared memory per block; raises ValueError when none fits."""
    if nb6 % 6 or not 0 <= n_rows <= nr_pad or n_push < 1:
        raise ValueError(f"envlast sweep plan: bad shapes nb6={nb6} nr_pad={nr_pad} "
                         f"n_rows={n_rows} n_push={n_push}")

    def stage(envs):
        return (ring.align(ring.STAGE_ROWS * ROW_FP * envs * 4)
                + ring.align(ring.STAGE_ROWS * _META_WORDS * 4))

    return ring.plan(stage, 2 * (nb6 + 6) + n_rows + n_push, (4,), _THREADS, smem_optin,
                     "envlast sweep kernel")


class EnvlastMeta(NamedTuple):
    """Static per-row sweep metadata in the forms both versions take."""

    # [ceil8(NR), 8] int32, the kernel's (ring.stage_table): bodies, kind,
    # bounding row, push slot, and the bits of f32 mu
    table: torch.Tensor
    rows: tuple  # per-row Python tuples of the same fields and mu (plain version)
    n_push: int  # push-impulse slots (contact normal rows), at least 1


def make_envlast_meta(idx6_a, idx6_b, parent, mu, kind, skip_b, n_rows: int,
                      device) -> EnvlastMeta:
    """Per-row tables for the first ``n_rows`` rows, on ``device`` once per row set."""
    mi = row_table(idx6_a, idx6_b, parent, kind, skip_b, n_rows)
    mu = np.asarray(mu[:n_rows], np.float32).reshape(n_rows)
    rows = tuple(
        (a, b, k, p, bool(s), ps, m) for (a, b, k, p, s, ps), m in zip(mi.tolist(), mu.tolist())
    )
    return EnvlastMeta(torch.as_tensor(ring.stage_table(mi, mu[:, None], _META_WORDS),
                                       device=device),
                       rows, max(int((mi[:, 2] == KIND_NORMAL).sum()), 1))


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


def sweep_envlast_plain(rows, vel6, lam0, meta: EnvlastMeta, n_iters: int):
    """Loop-over-rows version of the sweep, one row at a time; returns
    (vel6', lam', push_vel6)."""
    v = vel6.clone()
    lam = lam0.clone()
    pv = torch.zeros_like(vel6)
    plam = torch.zeros((meta.n_push, vel6.shape[1]), dtype=vel6.dtype, device=vel6.device)
    zero = torch.zeros((), dtype=vel6.dtype, device=vel6.device)

    def visit(r):
        ia6, ib6, kind, parent, skip_b, pslot, mu = meta.rows[r]
        x = rows[r]  # [29, B]
        j, dva, dvb = x[_J:_J + 12], x[_DVA:_DVA + 6], x[_DVB:_DVB + 6]
        ib = None if skip_b else ib6
        stores = visit_row(
            v, lam, r, j, dva, dvb, ia6, ib, x[_RHS], x[_IEF],
            lambda c: clamp_impulse(kind, c, x[_LO], x[_HI], mu, lam, parent, zero))
        if pslot >= 0:  # the split-impulse pass: its own accumulators
            stores += visit_row(pv, plam, pslot, j, dva, dvb, ia6, ib, x[_RHSP], x[_IEF],
                                lambda c: torch.maximum(c, zero))
        return stores

    for _ in range(n_iters):
        run_groups(None, len(meta.rows), visit)
    return v, lam, pv


# ---------------------------------------------------------------------------
# CUDA kernel: build, load, launch
# ---------------------------------------------------------------------------


class EnvlastSweepKernel(NvccLibrary):
    """The nvcc-built env-last fat-row sweep library and its launch count.

    ``launches`` is a plain integer that :meth:`launch` raises by one per
    kernel launch and nothing else touches, so a run can show that its path
    went through the kernel. ``last`` holds the plan and copy path of the
    latest launch."""

    def __init__(self):
        super().__init__("solver_sweep_envlast.cu")
        self.launches = 0
        self.last = None
        self._lib = None

    def lib(self):
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            p = ctypes.c_void_p
            i = ctypes.c_int
            lib.solver_sweep_envlast_launch.argtypes = [
                p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, p,
            ]
            lib.solver_sweep_envlast_launch.restype = ctypes.c_int
            lib.solver_sweep_envlast_smem_bytes.argtypes = [i, i, i, i, i]
            lib.solver_sweep_envlast_smem_bytes.restype = ctypes.c_longlong
            lib.solver_sweep_envlast_blocks_per_sm.argtypes = [i, i]
            lib.solver_sweep_envlast_blocks_per_sm.restype = ctypes.c_int
            lib.solver_sweep_envlast_max_smem_per_block.argtypes = []
            lib.solver_sweep_envlast_max_smem_per_block.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def plan_for(self, rows, vel6, meta: EnvlastMeta) -> ring.Plan:
        """The launch plan of these inputs on the current card."""
        return plan(vel6.shape[0], rows.shape[0], len(meta.rows), meta.n_push,
                    self.lib().solver_sweep_envlast_max_smem_per_block())

    def blocks_per_sm(self, pl: ring.Plan) -> int:
        """Resident blocks per SM of the plan's kernel instance on the
        current card, as the CUDA runtime reckons them."""
        n = self.lib().solver_sweep_envlast_blocks_per_sm(pl.envs, pl.smem_bytes)
        if n < 0:
            raise RuntimeError(f"envlast sweep kernel occupancy query failed: cudaError {-n} "
                               f"({pl})")
        return n

    def launch(self, rows, vel6, lam0, meta: EnvlastMeta, n_iters: int):
        nr_pad, _, b = rows.shape
        nb6 = vel6.shape[0]
        lib = self.lib()
        pl = self.plan_for(rows, vel6, meta)
        copy = "plain" if rows.data_ptr() % 16 or meta.table.data_ptr() % 16 else pl.copy(b)
        vel_out = torch.empty_like(vel6)
        lam_out = torch.empty_like(lam0)
        push_out = torch.empty_like(vel6)
        err = lib.solver_sweep_envlast_launch(
            rows.data_ptr(), vel6.data_ptr(), lam0.data_ptr(), meta.table.data_ptr(),
            vel_out.data_ptr(), lam_out.data_ptr(), push_out.data_ptr(),
            b, nb6, nr_pad, len(meta.rows), n_iters, meta.n_push,
            pl.envs, pl.stages, pl.smem_bytes, int(copy == "tma"),
            torch.cuda.current_stream(vel6.device).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"envlast sweep kernel launch failed: cudaError {err} "
                               f"({pl}, {copy})")
        self.launches += 1
        self.last = (pl, copy)
        return vel_out, lam_out, push_out


KERNEL = EnvlastSweepKernel()


def _check(rows, vel6, lam0, meta: EnvlastMeta):
    if rows.dim() != 3 or rows.shape[1] != ROW_FP:
        raise ValueError(f"rows must be [NR_pad, {ROW_FP}, B], got {tuple(rows.shape)}")
    nr_pad, _, b = rows.shape
    if vel6.dim() != 2 or vel6.shape[0] % 6:
        raise ValueError(f"vel6 must be [NB*6, B], got {tuple(vel6.shape)}")
    n_rows = len(meta.rows)
    want = {
        "rows": (rows, (nr_pad, ROW_FP, b), torch.float32),
        "vel6": (vel6, (vel6.shape[0], b), torch.float32),
        "lam0": (lam0, (nr_pad, b), torch.float32),
        "table": (meta.table, (-(-n_rows // ring.STAGE_ROWS) * ring.STAGE_ROWS, _META_WORDS),
                  torch.int32),
    }
    dev = rows.device
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, rows on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if n_rows > nr_pad:
        raise ValueError(f"meta has {n_rows} rows, rows {nr_pad}")


def solver_sweep_envlast(rows, vel6, lam0, meta: EnvlastMeta, n_iters: int):
    """The fused sweep; returns (vel6', lam', push_vel6), all f32 ``[*, B]``.

    Rows ``len(meta.rows)`` and beyond (padding) are not visited and
    keep their ``lam0``. On CUDA tensors this launches the kernel or raises;
    on CPU tensors it runs the plain version."""
    _check(rows, vel6, lam0, meta)
    if rows.device.type == "cuda":
        return KERNEL.launch(rows, vel6, lam0, meta, n_iters)
    if rows.device.type == "cpu":
        return sweep_envlast_plain(rows, vel6, lam0, meta, n_iters)
    raise ValueError(f"envlast sweep: unsupported device {rows.device}")

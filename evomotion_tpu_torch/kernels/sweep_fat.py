"""Sequential-impulse sweep over fat batch-first rows: CUDA kernel + plain version.

Port of ``solver_sweep`` (evomotion_tpu/physics/solver_pallas.py:191, kernel
``_sweep_kernel``), the sweep of the per-env physics step. ``n_iters``
passes over the constraint rows, visited in the order the caller laid them
out, envs independent; see ``csrc/solver_sweep.cu`` for the per-row
arithmetic. The ``scheduled`` row order's ``groups`` go into the meta
(:func:`make_fat_meta`), checked as for the slim sweep
(:func:`.sweep.check_groups`): the plain version runs each group's load
phase before its store phase, the CUDA kernel visits the rows one at a time,
and the check makes the two equal.

Row layout (``ROW_F`` = 28 f32 per row, computed by the caller): J (12:
a_lin, a_ang, b_lin, b_ang), dv_a = Minv_a J_a^T (6), dv_b (6), rhs, lo, hi,
inv_eff. Arrays are batch FIRST, as the JAX wrapper takes them:
``row_data [B, NR, 28]``, ``vel6 [B, NB, 6]``, ``lam0 [B, NR]``.

:func:`solver_sweep` dispatches on where its tensors lie:

- CUDA tensors: launches the hand-written kernel (built by ``nvcc`` into a
  shared library with a plain C interface at first use, loaded with ctypes)
  with the launch :func:`plan` of the shapes, or raises. There is no
  fallback.
- CPU tensors: runs :func:`sweep_fat_plain`, a loop over rows in which each
  step works on ``[B]`` vectors. It repeats the kernel's arithmetic and is
  the reference the kernel is held against on the card.

Launch plan (:func:`plan`; it replaces the old kernel's one thread per env,
``threads = min(32, B, ...)``): one block of :data:`THREADS` threads per env,
a consumer warp whose lane 0 runs the env's chain of row visits and a
producer warp. The block keeps the env's velocities (8-float slots, one
spare body) and impulses in shared memory for the whole call and streams
the rows through a ring of ``stages`` stages, at most :data:`MAX_STAGES`;
a stage holds an 8-row chunk and the row after it, with their
``FatMeta.table`` entries and one more. So a launch takes

    2 * ALIGN + stages * STAGE_BYTES + 4 * (8 * (nb + 1) + nr)

bytes, which must fit the card's opt-in. The plan takes the most stages
that fit and raises ValueError when two do not; the kernel recomputes the
sum and refuses a plan whose bytes differ. The spider's sweeps (42 bodies;
1,896 or 548 rows) take 8 stages in 20,480 or 15,088 bytes.

The table also carries, per row, :func:`visit_flags`: how the kernel hands
a row's state over to the next row it visits (velocities in registers,
which stores it can leave out). ``FatMeta.rare`` marks row sets with
hand-overs that take the kernel's slow path (none of the spider's).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from . import ring
from .build import NvccLibrary
from .sweep import (KIND_FRICTION, KIND_JOINT, checked_groups, clamp_impulse, run_groups,
                     visit_row)

ROW_F = 28
_J, _DVA, _DVB, _RHS, _LO, _HI, _IEF = 0, 12, 18, 24, 25, 26, 27
_META_WORDS = 8  # per-row words of FatMeta.table
_SLOT = 8  # floats per body in the kernel's shared memory
THREADS = 64  # the kernel's block: consumer and producer warps
MAX_STAGES = 8  # the kernel's mbarrier block holds 2 x 8
# a stage carries its chunk's rows and the row after them, and the table
# entries of those and one more (the kernel reads a row ahead, and the
# metadata two ahead, of the row it visits)
STAGE_BYTES = (ring.align((ring.STAGE_ROWS + 1) * ROW_F * 4)
               + ring.align((ring.STAGE_ROWS + 2) * _META_WORDS * 4))


class FatPlan(NamedTuple):
    """One launch of the fat-row sweep kernel: one block per env."""

    stages: int  # ring stages of ring.STAGE_ROWS rows
    threads: int  # threads per block
    smem_bytes: int  # dynamic shared memory per block

    def blocks(self, b: int) -> int:
        return b

    def describe(self, b: int) -> dict:
        """What a launch at ``b`` envs passes to the kernel."""
        return {"blocks": self.blocks(b), "threads": self.threads,
                "smem_bytes": self.smem_bytes, "stages": self.stages,
                "stage_rows": ring.STAGE_ROWS}


def smem_bytes(stages: int, nb6: int, nr: int) -> int:
    """Shared memory of a launch with ``stages`` stages (see the module note)."""
    return 2 * ring.ALIGN + stages * STAGE_BYTES + 4 * (_SLOT * (nb6 // 6 + 1) + nr)


def plan(nb6: int, nr: int, smem_optin: int) -> FatPlan:
    """The kernel's launch plan for ``nb6 / 6`` bodies and ``nr`` rows within
    ``smem_optin`` bytes of shared memory per block: the most stages that
    fit; raises ValueError when two do not."""
    if nb6 < 6 or nb6 % 6 or nr < 0:
        raise ValueError(f"fat sweep plan: bad shapes nb6={nb6} nr={nr}")
    for stages in range(MAX_STAGES, 1, -1):
        total = smem_bytes(stages, nb6, nr)
        if total <= smem_optin:
            return FatPlan(stages, THREADS, total)
    raise ValueError(f"fat sweep kernel: no launch plan fits {smem_optin} B of shared memory "
                     f"({nb6 // 6} bodies and {nr} rows need {smem_bytes(2, nb6, nr)} B "
                     "with 2 stages)")


# Bits of word 5 of a row's FatMeta.table entry: the row's own kind, and how
# the kernel hands state over from the visit of the row before it in visit
# order (row NR - 1 of the pass before, for row 0) to this row's.
SAME_A = 1 << 0  # body A is the row before's body A: take its new velocities
SAME_B = 1 << 1  # body B is the row before's body B (or both rows have none)
RARE = 1 << 2  # a body in the other slot, the bounding row is the row before, or NR = 1:
#                the row before stores everything and this row reloads after it
STORE_A = 1 << 3  # the row before stores its body A (this row does not carry it)
STORE_B = 1 << 4  # the row before stores its body B
BOTH = 1 << 5  # the row has a body B
FRIC = 1 << 6  # friction row: clamp +-mu * lam[bounding row]
JOINT = 1 << 7  # joint row: clamp [lo, hi]; other rows [0, inf) unless friction


def visit_flags(t: np.ndarray) -> np.ndarray:
    """Word 5 of the table rows ``t`` [n, 4+] (body A, body B or -1, kind,
    bounding row), int32 [n]: see SAME_A ... JOINT."""
    n = len(t)
    a, b, kind, bound = (t[:, i].astype(np.int64) for i in range(4))
    pa, pb, prev = np.roll(a, 1), np.roll(b, 1), np.roll(np.arange(n), 1)
    same_a, same_b = a == pa, b == pb
    rare = ((b >= 0) & (b == pa)) | (a == pb) | (bound == prev) | (n == 1)
    bits = (same_a * SAME_A + same_b * SAME_B + rare * RARE
            + (rare | ~same_a) * STORE_A + ((pb >= 0) & (rare | ~same_b)) * STORE_B
            + (b >= 0) * BOTH + (kind == KIND_FRICTION) * FRIC + (kind == KIND_JOINT) * JOINT)
    return bits.astype(np.int32)


class FatMeta(NamedTuple):
    """Static per-row sweep metadata in the forms both versions take."""

    # [ceil8(NR) + 8, 8] int32, the kernel's (ring.stage_table): body A,
    # body B (-1: static), kind, bounding row, -1, visit_flags, the bits of
    # f32 mu, the row; entry i >= NR repeats entry i % NR (the rows after
    # the last in visit order)
    table: torch.Tensor
    rows: tuple  # per-row Python tuples (ia6, ib6, kind, parent, mu): plain version
    groups: tuple | None = None  # checked ((start, size), ...); None: one row at a time
    rare: bool = False  # some row's hand-over is RARE: the kernel instance that takes them


def make_fat_meta(idx6_a, idx6_b, parent, mu, kind, skip_b, device, groups=None,
                  chunk=None) -> FatMeta:
    """Per-row tables on ``device``, made once per model and row set.
    ``groups`` (the scheduled order's) are checked here, once, against
    ``chunk``, the chunk they were built for."""
    groups = checked_groups(groups, chunk, idx6_a, idx6_b, parent, skip_b, len(idx6_a))
    skip_b = np.asarray(skip_b, bool).reshape(-1)
    mi = np.stack([np.asarray(idx6_a), np.asarray(idx6_b), np.asarray(kind), np.asarray(parent),
                   skip_b, np.full(skip_b.shape, -1)], 1).astype(np.int32).reshape(-1, 6)
    mu = np.asarray(mu, np.float32).reshape(-1)
    rows = tuple(
        (a, -1 if s else b, k, p, m) for (a, b, k, p, s, _), m in zip(mi.tolist(), mu.tolist())
    )
    n = len(rows)
    table = ring.stage_table(mi, mu[:, None], _META_WORDS)[:n]
    table[:, 5] = visit_flags(table)
    table[:, 7] = np.arange(n)
    size = -(-n // ring.STAGE_ROWS) * ring.STAGE_ROWS + ring.STAGE_ROWS
    table = table[np.arange(size) % n] if n else np.zeros((size, _META_WORDS), np.int32)
    rare = bool((table[:n, 5] & RARE).any())
    return FatMeta(torch.as_tensor(table, device=device), rows, groups, rare)


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


def sweep_fat_plain(row_data, vel6, lam0, meta: FatMeta, n_iters: int):
    """Loop-over-rows version of the sweep, in ``meta.groups`` (see
    :func:`.sweep.run_groups`); returns (vel6', lam')."""
    b, nb, _ = vel6.shape
    rd = row_data.permute(1, 2, 0)  # [NR, 28, B] view
    v = vel6.reshape(b, nb * 6).t().clone()  # [NB*6, B]
    lam = lam0.t().clone()  # [NR, B]
    zero = torch.zeros((), dtype=vel6.dtype, device=vel6.device)

    def visit(r):
        ia6, ib6, kind, parent, mu = meta.rows[r]
        x = rd[r]
        return visit_row(
            v, lam, r, x[_J:_J + 12], x[_DVA:_DVA + 6], x[_DVB:_DVB + 6], ia6,
            ib6 if ib6 >= 0 else None, x[_RHS], x[_IEF],
            lambda c: clamp_impulse(kind, c, x[_LO], x[_HI], mu, lam, parent, zero))

    for _ in range(n_iters):
        run_groups(meta.groups, len(meta.rows), visit)
    return v.t().reshape(b, nb, 6).contiguous(), lam.t().contiguous()


# ---------------------------------------------------------------------------
# CUDA kernel: build, load, launch
# ---------------------------------------------------------------------------


class FatSweepKernel(NvccLibrary):
    """The nvcc-built fat-row sweep library and its launch count.

    ``launches`` is a plain integer that :meth:`launch` raises by one per
    kernel launch and nothing else touches, so a run can show that its path
    went through the kernel. ``last`` holds the plan of the latest launch."""

    def __init__(self):
        super().__init__("solver_sweep.cu")
        self.launches = 0
        self.last = None
        self._lib = None

    def lib(self):
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            p = ctypes.c_void_p
            i = ctypes.c_int
            lib.solver_sweep_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, p]
            lib.solver_sweep_launch.restype = ctypes.c_int
            lib.solver_sweep_smem_bytes.argtypes = [i, i, i]
            lib.solver_sweep_smem_bytes.restype = ctypes.c_longlong
            lib.solver_sweep_blocks_per_sm.argtypes = [i, i]
            lib.solver_sweep_blocks_per_sm.restype = ctypes.c_int
            lib.solver_sweep_max_smem_per_block.argtypes = []
            lib.solver_sweep_max_smem_per_block.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def plan_for(self, row_data, vel6) -> FatPlan:
        """The launch plan of these inputs on the current card."""
        return plan(vel6.shape[1] * 6, row_data.shape[1],
                    self.lib().solver_sweep_max_smem_per_block())

    def blocks_per_sm(self, pl: FatPlan, rare: bool = False) -> int:
        """Resident blocks per SM of the plan's kernel instance (``rare``:
        the one for metas with RARE hand-overs) on the current card, as the
        CUDA runtime reckons them."""
        n = self.lib().solver_sweep_blocks_per_sm(pl.smem_bytes, int(rare))
        if n < 0:
            raise RuntimeError(f"fat sweep kernel occupancy query failed: cudaError {-n} ({pl})")
        return n

    def launch(self, row_data, vel6, lam0, meta: FatMeta, n_iters: int):
        b, nr, _ = row_data.shape
        pl = self.plan_for(row_data, vel6)
        vel_out = torch.empty_like(vel6)
        lam_out = torch.empty_like(lam0)
        err = self.lib().solver_sweep_launch(
            row_data.data_ptr(), vel6.data_ptr(), lam0.data_ptr(), meta.table.data_ptr(),
            vel_out.data_ptr(), lam_out.data_ptr(), b, vel6.shape[1] * 6, nr, n_iters,
            int(meta.rare), pl.stages, pl.smem_bytes,
            torch.cuda.current_stream(vel6.device).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"fat sweep kernel launch failed: cudaError {err} ({pl})")
        self.launches += 1
        self.last = pl
        return vel_out, lam_out


KERNEL = FatSweepKernel()


def _check(row_data, vel6, lam0, meta: FatMeta):
    if row_data.dim() != 3 or row_data.shape[2] != ROW_F:
        raise ValueError(f"row_data must be [B, NR, {ROW_F}], got {tuple(row_data.shape)}")
    b, nr, _ = row_data.shape
    if vel6.dim() != 3 or vel6.shape[2] != 6:
        raise ValueError(f"vel6 must be [B, NB, 6], got {tuple(vel6.shape)}")
    nb = vel6.shape[1]
    want = {
        "row_data": (row_data, (b, nr, ROW_F), torch.float32),
        "vel6": (vel6, (b, nb, 6), torch.float32),
        "lam0": (lam0, (b, nr), torch.float32),
        "table": (meta.table,
                  (-(-nr // ring.STAGE_ROWS) * ring.STAGE_ROWS + ring.STAGE_ROWS, _META_WORDS),
                  torch.int32),
    }
    dev = row_data.device
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, row_data on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    # the kernel copies rows and metadata in 16-byte units
    for name, t in (("row_data", row_data), ("table", meta.table)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    if len(meta.rows) != nr:
        raise ValueError(f"meta has {len(meta.rows)} rows, row_data {nr}")


def solver_sweep(row_data, vel6, lam0, meta: FatMeta, n_iters: int):
    """The sweep; returns (vel6' [B, NB, 6], lam' [B, NR]).

    Rows are visited in their order in ``row_data``, in ``meta.groups``
    where the meta has them (checked when it was made). On CUDA tensors this
    launches the kernel or raises; on CPU tensors it runs the plain version."""
    _check(row_data, vel6, lam0, meta)
    if row_data.device.type == "cuda":
        return KERNEL.launch(row_data, vel6, lam0, meta, n_iters)
    if row_data.device.type == "cpu":
        return sweep_fat_plain(row_data, vel6, lam0, meta, n_iters)
    raise ValueError(f"fat sweep: unsupported device {row_data.device}")

"""Sequential-impulse sweep over fat batch-first rows: CUDA kernel + plain version.

Port of ``solver_sweep`` (evomotion_tpu/physics/solver_pallas.py:191, kernel
``_sweep_kernel``), the sweep of the per-env physics step. ``n_iters``
passes over the constraint rows, visited strictly in order within each env,
envs independent; see ``csrc/solver_sweep.cu`` for the per-row arithmetic.

Row layout (``ROW_F`` = 28 f32 per row, computed by the caller): J (12:
a_lin, a_ang, b_lin, b_ang), dv_a = Minv_a J_a^T (6), dv_b (6), rhs, lo, hi,
inv_eff. Arrays are batch FIRST, as the JAX wrapper takes them:
``row_data [B, NR, 28]``, ``vel6 [B, NB, 6]``, ``lam0 [B, NR]``.

:func:`solver_sweep` dispatches on where its tensors lie:

- CUDA tensors: launches the hand-written kernel (built by ``nvcc`` into a
  shared library with a plain C interface at first use, loaded with ctypes)
  or raises. There is no fallback.
- CPU tensors: runs :func:`sweep_fat_plain`, a loop over rows in which each
  step works on ``[B]`` vectors. It repeats the kernel's arithmetic and is
  the reference the kernel is held against on the card.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .build import NvccLibrary
from .sweep import KIND_JOINT, KIND_NORMAL

ROW_F = 28
_J, _DVA, _DVB, _RHS, _LO, _HI, _IEF = 0, 12, 18, 24, 25, 26, 27


class FatMeta(NamedTuple):
    """Static per-row sweep metadata in the forms both versions take."""

    meta_i: torch.Tensor  # [NR, 4] int32: ia6, ib6 (-1: body B static), kind, parent
    mu: torch.Tensor  # [NR] f32 friction coefficient
    rows: tuple  # per-row Python tuples (ia6, ib6, kind, parent, mu): plain version


def make_fat_meta(idx6_a, idx6_b, parent, mu, kind, skip_b, device) -> FatMeta:
    """Per-row tables on ``device``, made once per model and row set."""
    idx6_b = np.where(np.asarray(skip_b, bool), -1, np.asarray(idx6_b))
    mi = np.stack([np.asarray(idx6_a), idx6_b, np.asarray(kind), np.asarray(parent)], 1)
    mi = mi.astype(np.int32).reshape(-1, 4)
    mu = np.asarray(mu, np.float32).reshape(-1)
    rows = tuple(
        (a, b, k, p, m) for (a, b, k, p), m in zip(mi.tolist(), mu.tolist())
    )
    return FatMeta(torch.as_tensor(mi, device=device), torch.as_tensor(mu, device=device),
                   rows)


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


def sweep_fat_plain(row_data, vel6, lam0, meta: FatMeta, n_iters: int):
    """Loop-over-rows version of the sweep; returns (vel6', lam')."""
    b, nb, _ = vel6.shape
    rd = row_data.permute(1, 2, 0)  # [NR, 28, B] view
    v = vel6.reshape(b, nb * 6).t().clone()  # [NB*6, B]
    lam = lam0.t().clone()  # [NR, B]
    zero = torch.zeros((), dtype=vel6.dtype, device=vel6.device)
    for _ in range(n_iters):
        for r, (ia6, ib6, kind, parent, mu) in enumerate(meta.rows):
            x = rd[r]
            va = v[ia6:ia6 + 6]
            jv = (x[_J:_J + 6] * va).sum(0)
            if ib6 >= 0:
                vb = v[ib6:ib6 + 6]
                jv = jv + (x[_J + 6:_J + 12] * vb).sum(0)
            old = lam[r]
            cand = old + (x[_RHS] - jv) * x[_IEF]
            if kind == KIND_JOINT:
                new = torch.minimum(torch.maximum(cand, x[_LO]), x[_HI])
            elif kind == KIND_NORMAL:
                new = torch.maximum(cand, zero)
            else:
                lim = mu * lam[parent]
                new = torch.minimum(torch.maximum(cand, -lim), lim)
            d = new - old
            lam[r] = new
            # both bodies' new velocities from the pre-row values, then A, B
            new_a = va + x[_DVA:_DVA + 6] * d
            if ib6 >= 0:
                new_b = vb + x[_DVB:_DVB + 6] * d
                v[ia6:ia6 + 6] = new_a
                v[ib6:ib6 + 6] = new_b
            else:
                v[ia6:ia6 + 6] = new_a
    return v.t().reshape(b, nb, 6).contiguous(), lam.t().contiguous()


# ---------------------------------------------------------------------------
# CUDA kernel: build, load, launch
# ---------------------------------------------------------------------------


class FatSweepKernel(NvccLibrary):
    """The nvcc-built fat-row sweep library and its launch count.

    ``launches`` is a plain integer that :meth:`launch` raises by one per
    kernel launch and nothing else touches, so a run can show that its path
    went through the kernel."""

    def __init__(self):
        super().__init__("solver_sweep.cu")
        self.launches = 0
        self._lib = None

    def lib(self):
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            p = ctypes.c_void_p
            i = ctypes.c_int
            lib.solver_sweep_launch.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, p]
            lib.solver_sweep_launch.restype = ctypes.c_int
            lib.solver_sweep_max_smem_per_block.argtypes = []
            lib.solver_sweep_max_smem_per_block.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def launch(self, row_data, vel6, lam0, meta: FatMeta, n_iters: int):
        b, nr, _ = row_data.shape
        nb6 = vel6.shape[1] * 6
        lib = self.lib()
        per_env = (nb6 + nr) * 4  # shared-memory bytes of one env
        threads = min(32, b, lib.solver_sweep_max_smem_per_block() // per_env)
        if threads < 1:
            raise ValueError(f"fat sweep kernel: {nb6 // 6} bodies and {nr} rows need "
                             f"{per_env} B of shared memory per env")
        vel_out = torch.empty_like(vel6)
        lam_out = torch.empty_like(lam0)
        err = lib.solver_sweep_launch(
            row_data.data_ptr(), vel6.data_ptr(), lam0.data_ptr(), meta.meta_i.data_ptr(),
            meta.mu.data_ptr(), vel_out.data_ptr(), lam_out.data_ptr(),
            b, nb6, nr, n_iters, threads, torch.cuda.current_stream(vel6.device).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"fat sweep kernel launch failed: cudaError {err}")
        self.launches += 1
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
        "meta_i": (meta.meta_i, (nr, 4), torch.int32),
        "mu": (meta.mu, (nr,), torch.float32),
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
    # the kernel reads rows and metadata as 16-byte vectors
    for name, t in (("row_data", row_data), ("meta_i", meta.meta_i)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    if len(meta.rows) != nr:
        raise ValueError(f"meta has {len(meta.rows)} rows, row_data {nr}")


def solver_sweep(row_data, vel6, lam0, meta: FatMeta, n_iters: int, groups=None):
    """The sweep; returns (vel6' [B, NB, 6], lam' [B, NR]).

    On CUDA tensors this launches the kernel or raises; on CPU tensors it
    runs the plain version. ``groups`` (the scheduled row order's Jacobi
    groups) is not ported yet."""
    if groups is not None:
        raise NotImplementedError(
            "solver_sweep groups (scheduled row order): not ported yet, see ROADMAP item 0"
        )
    _check(row_data, vel6, lam0, meta)
    if row_data.device.type == "cuda":
        return KERNEL.launch(row_data, vel6, lam0, meta, n_iters)
    if row_data.device.type == "cpu":
        return sweep_fat_plain(row_data, vel6, lam0, meta, n_iters)
    raise ValueError(f"fat sweep: unsupported device {row_data.device}")

"""Fused sequential-impulse sweep over slim env-last rows: CUDA kernel + plain version.

Port of ``solver_sweep_envlast_slim`` (evomotion_tpu/physics/solver_pallas.py:508,
kernel ``_sweep_kernel_envlast_slim``). ``n_iters`` passes over the constraint
rows, visited strictly in canonical order within each env, envs independent;
see ``csrc/sweep_envlast_slim.cu`` for the per-row arithmetic.

:func:`solver_sweep_envlast_slim` dispatches on where its tensors lie:

- CUDA tensors: launches the hand-written kernel (built by ``nvcc`` into a
  shared library with a plain C interface at first use, loaded with ctypes)
  or raises. There is no fallback.
- CPU tensors: runs :func:`sweep_plain`, a loop over rows in which each step
  works on ``[B]`` vectors. It repeats the kernel's arithmetic and is the
  reference the kernel is held against on the card.

Row layout (``ROW_J`` / ``ROW_S``): J columns ``[NR_pad, 12, B]`` (bf16 or
f32: a_lin, a_ang, b_lin, b_ang) and f32 scalars ``[NR_pad, 4, B]``
(rhs, lo, hi, rhs_push). Minv*J^T and 1/(J Minv J^T) are recomputed per row
from the world inverse inertia ``iinv9 [NB*9, B]`` and static inverse masses.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .build import NvccLibrary

ROW_J = 12
ROW_S = 4
_SRHS, _SLO, _SHI, _SRHSP = 0, 1, 2, 3  # indices into the scalar rows

# row bound kinds (static per row)
KIND_JOINT = 0  # bounds streamed per env (limit/motor rows are state-dependent)
KIND_NORMAL = 1  # [0, +inf)
KIND_FRICTION = 2  # +-mu * lam[parent]

_THREADS = 32  # threads per block in the kernel (one env each)


class SweepMeta(NamedTuple):
    """Static per-row sweep metadata in the forms both versions take."""

    meta_i: torch.Tensor  # [NR, 6] int32: ia6, ib6, kind, parent, skip_b, push_slot
    meta_f: torch.Tensor  # [NR, 3] f32: mu, inv_mass_a, inv_mass_b
    rows: tuple  # per-row Python tuples of the same fields (plain version)
    n_push: int  # push-impulse slots (contact normal rows), at least 1


def make_sweep_meta(inv_mass, idx6_a, idx6_b, parent, mu, kind, skip_b,
                    n_rows: int, device) -> SweepMeta:
    """Per-row tables for the first ``n_rows`` rows, on ``device`` once per model."""
    inv_mass = np.asarray(inv_mass, np.float32)
    idx6_a = np.asarray(idx6_a[:n_rows], np.int64)
    idx6_b = np.asarray(idx6_b[:n_rows], np.int64)
    kind = np.asarray(kind[:n_rows], np.int64)
    normal = kind == KIND_NORMAL
    push_slot = np.where(normal, np.cumsum(normal) - 1, -1)
    mi = np.stack(
        [idx6_a, idx6_b, kind, np.asarray(parent[:n_rows]),
         np.asarray(skip_b[:n_rows]).astype(np.int64), push_slot], 1
    ).astype(np.int32).reshape(n_rows, 6)
    mf = np.stack(
        [np.asarray(mu[:n_rows], np.float32), inv_mass[idx6_a // 6],
         inv_mass[idx6_b // 6]], 1
    ).astype(np.float32).reshape(n_rows, 3)
    rows = tuple(
        (int(a), int(b), int(k), int(p), bool(s), int(ps), float(m), float(ma), float(mb))
        for (a, b, k, p, s, ps), (m, ma, mb) in zip(mi.tolist(), mf.tolist())
    )
    return SweepMeta(
        meta_i=torch.as_tensor(mi, device=device),
        meta_f=torch.as_tensor(mf, device=device),
        rows=rows,
        n_push=max(int(normal.sum()), 1),
    )


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


def _dv(im, ii, j):
    """[im * j_lin, Iinv * j_ang] for one body: ii [9, B], j [6, B] -> [6, B]."""
    ang = (ii.view(3, 3, -1) * j[None, 3:6]).sum(1)
    return torch.cat([im * j[0:3], ang], 0)


def sweep_plain(row_j, row_s, vel6, lam0, iinv9, meta: SweepMeta, n_iters: int):
    """Loop-over-rows version of the sweep; returns (vel6', lam', push_vel6)."""
    v = vel6.clone()
    lam = lam0.clone()
    pv = torch.zeros_like(vel6)
    plam = torch.zeros((meta.n_push, vel6.shape[1]), dtype=vel6.dtype, device=vel6.device)
    zero = torch.zeros((), dtype=vel6.dtype, device=vel6.device)
    for _ in range(n_iters):
        for r, (ia6, ib6, kind, parent, skip_b, pslot, mu, im_a, im_b) in enumerate(meta.rows):
            rd = row_j[r].float()  # [12, B]
            rs = row_s[r]  # [4, B]
            ia9 = ia6 // 6 * 9
            dva = _dv(im_a, iinv9[ia9:ia9 + 9], rd[0:6])
            eff = (rd[0:6] * dva).sum(0)
            va = v[ia6:ia6 + 6]
            jv = (rd[0:6] * va).sum(0)
            if not skip_b:
                ib9 = ib6 // 6 * 9
                dvb = _dv(im_b, iinv9[ib9:ib9 + 9], rd[6:12])
                eff = eff + (rd[6:12] * dvb).sum(0)
                vb = v[ib6:ib6 + 6]
                jv = jv + (rd[6:12] * vb).sum(0)
            ie = torch.where(eff > 1e-12, 1.0 / torch.clamp(eff, min=1e-12), zero)

            old = lam[r]
            cand = old + (rs[_SRHS] - jv) * ie
            if kind == KIND_JOINT:
                new = torch.minimum(torch.maximum(cand, rs[_SLO]), rs[_SHI])
            elif kind == KIND_NORMAL:
                new = torch.maximum(cand, zero)
            else:
                lim = mu * lam[parent]
                new = torch.minimum(torch.maximum(cand, -lim), lim)
            d = new - old
            lam[r] = new
            v[ia6:ia6 + 6] = va + dva * d
            if not skip_b:
                v[ib6:ib6 + 6] = vb + dvb * d

            if pslot >= 0:
                pva = pv[ia6:ia6 + 6]
                jvp = (rd[0:6] * pva).sum(0)
                if not skip_b:
                    pvb = pv[ib6:ib6 + 6]
                    jvp = jvp + (rd[6:12] * pvb).sum(0)
                pold = plam[pslot]
                pnew = torch.maximum(pold + (rs[_SRHSP] - jvp) * ie, zero)
                dp = pnew - pold
                plam[pslot] = pnew
                pv[ia6:ia6 + 6] = pva + dva * dp
                if not skip_b:
                    pv[ib6:ib6 + 6] = pvb + dvb * dp
    return v, lam, pv


# ---------------------------------------------------------------------------
# CUDA kernel: build, load, launch
# ---------------------------------------------------------------------------


class SweepKernel(NvccLibrary):
    """The nvcc-built sweep library and its launch count.

    ``launches`` is a plain integer that :meth:`launch` raises by one per
    kernel launch and nothing else touches, so a run can show that its main
    path went through the kernel."""

    def __init__(self):
        super().__init__("sweep_envlast_slim.cu")
        self.launches = 0
        self._lib = None

    def lib(self):
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            p = ctypes.c_void_p
            i = ctypes.c_int
            lib.sweep_envlast_slim_launch.argtypes = [
                p, i, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, p,
            ]
            lib.sweep_envlast_slim_launch.restype = ctypes.c_int
            lib.sweep_envlast_slim_max_smem_per_block.argtypes = []
            lib.sweep_envlast_slim_max_smem_per_block.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def launch(self, row_j, row_s, vel6, lam0, iinv9, meta: SweepMeta, n_iters: int):
        nr_pad, _, b = row_j.shape
        nb6 = vel6.shape[0]
        n_rows = meta.meta_i.shape[0]
        lib = self.lib()
        smem = 2 * nb6 * _THREADS * 4
        if smem > lib.sweep_envlast_slim_max_smem_per_block():
            raise ValueError(f"sweep kernel: {nb6 // 6} bodies need {smem} B of shared memory")
        vel_out = torch.empty_like(vel6)
        lam_out = torch.empty_like(lam0)
        push_out = torch.empty_like(vel6)
        plam = torch.empty((meta.n_push, b), dtype=torch.float32, device=vel6.device)
        err = lib.sweep_envlast_slim_launch(
            row_j.data_ptr(), int(row_j.dtype == torch.bfloat16), row_s.data_ptr(),
            vel6.data_ptr(), lam0.data_ptr(), iinv9.data_ptr(),
            meta.meta_i.data_ptr(), meta.meta_f.data_ptr(),
            vel_out.data_ptr(), lam_out.data_ptr(), push_out.data_ptr(), plam.data_ptr(),
            b, nb6, nr_pad, n_rows, n_iters, meta.n_push,
            torch.cuda.current_stream(vel6.device).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"sweep kernel launch failed: cudaError {err}")
        self.launches += 1
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
        "meta_i": (meta.meta_i, (meta.meta_i.shape[0], 6), (torch.int32,)),
        "meta_f": (meta.meta_f, (meta.meta_i.shape[0], 3), (torch.float32,)),
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
    if nb6 % 6 or meta.meta_i.shape[0] > nr_pad:
        raise ValueError(f"bad sizes: nb6={nb6}, rows={meta.meta_i.shape[0]} > {nr_pad}")


def solver_sweep_envlast_slim(row_j, row_s, vel6, lam0, iinv9, meta: SweepMeta,
                              n_iters: int):
    """The fused sweep; returns (vel6', lam', push_vel6), all f32 ``[*, B]``.

    Rows ``meta.meta_i.shape[0]`` and beyond (padding) are not visited and
    keep their ``lam0``. On CUDA tensors this launches the kernel or raises;
    on CPU tensors it runs the plain version."""
    _check(row_j, row_s, vel6, lam0, iinv9, meta)
    if row_j.device.type == "cuda":
        return KERNEL.launch(row_j, row_s, vel6, lam0, iinv9, meta, n_iters)
    if row_j.device.type == "cpu":
        return sweep_plain(row_j, row_s, vel6, lam0, iinv9, meta, n_iters)
    raise ValueError(f"sweep: unsupported device {row_j.device}")

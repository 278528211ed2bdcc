"""Tests of the port's CUDA kernels on the card (marker ``gpu``).

They skip where torch sees no card. This file imports no JAX, so it also
runs on a host where JAX is not installed: ``python -m pytest --noconftest
-p no:cacheprovider tests/test_torch_gpu.py`` (the conftest imports JAX).
chip_smoke.py holds the same kernels against their plain versions at the
main path's real shapes.
"""

import numpy as np
import pytest
import torch

from evomotion_tpu_torch.kernels import sweep as tsp
from evomotion_tpu_torch.kernels import sweep_fat as tsf

NB = 4  # body 0 static (a floor), bodies 1-3 dynamic
NR_PAD = 32
N_ROWS = 29  # the last 3 rows are padding: not visited, lam passes through


def random_rows(seed, B):
    """Row tables + per-env arrays for a small random row set in canonical
    order: 10 joints | 6 normals (3 floor, 3 member) | 12 frictions | 1 joint."""
    rng = np.random.default_rng(seed)
    kind, ia, ib, parent, skip = [], [], [], [], []

    def row(k, a, b_, p=-1, s=False):
        kind.append(k), ia.append(a * 6), ib.append(b_ * 6), parent.append(p), skip.append(s)

    for r in range(10):
        row(tsp.KIND_JOINT, 1 + r % 3, 1 + (r + 1) % 3)
    normals = []
    for r in range(6):
        normals.append(len(kind))
        row(tsp.KIND_NORMAL, 1 + r % 3, 0 if r < 3 else 1 + (r + 2) % 3, s=r < 3)
    for n in normals:
        for _ in range(2):
            row(tsp.KIND_FRICTION, ia[n] // 6, ib[n] // 6, p=n, s=skip[n])
    row(tsp.KIND_JOINT, 2, 3)
    assert len(kind) == N_ROWS
    mu = np.where(np.array(kind) == tsp.KIND_FRICTION, rng.uniform(0.2, 1.0, N_ROWS), 0.0)
    inv_mass = np.array([0.0, 1.0, 0.5, 2.0], np.float32)

    row_j = (rng.normal(size=(NR_PAD, tsp.ROW_J, B)) * 0.5).astype(np.float32)
    row_j[np.array(skip + [False] * (NR_PAD - N_ROWS)), 6:] = 0.0  # static B: zero J_b
    rhs = rng.normal(size=(NR_PAD, B))
    lo = -np.abs(rng.normal(size=(NR_PAD, B))) * 2
    hi = np.abs(rng.normal(size=(NR_PAD, B))) * 2
    open_ = rng.random((NR_PAD, B)) < 0.3  # some unbounded joint rows
    lo[open_], hi[open_] = -np.inf, np.inf
    push = np.where(np.array(kind + [0] * (NR_PAD - N_ROWS))[:, None] == tsp.KIND_NORMAL,
                    np.abs(rng.normal(size=(NR_PAD, B))), 0.0)
    row_s = np.stack([rhs, lo, hi, push], 1).astype(np.float32)
    vel6 = rng.normal(size=(NB * 6, B)).astype(np.float32)
    lam0 = np.abs(rng.normal(size=(NR_PAD, B))).astype(np.float32) * 0.1
    # world inverse inertia R diag(d) R^T per body and env
    q, _ = np.linalg.qr(rng.normal(size=(B, NB, 3, 3)))
    d = rng.uniform(0.5, 2.0, size=(B, NB, 3))
    ii = np.einsum("bnij,bnj,bnkj->nikb", q, d, q).astype(np.float32)
    iinv9 = np.ascontiguousarray(ii.reshape(NB * 9, B))
    meta = (np.array(ia, np.int32), np.array(ib, np.int32), np.array(parent, np.int32),
            mu.astype(np.float32), np.array(kind, np.int32), np.array(skip))
    return row_j, row_s, vel6, lam0, iinv9, inv_mass, meta


def random_fat_rows(seed, B, push=False):
    """Fat rows [B, NR, 28] + per-env arrays + row metadata for a small random
    row set in canonical order: 6 joints | 6 normals (3 with a static body B)
    | 12 frictions | 1 joint; or, with ``push``, the 6 normal rows alone (the
    split-impulse pass's row set)."""
    rng = np.random.default_rng(seed)
    kind, ia, ib, parent, skip = [], [], [], [], []

    def row(k, a, b_, p=-1, s=False):
        kind.append(k), ia.append(a * 6), ib.append(b_ * 6), parent.append(p), skip.append(s)

    if not push:
        for r in range(6):
            row(tsp.KIND_JOINT, 1 + r % 3, 1 + (r + 1) % 3)
    normals = []
    for r in range(6):
        normals.append(len(kind))
        row(tsp.KIND_NORMAL, 1 + r % 3, 0 if r < 3 else 1 + (r + 2) % 3, s=r < 3)
    if not push:
        for n in normals:
            for _ in range(2):
                row(tsp.KIND_FRICTION, ia[n] // 6, ib[n] // 6, p=n, s=skip[n])
        row(tsp.KIND_JOINT, 2, 3)
    nr = len(kind)
    mu = np.where(np.array(kind) == tsp.KIND_FRICTION, rng.uniform(0.2, 1.0, nr), 0.0)
    # rows as a caller builds them: dv = Minv J^T from per-env inverse masses
    # and inertias, inv_eff = 1 / (J Minv J^T); a static body B has zero J_b
    j = rng.normal(size=(B, nr, 2, 6)) * 0.5
    j[:, np.array(skip), 1] = 0.0
    inv_m = np.array([0.0, 1.0, 0.5, 2.0])
    q, _ = np.linalg.qr(rng.normal(size=(B, NB, 3, 3)))
    iinv = np.einsum("bnij,bnj,bnkj->bnik", q, rng.uniform(0.5, 2.0, (B, NB, 3)), q)
    iinv[:, 0] = 0.0
    body = np.stack([np.array(ia) // 6, np.array(ib) // 6], 1)  # [NR, 2]
    dv = np.concatenate([
        inv_m[body][None, :, :, None] * j[..., :3],
        np.einsum("brsij,brsj->brsi", iinv[:, body], j[..., 3:]),
    ], -1)
    eff = (j * dv).sum((2, 3))
    rows = np.zeros((B, nr, tsf.ROW_F), np.float32)
    rows[..., 0:12] = j.reshape(B, nr, 12)
    rows[..., 12:24] = dv.reshape(B, nr, 12)
    rows[..., 24] = rng.normal(size=(B, nr))  # rhs
    lo = -np.abs(rng.normal(size=(B, nr))) * 2
    hi = np.abs(rng.normal(size=(B, nr))) * 2
    open_ = rng.random((B, nr)) < 0.3  # some unbounded joint rows
    lo[open_], hi[open_] = -np.inf, np.inf
    rows[..., 25], rows[..., 26] = lo, hi
    rows[..., 27] = 1.0 / eff
    vel6 = rng.normal(size=(B, NB, 6)).astype(np.float32)
    lam0 = (np.abs(rng.normal(size=(B, nr))) * 0.1).astype(np.float32)
    meta = (np.array(ia, np.int32), np.array(ib, np.int32), np.array(parent, np.int32),
            mu.astype(np.float32), np.array(kind, np.int32), np.array(skip))
    return rows, vel6, lam0, meta


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 64])
def test_fat_kernel_matches_plain_on_card(b):
    """The CUDA fat-row sweep against its plain version on the same card
    inputs, at B=1 (the per-env path) and B=64 (the batched call shape)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    dev = torch.device("cuda")
    for push in (False, True):
        rows, vel6, lam0, meta = random_fat_rows(3, b, push=push)
        m = tsf.make_fat_meta(*meta[:4], meta[4], meta[5], dev)
        args = [torch.as_tensor(x, device=dev) for x in (rows, vel6, lam0)]
        before = tsf.KERNEL.launches
        got = tsf.solver_sweep(*args, m, 3)
        assert tsf.KERNEL.launches == before + 1
        ref = tsf.sweep_fat_plain(*args, m, 3)
        for a, r in zip(got, ref):
            torch.testing.assert_close(a, r, atol=1e-4, rtol=0)


@pytest.mark.gpu
def test_kernel_matches_plain_on_card():
    """The CUDA sweep against its plain version on the same card inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    row_j, row_s, vel6, lam0, iinv9, inv_mass, meta = random_rows(2, 1000)
    ia, ib, parent, mu, kind, skip = meta
    dev = torch.device("cuda")
    m = tsp.make_sweep_meta(inv_mass, ia, ib, parent, mu, kind, skip, N_ROWS, dev)
    for jd in (torch.float32, torch.bfloat16):
        args = [torch.as_tensor(row_j, device=dev).to(jd)] + [
            torch.as_tensor(x, device=dev) for x in (row_s, vel6, lam0, iinv9)
        ]
        before = tsp.KERNEL.launches
        got = tsp.solver_sweep_envlast_slim(*args, m, 3)
        assert tsp.KERNEL.launches == before + 1
        ref = tsp.sweep_plain(*args, m, 3)
        for a, b in zip(got, ref):
            torch.testing.assert_close(a, b, atol=1e-4, rtol=0)

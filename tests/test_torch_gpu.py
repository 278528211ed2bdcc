"""Tests of the port's CUDA kernels on the card (marker ``gpu``): the
three sweeps against their plain versions, kernels #1 and #2 also on
scheduled rows with their groups; kernel #1 also on the spider's real rows
at B = 1, 17 and 256 (a stride TMA cannot take, a ragged last block, TMA),
kernel #3 also on prof_kernel's 2,048-row contact case (8 envs per block);
both at every envs per block a plan can take, forced by a smaller opt-in;
kernel #2 also on the spider's real per-env rows (velocity sweep and push
pass, both orders, B = 1 and 64), on cartpole's and cartpole3d's rows (a
ragged last stage), on rows built to reach each of its forwarding cases,
with one iteration, and with the fewest stages a plan can take;
the launch plans' shared-memory sums and occupancy against the kernels';
kernel #1 on the cartpoles' batched step (card against CPU) and the CLI's
batched PPO ``train`` on the card; the liquid SAC and PPO-GAE updates on
the card against the CPU, and the CLI's batched liquid PPO-GAE ``train``;
kernel #4 (the member contact phase) against its plain version on the
spider's member calls after a reset and after 30 random-action steps at
B = 1, 17, 256 and 4,096, with edge contacts off, K = 1, dense, f32 J and
strict_bullet, with warm caches that match nothing, on scrambled poses
(edge contacts), with one exploded env, once per physics step, and its
statics and shared-memory sums against the kernel's.

They skip where torch sees no card. This file imports no JAX, so it also
runs on a host where JAX is not installed: ``python -m pytest --noconftest
-p no:cacheprovider tests/test_torch_gpu.py`` (the conftest imports JAX).
chip_smoke.py holds the same kernels against their plain versions at the
main path's real shapes.
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from evomotion_tpu_torch.kernels import member as tsm
from evomotion_tpu_torch.kernels import sweep as tsp
from evomotion_tpu_torch.kernels import sweep_envlast as tse
from evomotion_tpu_torch.kernels import sweep_fat as tsf
from evomotion_tpu_torch.physics import batched as tbt

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


def random_envlast_rows(seed, B):
    """Env-last fat rows [NR_PAD, 29, B] (the random_fat_rows set, its 25
    rows padded to 32 with random rows that are not visited), vel6
    [NB*6, B], lam0 [NR_PAD, B], the row metadata and the real row count.
    Contact normal rows carry a positive split-impulse rhs in column 28."""
    rows, vel6, lam0, meta = random_fat_rows(seed, B)
    rng = np.random.default_rng(seed + 100)
    nr = rows.shape[1]
    out = rng.normal(size=(NR_PAD, tse.ROW_FP, B)).astype(np.float32)
    out[:nr, :28] = rows.transpose(1, 2, 0)
    normal = meta[4] == tsp.KIND_NORMAL
    out[:nr, 28] = np.where(normal[:, None], np.abs(rng.normal(size=(nr, B))), 0.0)
    lam = (np.abs(rng.normal(size=(NR_PAD, B))) * 0.1).astype(np.float32)
    lam[:nr] = lam0.T
    vel = np.ascontiguousarray(vel6.reshape(B, -1).T)
    return out, vel, lam, meta, nr


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


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 1000])
def test_envlast_kernel_matches_plain_on_card(b):
    """The CUDA env-last fat-row sweep against its plain version on the same
    card inputs: padding rows keep lam0, the push pass moves bodies."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    dev = torch.device("cuda")
    rows, vel6, lam0, meta, nr = random_envlast_rows(4, b)
    m = tse.make_envlast_meta(*meta, nr, dev)
    args = [torch.as_tensor(x, device=dev) for x in (rows, vel6, lam0)]
    before = tse.KERNEL.launches
    got = tse.solver_sweep_envlast(*args, m, 3)
    assert tse.KERNEL.launches == before + 1
    ref = tse.sweep_envlast_plain(*args, m, 3)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, atol=1e-4, rtol=0)
    assert torch.equal(got[1][nr:], args[2][nr:])
    assert float(got[2].abs().max()) > 0.0


def _scheduled(meta):
    """The scheduled order of a canonical row set, as _solver_meta makes it."""
    from evomotion_tpu_torch.physics import engine as TE

    return TE._permuted(TE.SolverMeta(*meta), "scheduled")


@pytest.mark.gpu
def test_grouped_kernels_match_grouped_plain_on_card():
    """Kernels #1 and #2 on scheduled rows with their groups (the kernels
    visit the rows one at a time) against the grouped plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    dev = torch.device("cuda")
    row_j, row_s, vel6, lam0, iinv9, inv_mass, meta = random_rows(7, 1000)
    s = _scheduled(meta)
    full = np.concatenate([s.perm, np.arange(N_ROWS, NR_PAD)])
    m = tsp.make_sweep_meta(inv_mass, *s[:6], N_ROWS, dev, groups=s.groups, chunk=s.chunk)
    args = [torch.as_tensor(x, device=dev) for x in (row_j[full], row_s[full], vel6,
                                                      lam0[full], iinv9)]
    got = tsp.solver_sweep_envlast_slim(*args, m, 3)
    ref = tsp.sweep_plain(*args, m, 3)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, atol=1e-4, rtol=0)

    rows, vel6, lam0, meta = random_fat_rows(8, 1)
    s = _scheduled(meta)
    m = tsf.make_fat_meta(*s[:6], dev, groups=s.groups, chunk=s.chunk)
    args = [torch.as_tensor(np.ascontiguousarray(x), device=dev)
            for x in (rows[:, s.perm], vel6, lam0[:, s.perm])]
    got = tsf.solver_sweep(*args, m, 3)
    ref = tsf.sweep_fat_plain(*args, m, 3)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, atol=1e-4, rtol=0)


SPIDER_B = 256


@pytest.fixture(scope="module")
def spider_sweeps():
    """Kernel #1's inputs in the first step after a seeded reset of the
    spider at B=256, and its plain version's outputs on them, for bf16 and
    f32 J rows, in the canonical and the scheduled order (permuted rows with
    their groups). Envs are independent, so the outputs of the first b envs
    are those of a call on the first b envs alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    from evomotion_tpu_torch.envs.robot import RobotWalk

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    env = RobotWalk(device=dev)
    state, _ = env.reset(SPIDER_B, gen)
    action = torch.rand((SPIDER_B, env.action_size), generator=gen, device=dev) * 2 - 1
    out = {}
    for dtype in ("bf16", "f32"):
        for order in ("canonical", "scheduled"):
            e = RobotWalk(device=dev)
            e.model = dataclasses.replace(env.model, row_dtype=dtype, row_order=order)
            calls, orig = [], tsp.solver_sweep_envlast_slim

            def capture(*a):
                calls.append([x.clone() if torch.is_tensor(x) else x for x in a])
                return orig(*a)

            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(tsp, "solver_sweep_envlast_slim", capture)
                e.step(state, action, gen)
            inp = calls[0]
            assert (inp[5].groups is not None) == (order == "scheduled")
            out[dtype, order] = inp, tsp.sweep_plain(*inp)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("order", ["canonical", "scheduled"])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("b", [1, 17, SPIDER_B])
def test_kernel_matches_plain_on_spider_rows(spider_sweeps, b, dtype, order):
    """Kernel #1 on the spider's real rows (1,896 rows, 42 bodies, 10
    iterations: the ring wraps across iterations, friction parents are read
    from shared memory) against its plain version within chip_smoke.TOL.
    B=1 and 17 take the plain-load copy path (and 17 a ragged last block),
    B=256 the TMA path."""
    inp, ref = spider_sweeps[dtype, order]
    sub = [x[..., :b].contiguous() if torch.is_tensor(x) else x for x in inp]
    before = tsp.KERNEL.launches
    got = tsp.solver_sweep_envlast_slim(*sub)
    torch.cuda.synchronize()
    assert tsp.KERNEL.launches == before + 1
    plan, copy = tsp.KERNEL.last
    assert copy == ("tma" if b == SPIDER_B else "plain")
    assert plan.envs == 16 and plan.masked(b) == (15 if b < SPIDER_B else 0)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r[..., :b], atol=chip_smoke.TOL, rtol=0)


@pytest.mark.gpu
def test_envlast_kernel_matches_plain_on_prof_kernel_contact_rows():
    """Kernel #3 on prof_kernel's 2,048-row contact case at B=2048 (683
    push slots: the plan takes 8 envs per block) against its plain version,
    each output within chip_smoke's TOL and REL_TOL of its own size."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    from evomotion_tpu_torch.tools import prof_kernel as pk

    dev, nr, b = torch.device("cuda"), 2048, 2048
    meta = tse.make_envlast_meta(*pk.case_meta("contact", nr, pk.BODIES), nr, dev)
    rng = np.random.default_rng(0)
    rows = torch.as_tensor(
        rng.standard_normal((nr, tse.ROW_FP, b)).astype(np.float32) * 0.01, device=dev)
    vel = torch.as_tensor(rng.standard_normal((pk.BODIES * 6, b)).astype(np.float32), device=dev)
    lam = torch.zeros((nr, b), device=dev)
    got = tse.solver_sweep_envlast(rows, vel, lam, meta, pk.ITERS)
    plan, copy = tse.KERNEL.last
    assert plan.envs == 8 and copy == "tma"
    ref = tse.sweep_envlast_plain(rows, vel, lam, meta, pk.ITERS)
    for name, err, mag, ok in chip_smoke.envlast_errors(got, ref):
        assert ok, (name, err, mag)


@pytest.mark.gpu
def test_plans_match_the_kernels_shared_memory_sums():
    """The wrappers' planners and the kernels sum a plan's shared memory
    alike (the launch refuses a plan whose bytes differ), at the spider's
    and prof_kernel's shapes and under smaller opt-ins that force fewer
    envs or stages; the spider's plans fit this card's opt-in."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    slim, fat = tsp.KERNEL.lib(), tse.KERNEL.lib()
    optin = slim.sweep_envlast_slim_max_smem_per_block()
    assert optin == fat.solver_sweep_envlast_max_smem_per_block() >= 232_448
    for nb6, nr, n_push in ((252, 1896, 548), (252, 2048, 683), (24, 29, 6)):
        for cap in (optin, 150_000, 60_000):
            for jb in (2, 4):
                pl = tsp.plan(nb6, nr, nr, n_push, jb, cap)
                assert pl.smem_bytes == slim.sweep_envlast_slim_smem_bytes(
                    pl.envs, pl.stages, jb, nb6, nr, n_push)
            pl = tse.plan(nb6, nr, nr, n_push, cap)
            assert pl.smem_bytes == fat.solver_sweep_envlast_smem_bytes(
                pl.envs, pl.stages, nb6, nr, n_push)
    # the spider's plans: one block per SM, as the CUDA runtime reckons it on
    # this card and as the planner's H100 model does
    for jb in (2, 4):
        pl = tsp.plan(252, 1920, 1896, 548, jb, optin)
        assert tsp.KERNEL.blocks_per_sm(pl) == pl.blocks_per_sm() == 1
    pl = tse.plan(252, 1920, 1896, 548, optin)
    assert tse.KERNEL.blocks_per_sm(pl) == pl.blocks_per_sm() == 1


def optin_for(envs, plan_at, optin):
    """The largest shared-memory opt-in at or below ``optin``, in steps of
    128 B, at which ``plan_at(opt_in)`` takes at most ``envs`` envs per block."""
    cap = optin
    while plan_at(cap).envs > envs:
        cap -= 128
    return cap


@pytest.mark.gpu
@pytest.mark.parametrize("order", ["canonical", "scheduled"])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("b", [17, SPIDER_B])
@pytest.mark.parametrize("envs", [8, 4, 2, 1])
def test_kernel_matches_plain_at_fewer_envs_per_block(spider_sweeps, envs, b, dtype, order):
    """Kernel #1's instances for fewer than 16 envs per block (what the
    planner gives a model larger than the spider), forced on the spider's
    real rows by a smaller shared-memory opt-in, against the plain version
    within chip_smoke.TOL; by TMA where the box is 16-byte wide, else by
    plain loads."""
    inp, ref = spider_sweeps[dtype, order]
    sub = [x[..., :b].contiguous() if torch.is_tensor(x) else x for x in inp]
    row_j, vel6, meta = sub[0], sub[2], sub[5]
    lib = tsp.KERNEL.lib()
    cap = optin_for(envs, lambda c: tsp.plan(vel6.shape[0], row_j.shape[0], len(meta.rows),
                                             meta.n_push, row_j.element_size(), c),
                    lib.sweep_envlast_slim_max_smem_per_block())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(lib, "sweep_envlast_slim_max_smem_per_block", lambda: cap)
        got = tsp.solver_sweep_envlast_slim(*sub)
    torch.cuda.synchronize()
    plan, copy = tsp.KERNEL.last
    assert plan.envs == envs
    assert copy == ("tma" if b == SPIDER_B and envs * row_j.element_size() >= 16 else "plain")
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r[..., :b], atol=chip_smoke.TOL, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("envs", [16, 8, 4, 2, 1])
def test_kernels_ignore_body_b_of_skip_b_rows(envs):
    """Both env-last kernels at each envs per block, on the random row sets
    with non-zero body-B columns on the skip_b rows (which neither version
    reads), against their plain versions: the two threads of an env must
    store the same impulses on those rows too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    dev, b = torch.device("cuda"), 1000
    rng = np.random.default_rng(7)

    row_j, row_s, vel6, lam0, iinv9, inv_mass, meta = random_rows(2, b)
    skip = np.array(meta[5].tolist() + [False] * (NR_PAD - N_ROWS))
    row_j[skip, 6:] = rng.normal(size=row_j[skip, 6:].shape)
    m = tsp.make_sweep_meta(inv_mass, *meta, N_ROWS, dev)
    lib = tsp.KERNEL.lib()
    for jd in (torch.float32, torch.bfloat16):
        args = [torch.as_tensor(row_j, device=dev).to(jd)] + [
            torch.as_tensor(x, device=dev) for x in (row_s, vel6, lam0, iinv9)
        ]
        cap = optin_for(envs, lambda c: tsp.plan(NB * 6, NR_PAD, N_ROWS, m.n_push,
                                                 args[0].element_size(), c),
                        lib.sweep_envlast_slim_max_smem_per_block())
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(lib, "sweep_envlast_slim_max_smem_per_block", lambda: cap)
            got = tsp.solver_sweep_envlast_slim(*args, m, 3)
        assert tsp.KERNEL.last[0].envs == envs
        ref = tsp.sweep_plain(*args, m, 3)
        for a, r in zip(got, ref):
            torch.testing.assert_close(a, r, atol=1e-4, rtol=0)

    rows, vel6, lam0, meta, nr = random_envlast_rows(4, b)
    skip = np.array(meta[5].tolist())
    for cols in (slice(6, 12), slice(18, 24)):  # J_b and dv_b
        rows[:nr][skip, cols] = rng.normal(size=rows[:nr][skip, cols].shape)
    m = tse.make_envlast_meta(*meta, nr, dev)
    args = [torch.as_tensor(x, device=dev) for x in (rows, vel6, lam0)]
    lib = tse.KERNEL.lib()
    cap = optin_for(envs, lambda c: tse.plan(vel6.shape[0], NR_PAD, nr, m.n_push, c),
                    lib.solver_sweep_envlast_max_smem_per_block())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(lib, "solver_sweep_envlast_max_smem_per_block", lambda: cap)
        got = tse.solver_sweep_envlast(*args, m, 3)
    assert tse.KERNEL.last[0].envs == envs
    ref = tse.sweep_envlast_plain(*args, m, 3)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, atol=1e-4, rtol=0)


@pytest.fixture(scope="module")
def spider_fat_sweeps():
    """Kernel #2's inputs, push pass and velocity sweep, in the first per-env
    spider step after a seeded reset at B=1, in the canonical and the
    scheduled order (permuted rows, the velocity sweep with its groups)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    from evomotion_tpu_torch.envs.robot import RobotWalk

    dev = torch.device("cuda")
    out = {}
    for order in ("canonical", "scheduled"):
        env = RobotWalk(mt_seed=0, device=dev, per_env_step=True)
        env.model = dataclasses.replace(env.model, row_order=order)
        state, _ = env.reset(1)
        gen = torch.Generator(device=dev).manual_seed(2)
        action = torch.rand((1, env.action_size), generator=gen, device=dev) * 2 - 1
        calls, orig = [], tsf.solver_sweep

        def capture(*a):
            calls.append([x.clone() if torch.is_tensor(x) else x for x in a])
            return orig(*a)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tsf, "solver_sweep", capture)
            env.step(state, action)
        assert len(calls) == 2 and (calls[1][3].groups is not None) == (order == "scheduled")
        out[order, "push"], out[order, "full"] = calls
    return out


def perturbed_copies(inp, b, seed):
    """``b`` copies of a B=1 fat sweep's inputs, each tensor scaled by
    1 + 1e-3 N(0, 1) per entry (numpy-made), so that the envs differ."""
    rng = np.random.default_rng(seed)
    out = []
    for x in inp[:3]:
        shape = (b,) + tuple(x.shape[1:])
        noise = torch.as_tensor(rng.standard_normal(shape).astype(np.float32), device=x.device)
        out.append((x.expand(shape) * (1 + 1e-3 * noise)).contiguous())
    return out + list(inp[3:])


def fat_kernel_vs_plain(inp, atol=1e-4):
    """Kernel #2 (one launch) against its plain version."""
    before = tsf.KERNEL.launches
    got = tsf.solver_sweep(*inp)
    torch.cuda.synchronize()
    assert tsf.KERNEL.launches == before + 1
    ref = tsf.sweep_fat_plain(*inp)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, atol=atol, rtol=0)
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 64])
@pytest.mark.parametrize("sweep", ["full", "push"])
@pytest.mark.parametrize("order", ["canonical", "scheduled"])
def test_fat_kernel_matches_plain_on_spider_rows(spider_fat_sweeps, order, sweep, b):
    """Kernel #2 on the spider's real per-env rows (1,896 rows of the
    velocity sweep, 548 of the push pass, 42 bodies, 10 iterations: the
    ring wraps across iterations) at B=1 and on 64 perturbed copies."""
    inp = spider_fat_sweeps[order, sweep]
    if b > 1:
        inp = perturbed_copies(inp, b, 11)
    fat_kernel_vs_plain(inp)
    assert tsf.KERNEL.last.stages == tsf.MAX_STAGES


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["cartpole", "cartpole3d"])
def test_fat_kernel_matches_plain_on_cartpole_rows(name):
    """Kernel #2 on the first sweep of a cartpole step (13 and 17 joint
    rows: the last stage of each pass is ragged)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    from evomotion_tpu_torch.envs.cartpole import CartPole
    from evomotion_tpu_torch.envs.cartpole3d import CartPole3d

    dev = torch.device("cuda")
    env = (CartPole if name == "cartpole" else CartPole3d)(mt_seed=3, device=dev)
    state, _ = env.reset(1)
    calls, orig = [], tsf.solver_sweep
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsf, "solver_sweep", lambda *a: calls.append(list(a)) or orig(*a))
        env.step(state, torch.full((1, env.action_size), 0.7, device=dev))
    inp = [x.clone() if torch.is_tensor(x) else x for x in calls[0]]
    assert inp[0].shape[1] % 8 != 0
    fat_kernel_vs_plain(inp)


def forwarding_rows(seed, b):
    """Fat rows that reach each case of kernel #2's forwarding, in order
    (bodies 1-4 dynamic, 0 static; a friction row's parent is the row
    before it, so its bound is the impulse the visit before just wrote):

    - consecutive rows sharing body A, and sharing body B;
    - A and B swapped; the next row's A is this row's B; its B this row's A;
    - the same bodies twice in a row;
    - skip_b rows (body B static) with non-zero J_b and dv_b columns, two
      in a row (both write the spare body), then a friction row on each;
    - 21 rows: the last stage of a pass holds 5.

    Returns (rows [b, 21, 28], vel6 [b, 5, 6], lam0 [b, 21], meta)."""
    pairs = [(1, 2), (1, 3), (4, 3), (3, 4), (4, 1), (2, 4), (2, 4), (3, 2),
             (1, 0), (1, 0), (2, 0), (3, 1), (3, 1), (4, 0), (2, 3), (1, 2),
             (4, 1), (1, 4), (2, 0), (2, 0), (4, 3)]
    kind = [0, 0, 0, 0, 0, 0, 0, 0, 1, 2, 1, 1, 2, 1, 0, 0, 0, 0, 1, 2, 0]
    nr = len(pairs)
    parent = np.where(np.array(kind) == 2, np.arange(nr) - 1, -1)
    ia = np.array([a * 6 for a, _ in pairs], np.int32)
    ib = np.array([b_ * 6 for _, b_ in pairs], np.int32)
    skip = np.array([b_ == 0 for _, b_ in pairs])
    rng = np.random.default_rng(seed)
    mu = np.where(np.array(kind) == 2, rng.uniform(0.2, 1.0, nr), 0.0).astype(np.float32)
    rows = np.zeros((b, nr, tsf.ROW_F), np.float32)
    j = rng.normal(size=(b, nr, 12)) * 0.5
    inv_m = rng.uniform(0.5, 2.0, size=(b, nr, 12))
    dv = j * inv_m  # a diagonal Minv per row and env
    eff = (j[..., :6] * dv[..., :6]).sum(-1) + np.where(skip, 0.0,
                                                         (j[..., 6:] * dv[..., 6:]).sum(-1))
    rows[..., :12], rows[..., 12:24] = j, dv  # skip_b rows keep J_b and dv_b: not read
    rows[..., 24] = rng.normal(size=(b, nr))
    rows[..., 25] = -np.abs(rng.normal(size=(b, nr))) * 2
    rows[..., 26] = np.abs(rng.normal(size=(b, nr))) * 2
    rows[..., 27] = 1.0 / eff
    vel6 = rng.normal(size=(b, 5, 6)).astype(np.float32)
    lam0 = (np.abs(rng.normal(size=(b, nr))) * 0.1).astype(np.float32)
    return rows, vel6, lam0, (ia, ib, parent.astype(np.int32), mu, np.array(kind, np.int32),
                              skip)


@pytest.mark.gpu
@pytest.mark.parametrize("n_iters", [1, 3])
@pytest.mark.parametrize("b", [1, 5])
def test_fat_kernel_forwarding_cases(b, n_iters):
    """Kernel #2 on :func:`forwarding_rows`, against its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    dev = torch.device("cuda")
    rows, vel6, lam0, meta = forwarding_rows(5, b)
    assert np.abs(rows[:, meta[5], 6:12]).min() > 0  # skip_b rows carry J_b
    m = tsf.make_fat_meta(*meta, dev)
    args = [torch.as_tensor(x, device=dev) for x in (rows, vel6, lam0)]
    vel, lam = fat_kernel_vs_plain(args + [m, n_iters])
    assert float((lam - args[2]).abs().max()) > 0 and float((vel - args[1]).abs().max()) > 0


@pytest.mark.gpu
def test_fat_kernel_with_one_iteration_and_two_stages(spider_fat_sweeps):
    """Kernel #2 with one iteration (the ring does not wrap before the last
    read-ahead), and with the fewest stages a plan takes (2, forced by a
    smaller opt-in), on the spider's velocity sweep rows in both orders."""
    lib = tsf.KERNEL.lib()
    for order in ("canonical", "scheduled"):
        rows, vel6, lam0, meta, _ = spider_fat_sweeps[order, "full"]
        fat_kernel_vs_plain([rows, vel6, lam0, meta, 1])
        cap = tsf.smem_bytes(2, vel6.shape[1] * 6, rows.shape[1])
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(lib, "solver_sweep_max_smem_per_block", lambda: cap)
            fat_kernel_vs_plain([rows, vel6, lam0, meta, 3])
        assert tsf.KERNEL.last.stages == 2


@pytest.mark.gpu
def test_fat_plan_matches_the_kernels_shared_memory_sum():
    """Kernel #2's planner and the kernel sum a plan's bytes alike, the
    launch refuses a plan whose bytes differ, the card holds the spider's
    plan, and on a CUDA tensor a row set no plan fits raises (no fallback)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    lib = tsf.KERNEL.lib()
    optin = lib.solver_sweep_max_smem_per_block()
    assert optin >= 232_448
    for nb6, nr in ((252, 1896), (252, 548), (18, 13), (24, 17), (252, 2048), (30, 0)):
        for cap in (optin, tsf.smem_bytes(3, nb6, nr)):
            pl = tsf.plan(nb6, nr, cap)
            assert pl.smem_bytes == lib.solver_sweep_smem_bytes(pl.stages, nb6, nr)
    pl = tsf.plan(252, 1896, optin)
    assert tsf.KERNEL.blocks_per_sm(pl) >= 1 and tsf.KERNEL.blocks_per_sm(pl, rare=True) >= 1

    dev = torch.device("cuda")
    rows, vel6, lam0, meta = forwarding_rows(6, 2)
    m = tsf.make_fat_meta(*meta, dev)
    args = [torch.as_tensor(x, device=dev) for x in (rows, vel6, lam0)]
    out = [torch.empty_like(args[1]), torch.empty_like(args[2])]
    pl = tsf.KERNEL.plan_for(args[0], args[1])
    err = lib.solver_sweep_launch(
        args[0].data_ptr(), args[1].data_ptr(), args[2].data_ptr(), m.table.data_ptr(),
        out[0].data_ptr(), out[1].data_ptr(), 2, 30, rows.shape[1], 1, int(m.rare), pl.stages,
        pl.smem_bytes + 128, torch.cuda.current_stream().cuda_stream)
    assert err != 0
    before = tsf.KERNEL.launches
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(lib, "solver_sweep_max_smem_per_block",
                   lambda: tsf.smem_bytes(2, 30, rows.shape[1]) - 1)
        with pytest.raises(ValueError, match="no launch plan fits"):
            tsf.solver_sweep(*args, m, 1)
    assert tsf.KERNEL.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("b", [4, 64])
@pytest.mark.parametrize("name", ["cartpole", "cartpole3d"])
def test_batched_cartpole_on_card_matches_cpu(name, b):
    """The cartpoles on the batched step (the tier of ``train --num_envs``):
    kernel #1 on their few joint rows (B = 4 takes plain loads, 64 TMA);
    reset and 12 steps of fixed actions on the card against the same on the
    CPU (the slim sweep's plain version) within chip_smoke's STEP_TOL."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    from evomotion_tpu_torch.envs.cartpole import CartPoleFactory
    from evomotion_tpu_torch.envs.cartpole3d import CartPole3dFactory

    fac = (CartPoleFactory if name == "cartpole" else CartPole3dFactory)({})
    envs = {d: fac.make(3, device=d, per_env_step=False) for d in ("cuda", "cpu")}
    acts = torch.as_tensor(np.random.default_rng(0).uniform(
        -1, 1, (12, b, envs["cpu"].action_size)).astype(np.float32))
    out = {}
    for d, env in envs.items():
        state, res = env.reset(b)
        obs = [res.obs]
        for a in acts:
            state, res = env.step(state, a.to(d))
            obs.append(res.obs)
        out[d] = torch.stack(obs).cpu()
    err = float((out["cuda"] - out["cpu"]).abs().max())
    assert err <= chip_smoke.STEP_TOL, err


@pytest.mark.gpu
def test_cli_batched_train_on_card(tmp_path):
    """``cli ... cartpole ppo_gae --num_envs 64 ... train`` on the card: two
    saves whose components load back with finite weights and Adam counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    from evomotion_tpu_torch import cli

    rc = cli.main(["cli", "cartpole", "ppo_gae", "--num_envs", "64", "--agent_parameters",
                   "hidden_size=32", "horizon=16", "epoch=2", "train", str(tmp_path), "-e",
                   "2", "-n", "2"])
    assert rc == 0
    with np.load(tmp_path / "save_1" / "critic_optimizer.npz") as f:
        assert int(f["1/0/count"]) == 8
    with np.load(tmp_path / "save_1" / "actor.npz") as f:
        assert all(np.isfinite(f[k]).all() for k in f)


@pytest.mark.gpu
def test_robot_jump_step_on_card_matches_cpu():
    """One batched robot_jump physics step of 4 envs (kernel #1, f32 rows)
    from a seeded reset against the same step on the CPU (the slim sweep's
    plain version) within chip_smoke's STEP_TOL."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    from evomotion_tpu_torch.envs.robot import RobotJump

    env = RobotJump(device="cuda")
    env.model = dataclasses.replace(env.model, row_dtype="f32")
    host = RobotJump(device="cpu")
    host.model = env.model
    gen = torch.Generator(device="cuda").manual_seed(0)
    state, _ = env.reset(4, gen)
    tgt = (torch.rand((4, env.action_size), generator=gen, device="cuda") * 2 - 1) * env._speed
    on = torch.ones((4, env.model.n_slider), dtype=torch.bool, device="cuda")
    card, _ = env.physics_step(state.physics, tgt, on)
    ref, _ = host.physics_step(type(state.physics)(*(x.cpu() for x in state.physics)),
                               tgt.cpu(), on.cpu())
    err = max(float((getattr(card, f).cpu() - getattr(ref, f)).abs().max())
              for f in ("pos", "quat", "lin_vel", "ang_vel"))
    assert err <= chip_smoke.STEP_TOL, err


@pytest.mark.gpu
@pytest.mark.parametrize("algo", ["actor_critic", "ppo_vanilla"])
def test_onpolicy_update_on_card_matches_cpu(algo):
    """An A2C and a PPO-vanilla update (hidden 64, batch 64, 4 epochs) on the
    card against the CPU from one shared state (the CPU's after a first
    update): the losses and every tensor of the carry within chip_smoke's
    UPDATE_TOL (a first update from the fresh init is held in chip_smoke's
    phase 21: ROADMAP Queue C trap 11)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    from evomotion_tpu_torch.train.checkpoint import _flatten

    s, a, sizes = 371, 12, {"actor_critic": 64, "ppo_vanilla": 64}
    agents = [chip_smoke._onpolicy_agent(algo, 0, s, a, 64, 64, 4, d) for d in ("cuda", "cpu")]
    rng = np.random.default_rng(0)
    batches = [chip_smoke._onpolicy_batch(algo, rng, s, a, sizes, agents[1]) for _ in range(2)]

    def update(ag, batch):
        batch = [x.to(ag.device) for x in batch]
        return ag.update(batch, 0.01) if algo == "actor_critic" else ag.update(batch)

    update(agents[1], batches[0])
    agents[0].load_carry_tree(agents[1].carry_tree())
    losses = [update(ag, batches[1]).cpu() for ag in agents]
    assert float((losses[0] - losses[1]).abs().max()) <= chip_smoke.UPDATE_TOL
    got, ref = _flatten(agents[0].carry_tree()), _flatten(agents[1].carry_tree())
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=chip_smoke.UPDATE_TOL,
                                   err_msg=k)


@pytest.mark.gpu
@pytest.mark.parametrize("algo", ["soft_actor_critic_liquid", "ppo_gae_liquid"])
def test_liquid_update_on_card_matches_cpu(algo):
    """A liquid SAC (batch 64) and a liquid PPO-GAE (3 trajectories of up to
    40 steps, 4 epochs) update at 64 neurons and 6 unfoldings on the card
    against the CPU from one shared state (the CPU's after a first update):
    the losses and every tensor of the carry within chip_smoke's UPDATE_TOL
    (a first update from the fresh init is held in chip_smoke's phase 25:
    ROADMAP Queue C trap 11; at this batch PPO's clip edge moves no moment
    beyond it, trap 13)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    from evomotion_tpu_torch.train.checkpoint import _flatten

    s, a = 371, 12
    sizes = {"soft_actor_critic_liquid": 64, "ppo_gae_liquid": (3, 40)}
    b = 3 if algo == "ppo_gae_liquid" else 64
    agents = [chip_smoke._liquid_agent(algo, 0, s, a, 64, 6, b, 4, d) for d in ("cuda", "cpu")]
    rng = np.random.default_rng(0)
    batches = [chip_smoke._liquid_batch(algo, rng, s, a, sizes, agents[1]) for _ in range(2)]
    chip_smoke._liquid_update(algo, agents[1], batches[0])
    agents[0].load_carry_tree(agents[1].carry_tree())
    losses = [chip_smoke._liquid_update(algo, ag, batches[1]).cpu() for ag in agents]
    assert float((losses[0] - losses[1]).abs().max()) <= chip_smoke.UPDATE_TOL
    got, ref = _flatten(agents[0].carry_tree()), _flatten(agents[1].carry_tree())
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=chip_smoke.UPDATE_TOL,
                                   err_msg=k)


@pytest.mark.gpu
def test_cli_batched_liquid_ppo_train_on_card(tmp_path):
    """``cli ... robot_walk ppo_gae_liquid --num_envs 64 ... train`` on the
    card, 2 iterations (horizon 16, 2 epochs): the slim sweep launched once
    per physics step, and a save whose components load back with finite
    weights and the Adam count of 2 x 2 epochs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    from evomotion_tpu_torch import cli
    from evomotion_tpu_torch.envs.robot import RobotWalkFactory

    tsp.KERNEL.launches = 0
    rc = cli.main(["cli", "robot_walk", "ppo_gae_liquid", "--num_envs", "64",
                   "--agent_parameters", "horizon=16", "epoch=2", "train", str(tmp_path), "-e",
                   "2", "-n", "1"])
    assert rc == 0
    settle = RobotWalkFactory({}).make(0, mt_parity=False, device="cpu",
                                       per_env_step=False).settle_total
    assert tsp.KERNEL.launches == settle + 2 * 16
    with np.load(tmp_path / "save_0" / "critic_optimizer.npz") as f:
        assert int(f["1/0/count"]) == 4
    with np.load(tmp_path / "save_0" / "actor.npz") as f:
        assert f["cell/w"].shape == (64, 371)
        assert all(np.isfinite(f[k]).all() for k in f)


# ---------------------------------------------------------------------------
# kernel #4: the member contact phase
# ---------------------------------------------------------------------------

MEMBER_B = 4096
MEMBER_VARIANTS = {
    "shipped": {},  # the top-48 cull, edge contacts, K = 4, bf16 J
    "no_edges": {"member_edge_contacts": False},
    "k1": {"member_manifold_k": 1},
    "dense": {"member_topm": 0},
    "f32": {"row_dtype": "f32"},
    "strict": {"strict_bullet": True},  # f32 J, the slip-aligned friction rows
}
_member_calls = {}


def _spy_member_call(env, state, action, gen):
    calls, orig = [], tsm.member_contact_rows

    def spy(*a, **kw):
        calls.append((a, kw))
        return orig(*a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsm, "member_contact_rows", spy)
        env.step(state, action, gen)
    assert len(calls) == 1
    return calls[0]


def member_call(variant, deep):
    """The member call of one spider step on the card at B=4096: after a
    seeded reset (60 settle steps), or after 30 more steps of uniform
    random actions (members driven into each other). The states come from
    the shipped model (the K=1 model's own for ``k1``, whose caches are
    smaller); the step is the variant's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    from evomotion_tpu_torch.envs.robot import RobotWalk

    key = (variant, deep)
    if key not in _member_calls:
        dev = torch.device("cuda")
        gen = torch.Generator(device=dev).manual_seed(1 + deep)
        base = RobotWalk(device=dev)
        if variant == "k1":
            base.model = dataclasses.replace(base.model, member_manifold_k=1)
        state, _ = base.reset(MEMBER_B, gen)
        for _ in range(30 if deep else 0):
            action = torch.rand((MEMBER_B, base.action_size), generator=gen, device=dev) * 2 - 1
            state = base.step(state, action, gen)[0]
        env = RobotWalk(device=dev)
        env.model = dataclasses.replace(base.model, **MEMBER_VARIANTS[variant])
        action = torch.rand((MEMBER_B, env.action_size), generator=gen, device=dev) * 2 - 1
        _member_calls[key] = _spy_member_call(env, state, action, gen)
    return _member_calls[key]


def _first_envs(x, b):
    """The first b envs of an env-last tensor, in the layout it has."""
    return x[..., :b].contiguous() if x.is_contiguous() else x[..., :b]


def _sub_call(call, b):
    args, kw = call
    args = [_first_envs(x, b) if torch.is_tensor(x) else x for x in args]
    kw = dict(kw, warm_cache=tuple(_first_envs(x, b) for x in kw["warm_cache"]))
    return args, kw


def check_member(got, ref, j_dtype):
    """Kernel #4's outputs against the plain version's. act, vid, lam_n0 and
    lam_t0 exactly: the kernel makes the same choices from the same f32
    values, and the warm impulses are cached values x WARMSTART. J within
    one bf16 rounding (chip_smoke.MEMBER_J_RTOL; f32 J within MEMBER_TOL)
    and the scalars within MEMBER_TOL: both compute them in the same f32
    operations, but the order PyTorch takes for its small sums follows the
    layout, which the batch changes (at B = 1 every component axis is
    innermost), and an f32 value an ulp apart can round to the next bf16.
    imp6 within MEMBER_TOL: the plain version sums it with atomics, the
    kernel in pair order."""
    (nj, ns), (fj, fs), x = got
    (rnj, rns), (rfj, rfs), rx = ref
    for name in ("act", "vid", "lam_n0", "lam_t0"):
        bad = int((x[name] != rx[name]).sum())
        assert bad == 0, f"{name}: {bad} of {x[name].numel()} differ"
    tol = chip_smoke.MEMBER_TOL
    jt = dict(rtol=chip_smoke.MEMBER_J_RTOL if j_dtype == torch.bfloat16 else tol, atol=tol)
    assert nj.dtype == fj.dtype == j_dtype
    torch.testing.assert_close(nj.float(), rnj.float(), **jt)
    torch.testing.assert_close(fj.float(), rfj.float(), **jt)
    torch.testing.assert_close(ns, rns, rtol=tol, atol=tol)
    assert torch.equal(fs, rfs)
    torch.testing.assert_close(x["imp6"], rx["imp6"], rtol=tol, atol=tol)


def member_kernel_vs_plain(call, b):
    """Kernel #4 (one launch) and the plain version on the first b envs."""
    args, kw = _sub_call(call, b)
    before = tsm.KERNEL.launches
    got = tsm.member_contact_rows(*args, **kw)
    torch.cuda.synchronize()
    assert tsm.KERNEL.launches == before + 1
    ref = tbt._member_contact_rows(*args, **kw)
    check_member(got, ref, kw["j_dtype"])
    return got, ref


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 17, 256, MEMBER_B])
@pytest.mark.parametrize("deep", [False, True], ids=["reset", "deep"])
def test_member_kernel_matches_plain_on_spider_states(deep, b):
    """Kernel #4 on the spider's real states (the shipped model: the top-48
    cull, edge contacts, K = 4, bf16 J): B = 1 and 17 take one env per
    block (17 blocks, 132 SMs), 256 one env per block, 4,096 sixteen."""
    got, ref = member_kernel_vs_plain(member_call("shipped", deep), b)
    pl, batch = tsm.KERNEL.last
    assert batch == b and pl.envs == (16 if b == MEMBER_B else 1)
    assert float(ref[2]["act"].sum()) > 0
    if deep:
        assert float(ref[2]["lam_n0"].abs().sum()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("deep", [False, True], ids=["reset", "deep"])
@pytest.mark.parametrize("variant", [v for v in MEMBER_VARIANTS if v != "shipped"])
def test_member_kernel_matches_plain_on_model_variants(variant, deep):
    """Kernel #4 with edge contacts off, K = 1, dense (every pair), f32 J
    and strict_bullet, at B=4096 (dense at 256: its plain version builds
    [120, 24, 20, B] temporaries)."""
    got, ref = member_kernel_vs_plain(member_call(variant, deep),
                                      256 if variant == "dense" else MEMBER_B)
    assert float(ref[2]["act"].sum()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("cache", ["none", "stale"])
def test_member_kernel_warm_cache_without_matches(cache):
    """Caches with no id to match (all -1, or ids of other features):
    zero warm impulses and imp6 on both sides."""
    args, kw = member_call("shipped", True)
    vid = kw["warm_cache"][0]
    old = torch.full_like(vid, -1) if cache == "none" else (vid + 1) % 24 + 48 * 2
    kw = dict(kw, warm_cache=(old, kw["warm_cache"][1]))
    got, ref = member_kernel_vs_plain((args, kw), 256)
    assert float(got[2]["lam_n0"].abs().sum()) == float(got[2]["imp6"].abs().sum()) == 0.0


@pytest.mark.gpu
def test_member_kernel_with_an_exploded_env():
    """One env with a NaN pose: no fault, and every other env's outputs
    equal to the kernel's outputs on the clean state."""
    args, kw = _sub_call(member_call("shipped", True), 64)
    clean = tsm.member_contact_rows(*args, **kw)
    bad = list(args)
    for i, body in ((2, 5), (3, 9)):  # pos and quat of two member bodies
        t = args[i].movedim(-1, 0).contiguous()
        t[7, body] = float("nan")
        bad[i] = t.movedim(0, -1)
    got = tsm.member_contact_rows(*bad, **kw)
    torch.cuda.synchronize()
    keep = [e for e in range(64) if e != 7]

    def flat(out):
        (nj, ns), (fj, fs), x = out
        return [nj, ns, fj, fs, *x.values()]

    for a, c in zip(flat(got), flat(clean)):
        assert torch.equal(a[..., keep], c[..., keep])


@pytest.mark.gpu
def test_member_kernel_on_scrambled_poses():
    """Random orientations and jittered positions of every body (deep,
    generic overlaps): edge-edge contacts replace slot 0 in some pairs, and
    the kernel still matches the plain version."""
    args, kw = _sub_call(member_call("shipped", False), 256)
    g = torch.Generator(device="cuda").manual_seed(5)
    pos, quat = args[2], args[3]
    pos = pos + (torch.rand(pos.shape, generator=g, device="cuda") - 0.5) * 0.2
    q = torch.randn(quat.shape, generator=g, device="cuda")
    args[2] = pos.movedim(-1, 0).contiguous().movedim(0, -1)
    args[3] = (q / q.norm(dim=1, keepdim=True)).movedim(-1, 0).contiguous().movedim(0, -1)
    got, ref = member_kernel_vs_plain((args, kw), 256)
    v = args[1].np_hull.shape[1]
    assert int((ref[2]["vid"] >= 2 * v).sum()) > 0


@pytest.mark.gpu
def test_member_kernel_launches_once_per_physics_step():
    """The batched spider on the card: kernel #4 once per physics step,
    the reset's settle steps included, and kernel #1 as often."""
    from evomotion_tpu_torch.envs.robot import RobotWalk

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    env = RobotWalk(device=dev)
    m0, s0 = tsm.KERNEL.launches, tsp.KERNEL.launches
    state, _ = env.reset(64, gen)
    for _ in range(5):
        action = torch.rand((64, env.action_size), generator=gen, device=dev) * 2 - 1
        state = env.step(state, action, gen)[0]
    torch.cuda.synchronize()
    steps = env.settle_total + 5
    assert tsm.KERNEL.launches - m0 == tsp.KERNEL.launches - s0 == steps


@pytest.mark.gpu
def test_member_plan_sums_match_the_kernel():
    """The wrapper's statics words and shared-memory sums equal the
    kernel's, for the spider and at the caps; two blocks of 16 envs fit an
    SM."""
    args, kw = member_call("shipped", False)
    st = args[1]
    meta = st.member_meta
    lib = tsm.KERNEL.lib()
    assert lib.member_meta_words(meta.nb, meta.u, meta.p, meta.v, meta.f, meta.ne) == \
        meta.words.numel()
    for dims in ((meta.nb, meta.u, meta.p, 48, meta.v, meta.f, meta.ne),
                 (64, 40, 780, 780, tsm.MAX_V, 92, tsm.MAX_EDGES)):
        for envs in tsm.ENVS:
            assert lib.member_smem_bytes(*dims, envs) == tsm.smem_bytes(*dims, envs)
    sh = tsm.shapes(args[0], st)
    pl = tsm.KERNEL.plan_for(meta, sh, MEMBER_B, "cuda")
    assert pl.envs == 16 and tsm.KERNEL.blocks_per_sm(pl) >= 2

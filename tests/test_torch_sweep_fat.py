"""The fat-row sweep's plain version against the JAX package's Pallas kernel.

Random fat rows of all three kinds (joint, contact normal, friction with a
live parent), with and without a static body B, and a normal-only row set
(the split-impulse pass), go through ``solver_sweep`` of the JAX package
(interpret mode, as its own tests run it, B = one 1,024-env tile) and of the
port (CPU tensors -> the plain version), over 3 solver iterations, at 1e-5.

The grouped case runs the rows in the ``scheduled`` order with its groups
through both (JAX's groups mode, the port's grouped plain version), and
holds the grouped plain version equal to visiting the same rows one at a
time, which is what the CUDA kernel does.

The kernel's launch plan and its metadata table are checked here too: the
row sets the port sweeps (the spider's per-env velocity sweep and push
pass, cartpole, cartpole3d, prof_kernel's 2,048 rows) get a plan within an
H100's opt-in, and the table unpacks to the metadata the plain version
reads, on the spider's canonical and scheduled row sets.

The CUDA kernel itself is held against this plain version on the card by
chip_smoke.py and by test_torch_gpu.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evomotion_tpu.physics import solver_pallas as jsp
from evomotion_tpu_torch.kernels import ring
from evomotion_tpu_torch.kernels import sweep_fat as tsf
from evomotion_tpu_torch.physics import engine as TE
from test_torch_gpu import random_fat_rows

B = jsp.TILE  # the JAX kernel's env tile
OPTIN = 232_448  # an H100's opt-in shared memory per block


@pytest.mark.parametrize("push", [False, True], ids=["full", "push"])
def test_plain_fat_sweep_matches_jax_kernel(push):
    rows, vel6, lam0, meta = random_fat_rows(0, B, push=push)
    ia, ib, parent, mu, kind, skip = meta
    jv, jl = jsp.solver_sweep(
        jnp.asarray(rows), jnp.asarray(vel6), jnp.asarray(lam0), ia, ib, parent, mu, 3,
        kind=kind, skip_b=skip, interpret=True,
    )
    m = tsf.make_fat_meta(ia, ib, parent, mu, kind, skip, "cpu")
    tv, tl = tsf.solver_sweep(torch.as_tensor(rows), torch.as_tensor(vel6),
                              torch.as_tensor(lam0), m, 3)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5, rtol=0, err_msg="vel6")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=0, err_msg="lam")
    # every row did work
    assert (np.abs(tl.numpy() - lam0) > 1e-3).mean() > 0.5


def test_fat_sweep_wrapper_rejects_bad_inputs():
    rows, vel6, lam0, meta = random_fat_rows(1, 4)
    m = tsf.make_fat_meta(*meta, "cpu")
    args = [torch.as_tensor(x) for x in (rows, vel6, lam0)]
    with pytest.raises(TypeError):
        tsf.solver_sweep(args[0].double(), *args[1:], m, 1)
    with pytest.raises(ValueError):
        tsf.solver_sweep(args[0][:, :, :27], *args[1:], m, 1)
    with pytest.raises(ValueError):
        tsf.solver_sweep(args[0], args[1], args[2][:, :-1], m, 1)
    with pytest.raises(ValueError):
        tsf.solver_sweep(args[0].transpose(0, 1).contiguous().transpose(0, 1), *args[1:], m, 1)
    with pytest.raises(ValueError, match="tile"):  # groups are checked in the meta
        tsf.make_fat_meta(*meta, "cpu", groups=((0, 1),), chunk=8)
    before = tsf.KERNEL.launches
    tsf.solver_sweep(*args, m, 1)  # CPU: plain version, no launch
    assert tsf.KERNEL.launches == before


def scheduled(meta):
    """The scheduled order of a canonical row set: the permuted metadata
    (with perm and groups) as the port's _solver_meta makes it."""
    ia, ib, parent, mu, kind, skip = meta
    out = TE._permuted(TE.SolverMeta(ia, ib, parent, mu, kind, skip), "scheduled")
    assert max(z for _, z in out.groups) > 1  # some group really holds several rows
    return out


def test_grouped_plain_fat_sweep_matches_jax_kernel():
    rows, vel6, lam0, meta = random_fat_rows(4, B)
    s = scheduled(meta)
    rows, lam0 = np.ascontiguousarray(rows[:, s.perm]), np.ascontiguousarray(lam0[:, s.perm])
    jv, jl = jsp.solver_sweep(
        jnp.asarray(rows), jnp.asarray(vel6), jnp.asarray(lam0), s.idx6_a, s.idx6_b, s.parent,
        s.mu, 3, kind=s.kind, skip_b=s.skip_b, interpret=True, groups=s.groups,
    )
    args = [torch.as_tensor(x) for x in (rows, vel6, lam0)]
    grouped = tsf.make_fat_meta(*s[:6], "cpu", groups=s.groups, chunk=s.chunk)
    tv, tl = tsf.solver_sweep(*args, grouped, 3)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5, rtol=0, err_msg="vel6")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=0, err_msg="lam")
    # under the checked invariant, one row at a time computes the same values
    sv, sl = tsf.solver_sweep(*args, tsf.make_fat_meta(*s[:6], "cpu"), 3)
    assert torch.equal(sv, tv) and torch.equal(sl, tl)


@pytest.fixture(scope="module")
def perenv_metas():
    """The fat metas of the per-env step's two sweeps (full, push) and the
    body count, per row set: the spider in the canonical and the scheduled
    order, cartpole and cartpole3d (no contacts: one sweep)."""
    from evomotion_tpu_torch.envs.cartpole import CartPole
    from evomotion_tpu_torch.envs.cartpole3d import CartPole3d
    from evomotion_tpu_torch.envs.robot import RobotWalk

    out = {}
    spider = RobotWalk(device="cpu", per_env_step=True)
    for order in ("canonical", "scheduled"):
        spider.model = dataclasses.replace(spider.model, row_order=order)
        step = spider.physics_step
        out[f"spider {order}"] = (step.solve_full.meta, step.solve_push.meta,
                                  spider.model.n_bodies)
    for name, cls in (("cartpole", CartPole), ("cartpole3d", CartPole3d)):
        env = cls(device="cpu")
        assert env.physics_step.solve_push is None
        out[name] = (env.physics_step.solve_full.meta, None, env.model.n_bodies)
    return out


@pytest.mark.parametrize("case", ["spider full", "spider push", "cartpole", "cartpole3d",
                                  "prof_kernel 2048"])
def test_plan_fits_the_row_sets_swept(perenv_metas, case):
    """Each row set the port sweeps gets a plan within the opt-in with at
    least two stages (the spider's sweeps and the cartpoles: all eight), the
    same plan for the same shapes, and the module note's byte sum."""
    from evomotion_tpu_torch.tools import prof_kernel

    if case == "prof_kernel 2048":
        nb, nr = prof_kernel.BODIES, 2048
    else:
        full, push, nb = perenv_metas["spider canonical" if "spider" in case else case]
        nr = len((push if case == "spider push" else full).rows)
    want = {"spider full": 1896, "spider push": 548, "cartpole": 13, "cartpole3d": 17}
    assert nr == want.get(case, 2048)
    pl = tsf.plan(nb * 6, nr, OPTIN)
    assert pl.smem_bytes <= OPTIN and pl.stages == tsf.MAX_STAGES and pl.threads == 64
    assert pl.smem_bytes == (2 * ring.ALIGN + pl.stages * tsf.STAGE_BYTES
                             + 4 * (8 * (nb + 1) + nr))
    assert pl == tsf.plan(nb * 6, nr, OPTIN)
    assert pl.blocks(64) == 64 and pl.describe(1)["blocks"] == 1


def test_fat_plan_takes_fewer_stages_then_raises():
    """Under a smaller opt-in the plan takes fewer stages; where two stages
    do not fit beside the velocities and impulses it raises ValueError."""
    need = tsf.smem_bytes(3, 252, 1896)
    assert tsf.plan(252, 1896, need).stages == 3
    assert tsf.plan(252, 1896, need - 1).stages == 2
    with pytest.raises(ValueError, match="no launch plan fits"):
        tsf.plan(252, 1896, tsf.smem_bytes(2, 252, 1896) - 1)
    with pytest.raises(ValueError, match="no launch plan fits"):
        tsf.plan(252, 60_000, OPTIN)
    with pytest.raises(ValueError, match="bad shapes"):
        tsf.plan(250, 1896, OPTIN)


@pytest.mark.parametrize("sweep", ["full", "push"])
@pytest.mark.parametrize("order", ["canonical", "scheduled"])
def test_fat_stage_table_unpacks_to_meta_rows(perenv_metas, order, sweep):
    """The kernel's table of the spider's fat meta is padded to whole 8-row
    stages of 16-byte rows, plus one stage, by repeating its entries in visit
    order (a stage carries the two rows after its own, and row 0 follows the
    last), and holds, per row, what the plain version reads from
    ``meta.rows``: body A, body B (-1 on skip_b rows), kind, the bounding row
    (the parent on friction rows, the row itself elsewhere), mu bit for bit,
    and the row itself."""
    full, push, _ = perenv_metas[f"spider {order}"]
    meta = full if sweep == "full" else push
    assert (meta.groups is not None) == (order == "scheduled" and sweep == "full")
    t = meta.table.numpy()
    nr = len(meta.rows)
    assert meta.table.dtype == torch.int32 and t.shape == (-(-nr // 8) * 8 + 8, 8)
    assert t.shape[0] % ring.STAGE_ROWS == 0 and t.shape[1] * 4 % 16 == 0
    np.testing.assert_array_equal(t[nr:], t[np.arange(nr, len(t)) % nr])
    ia6, ib6, kind, parent, mu = (np.array(c) for c in zip(*meta.rows))
    assert (ib6 == -1).any() and (kind == 2).any() == (sweep == "full")
    np.testing.assert_array_equal(t[:nr, 0], ia6 // 6)
    np.testing.assert_array_equal(t[:nr, 1], np.where(ib6 < 0, -1, ib6 // 6))
    np.testing.assert_array_equal(t[:nr, 2], kind)
    np.testing.assert_array_equal(t[:nr, 3], np.where(kind == 2, parent, np.arange(nr)))
    np.testing.assert_array_equal(t[:nr, 4], -1)
    np.testing.assert_array_equal(t[:nr, 7], np.arange(nr))
    np.testing.assert_array_equal(t[:nr, 6], np.asarray(mu, np.float32).view(np.int32))
    # word 5, the visit flags: the row's kind, and its hand-over from the row
    # visited before it (the last row before row 0)
    fl = t[:nr, 5]

    def bit(flag):
        return (fl & flag) != 0

    np.testing.assert_array_equal(bit(tsf.BOTH), ib6 >= 0)
    np.testing.assert_array_equal(bit(tsf.FRIC), kind == 2)
    np.testing.assert_array_equal(bit(tsf.JOINT), kind == 0)
    a, b = ia6 // 6, np.where(ib6 < 0, -1, ib6 // 6)
    for r in range(nr):
        p = r - 1  # -1: the last row
        same_a, same_b = a[r] == a[p], b[r] == b[p]
        rare = (b[r] >= 0 and b[r] == a[p]) or (b[p] >= 0 and a[r] == b[p]) or (
            kind[r] == 2 and parent[r] == p % nr)
        assert (bit(tsf.SAME_A)[r], bit(tsf.SAME_B)[r], bit(tsf.RARE)[r]) == (
            same_a, same_b, rare), r
        assert bit(tsf.STORE_A)[r] == (rare or not same_a), r
        assert bit(tsf.STORE_B)[r] == (b[p] >= 0 and (rare or not same_b)), r
    # the spider never hands a body over across slots; its canonical order
    # carries body A from row to row nearly always
    assert not bit(tsf.RARE).any() and not meta.rare
    assert bit(tsf.SAME_A).mean() > (0.9 if order == "canonical" else 0.0)


def test_fat_meta_marks_rare_hand_overs():
    """The hand-overs the kernel's fast path cannot take are flagged RARE and
    make the meta ``rare``: a body that changes slot from one row to the
    next, a friction row right after its parent, a single row; rows that
    share a body in the same slot are not."""
    from test_torch_gpu import forwarding_rows

    _, _, _, meta = forwarding_rows(0, 1)
    m = tsf.make_fat_meta(*meta, "cpu")
    fl = m.table[:len(m.rows), 5].numpy()
    rare = set(np.flatnonzero(fl & tsf.RARE).tolist())
    # (1, 2) -> (1, 3): same slot; (4, 3) -> (3, 4): both swap; (3, 4) -> (4, 1):
    # A takes B's; (2, 4) -> (3, 2): B takes A's; friction rows 9, 12 and 19
    # follow their parents; (1, 2) -> (4, 1) -> (1, 4): swaps again
    assert {3, 4, 7, 9, 12, 16, 17, 19} <= rare and 1 not in rare and m.rare
    assert fl[1] & tsf.SAME_A and fl[6] & tsf.SAME_A and fl[6] & tsf.SAME_B
    one = tsf.make_fat_meta(*(x[:1] for x in meta), "cpu")
    assert one.rare and one.table[0, 5] & tsf.RARE

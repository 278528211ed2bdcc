"""The sweep's plain version against the JAX package's Pallas kernel.

Random rows of all three kinds (joint, contact normal with its push row,
friction with a live parent), with and without a static body B, go through
``solver_sweep_envlast_slim`` of the JAX package (interpret mode, as its own
tests run it) and of the port (CPU tensors -> the plain version), over 3
solver iterations. bf16 J is compared with both sides fed the same
materialised bf16 values: under CPU interpret XLA elides a bf16 convert pair
built inside the graph, so JAX's in-graph bf16 is really f32.

The grouped case runs the rows in the ``scheduled`` order with its groups
through both (JAX's groups mode, the port's grouped plain version), and
holds the grouped plain version equal to visiting the same rows one at a
time, which is what the CUDA kernel does. ``make_sweep_meta`` and
``make_fat_meta`` reject groups that break the invariant behind that.

The CUDA kernel itself is held against this plain version on the card by
chip_smoke.py and by test_torch_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evomotion_tpu.physics import solver_pallas as jsp
from evomotion_tpu_torch.kernels import sweep as tsp
from evomotion_tpu_torch.kernels import sweep_fat as tsf
from test_torch_gpu import N_ROWS, NR_PAD, random_rows
from test_torch_sweep_fat import scheduled

B = jsp.TILE  # the JAX kernel's env tile

def _jax_sweep(row_j, row_s, vel6, lam0, iinv9, inv_mass, meta, n_iters):
    ia, ib, parent, mu, kind, skip = meta
    out = jsp.solver_sweep_envlast_slim(
        row_j, jnp.asarray(row_s), jnp.asarray(vel6), jnp.asarray(lam0),
        jnp.asarray(iinv9), inv_mass, ia, ib, parent, mu, n_iters, N_ROWS,
        kind=kind, skip_b=skip, interpret=True,
    )
    return [np.asarray(o) for o in out]


def _port_sweep(row_j, row_s, vel6, lam0, iinv9, inv_mass, meta, n_iters):
    ia, ib, parent, mu, kind, skip = meta
    m = tsp.make_sweep_meta(inv_mass, ia, ib, parent, mu, kind, skip, N_ROWS, "cpu")
    out = tsp.solver_sweep_envlast_slim(
        row_j, torch.as_tensor(row_s), torch.as_tensor(vel6), torch.as_tensor(lam0),
        torch.as_tensor(iinv9), m, n_iters,
    )
    return [o.numpy() for o in out]


@pytest.mark.parametrize("j_dtype", ["f32", "bf16"])
def test_plain_sweep_matches_jax_kernel(j_dtype):
    row_j, row_s, vel6, lam0, iinv9, inv_mass, meta = random_rows(0, B)
    if j_dtype == "bf16":
        jj = jnp.asarray(row_j).astype(jnp.bfloat16)  # materialised bf16
        tj = torch.as_tensor(np.asarray(jj.astype(jnp.float32))).to(torch.bfloat16)
        assert np.array_equal(tj.float().numpy(), np.asarray(jj.astype(jnp.float32)))
    else:
        jj, tj = jnp.asarray(row_j), torch.as_tensor(row_j)
    ref = _jax_sweep(jj, row_s, vel6, lam0, iinv9, inv_mass, meta, 3)
    got = _port_sweep(tj, row_s, vel6, lam0, iinv9, inv_mass, meta, 3)
    for name, a, b in zip(("vel6", "lam", "push_vel6"), got, ref):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0, err_msg=name)
    # every kind of row did work, and padding rows kept lam0
    lam = got[1]
    assert np.abs(lam[:N_ROWS] - lam0[:N_ROWS]).max() > 1e-2
    assert np.array_equal(lam[N_ROWS:], lam0[N_ROWS:])
    assert np.abs(got[2]).max() > 0.0


def test_sweep_wrapper_rejects_bad_inputs():
    row_j, row_s, vel6, lam0, iinv9, inv_mass, meta = random_rows(1, B)
    ia, ib, parent, mu, kind, skip = meta
    m = tsp.make_sweep_meta(inv_mass, ia, ib, parent, mu, kind, skip, N_ROWS, "cpu")
    args = [torch.as_tensor(x) for x in (row_j, row_s, vel6, lam0, iinv9)]
    with pytest.raises(TypeError):
        tsp.solver_sweep_envlast_slim(args[0].double(), *args[1:], m, 1)
    with pytest.raises(ValueError):
        tsp.solver_sweep_envlast_slim(args[0], args[1][:, :3], *args[2:], m, 1)
    with pytest.raises(ValueError):
        tsp.solver_sweep_envlast_slim(args[0], args[1], args[2].t().contiguous().t(),
                                      *args[3:], m, 1)
    before = tsp.KERNEL.launches
    tsp.solver_sweep_envlast_slim(*args, m, 1)  # CPU: plain version, no launch
    assert tsp.KERNEL.launches == before


def scheduled_rows(seed, b):
    """random_rows in the scheduled order: rows and lam0 gathered by perm
    (padding rows stay), the permuted metadata with its groups."""
    row_j, row_s, vel6, lam0, iinv9, inv_mass, meta = random_rows(seed, b)
    s = scheduled(meta)
    full = np.concatenate([s.perm, np.arange(N_ROWS, NR_PAD)])
    return row_j[full], row_s[full], vel6, lam0[full], iinv9, inv_mass, s


def test_grouped_plain_sweep_matches_jax_kernel():
    row_j, row_s, vel6, lam0, iinv9, inv_mass, s = scheduled_rows(5, B)
    out = jsp.solver_sweep_envlast_slim(
        jnp.asarray(row_j), jnp.asarray(row_s), jnp.asarray(vel6), jnp.asarray(lam0),
        jnp.asarray(iinv9), inv_mass, s.idx6_a, s.idx6_b, s.parent, s.mu, 3, N_ROWS,
        kind=s.kind, skip_b=s.skip_b, interpret=True, groups=s.groups,
    )
    args = [torch.as_tensor(x) for x in (row_j, row_s, vel6, lam0, iinv9)]
    grouped = tsp.make_sweep_meta(inv_mass, *s[:6], N_ROWS, "cpu", groups=s.groups,
                                  chunk=s.chunk)
    got = tsp.solver_sweep_envlast_slim(*args, grouped, 3)
    for name, a, b in zip(("vel6", "lam", "push_vel6"), got, out):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0, err_msg=name)
    # under the checked invariant, one row at a time computes the same values
    seq = tsp.solver_sweep_envlast_slim(
        *args, tsp.make_sweep_meta(inv_mass, *s[:6], N_ROWS, "cpu"), 3)
    assert all(torch.equal(a, b) for a, b in zip(seq, got))


def test_make_meta_rejects_groups_that_break_the_invariant():
    """Each broken condition of check_groups raises, in the slim and the
    fat meta alike: a gap, a group over a chunk boundary, two rows of a
    group on one body, a friction row whose parent is not in an earlier
    group."""
    *_, inv_mass, meta = random_rows(6, 2)
    s = scheduled(meta)
    ok = s.groups
    split = [(a, 1) for a in range(N_ROWS)]  # one row a group
    shared = next(r for r in range(N_ROWS - 1)
                  if (r + 1) % 8 and s.idx6_a[r] == s.idx6_a[r + 1])
    friction = int(np.nonzero(s.parent >= 0)[0][0])
    late_parent = s.parent.copy()
    late_parent[friction] = friction + 1  # a parent visited after its child
    cases = {
        "tile": (s.parent, ok[1:]),
        "chunk": (s.parent, sorted([g for g in split if g[0] not in (7, 8)] + [(7, 2)])),
        "body": (s.parent, sorted([g for g in split if g[0] not in (shared, shared + 1)]
                                  + [(shared, 2)])),
        "parent": (late_parent, split),
    }
    for word, (parent, groups) in cases.items():
        rows = (s.idx6_a, s.idx6_b, parent, s.mu, s.kind, s.skip_b)
        with pytest.raises(ValueError, match=word):
            tsp.make_sweep_meta(inv_mass, *rows, N_ROWS, "cpu", groups=groups, chunk=8)
        with pytest.raises(ValueError, match=word):
            tsf.make_fat_meta(*rows, "cpu", groups=groups, chunk=8)
    with pytest.raises(ValueError, match="chunk they were built for"):
        tsp.make_sweep_meta(inv_mass, *s[:6], N_ROWS, "cpu", groups=ok)
    tsp.make_sweep_meta(inv_mass, *s[:6], N_ROWS, "cpu", groups=split, chunk=8)
    tsf.make_fat_meta(*s[:6], "cpu", groups=ok, chunk=8)


# ---------------------------------------------------------------------------
# the CUDA kernel's launch plan (pure Python: it runs here)
# ---------------------------------------------------------------------------

OPTIN = 232_448  # H100: the shared memory one block may opt in to


def spider_shapes():
    """(nb6, n_rows, n_push) of the batched spider step's full sweep."""
    from evomotion_tpu_torch.envs.robot import RobotWalk
    from evomotion_tpu_torch.physics import engine as TE

    m = RobotWalk(device="cpu").model
    fm = TE._solver_meta(m, "full", TE.n_manifold_pairs(m), TE._n_dyn_contacts(m))
    return m.n_bodies * 6, len(fm.idx6_a), int((np.asarray(fm.kind) == tsp.KIND_NORMAL).sum())


@pytest.mark.parametrize("j_bytes", [2, 4])
def test_plan_fits_the_spider_in_one_wave(j_bytes):
    """The spider's rows (bf16 and f32 J) get a plan within the opt-in, of
    16 envs per block: 128 blocks at B=2048, one wave on 132 SMs, rows by
    TMA; the same shapes always give the same plan."""
    nb6, n_rows, n_push = spider_shapes()
    assert (nb6, n_rows, n_push) == (252, 1896, 548)
    pl = tsp.plan(nb6, n_rows, n_rows, n_push, j_bytes, OPTIN)
    assert pl.smem_bytes <= OPTIN and pl.stages >= 2 and pl.threads == 96
    assert pl.envs == 16 and pl.blocks(2048) == 128 and pl.waves(2048, 132) == 1
    assert pl.copy(2048) == "tma"
    assert pl == tsp.plan(nb6, n_rows, n_rows, n_push, j_bytes, OPTIN)
    # resident per env: v and pv (one spare body each), lam of the visited
    # rows, plam, iinv9
    assert 4 * (2 * (nb6 + 6) + n_rows + n_push + 9 * nb6 // 6) == 13_352


@pytest.mark.parametrize("b", [1, 4, 17])
def test_plan_masks_the_last_block(b):
    """A batch that does not fill its last block leaves masked env slots,
    and a stride that TMA cannot take (bf16 J at B not a multiple of 8)
    streams by plain loads."""
    nb6, n_rows, n_push = spider_shapes()
    pl = tsp.plan(nb6, n_rows, n_rows, n_push, 2, OPTIN)
    assert pl.masked(b) > 0 and pl.blocks(b) * pl.envs - pl.masked(b) == b
    assert pl.blocks(b) == -(-b // 16)
    assert pl.copy(b) == "plain"


def test_plan_raises_when_nothing_fits():
    nb6, n_rows, n_push = spider_shapes()
    with pytest.raises(ValueError, match="no launch plan fits"):
        tsp.plan(6 * 4000, n_rows, n_rows, n_push, 2, OPTIN)
    with pytest.raises(ValueError, match="no launch plan fits"):
        tsp.plan(nb6, 60_000, 60_000, n_push, 2, OPTIN)
    with pytest.raises(ValueError, match="bad shapes"):
        tsp.plan(nb6, n_rows - 1, n_rows, n_push, 2, OPTIN)

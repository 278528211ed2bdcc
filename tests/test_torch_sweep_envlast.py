"""The env-last fat-row sweep's plain version against the JAX package's
Pallas kernel ``solver_sweep_envlast`` (TPU kernel #3).

Random fat rows of all three kinds (joint, contact normal with a
split-impulse rhs, friction with a live parent), with and without a static
body B, padded with rows that are not visited, go through the JAX kernel
(interpret mode, as its own tests run it, B = one 1,024-env tile) and the
port (CPU tensors -> the plain version), over 3 solver iterations, at 1e-5
(the sweep tolerance of test_torch_sweep.py). The JAX wrapper takes
``groups`` and its kernel ignores them: the second case shows it, and that
the port, which takes none, matches JAX called with them.

The CUDA kernel itself is held against this plain version on the card by
chip_smoke.py and by test_torch_gpu.py. The last test shows that
chip_smoke.py's check of the kernel (phase 12) fails a kernel that is
wrong in one of a few ways, on both of its input sets, by running
deliberately wrong plain versions through it at B=4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from evomotion_tpu.physics import solver_pallas as jsp
from evomotion_tpu_torch.kernels import sweep_envlast as tse
from evomotion_tpu_torch.kernels.sweep import clamp_impulse, run_groups, visit_row
from test_torch_gpu import random_envlast_rows

B = jsp.TILE  # the JAX kernel's env tile
N_ITERS = 3


def _jax(rows, vel6, lam0, meta, n_rows, groups=None):
    ia, ib, parent, mu, kind, skip = meta
    out = jsp.solver_sweep_envlast(
        jnp.asarray(rows), jnp.asarray(vel6), jnp.asarray(lam0), ia, ib, parent, mu,
        N_ITERS, n_rows, kind=kind, skip_b=skip, interpret=True, groups=groups,
    )
    return [np.asarray(o) for o in out]


def _port(rows, vel6, lam0, meta, n_rows):
    m = tse.make_envlast_meta(*meta, n_rows, "cpu")
    out = tse.solver_sweep_envlast(torch.as_tensor(rows), torch.as_tensor(vel6),
                                   torch.as_tensor(lam0), m, N_ITERS)
    return [o.numpy() for o in out]


def _close(got, ref):
    for name, a, b in zip(("vel6", "lam", "push_vel6"), got, ref):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0, err_msg=name)


def test_plain_envlast_sweep_matches_jax_kernel():
    rows, vel6, lam0, meta, nr = random_envlast_rows(0, B)
    ref = _jax(rows, vel6, lam0, meta, nr)
    got = _port(rows, vel6, lam0, meta, nr)
    _close(got, ref)
    lam = got[1]
    # every row did work, padding rows kept lam0, the push pass moved bodies
    assert (np.abs(lam[:nr] - lam0[:nr]) > 1e-3).mean() > 0.5
    assert np.array_equal(lam[nr:], lam0[nr:])
    assert np.abs(got[2]).max() > 1e-2


def test_jax_kernel_ignores_groups():
    """Groups that would change the result if the kernel applied them (four
    rows on shared bodies in one group) leave JAX's output unchanged, and the
    port, visiting rows one at a time, matches it."""
    rows, vel6, lam0, meta, nr = random_envlast_rows(1, B)
    groups = tuple((s, min(4, nr - s)) for s in range(0, nr, 4))
    ref = _jax(rows, vel6, lam0, meta, nr)
    grouped = _jax(rows, vel6, lam0, meta, nr, groups=groups)
    for a, b in zip(grouped, ref):
        np.testing.assert_array_equal(a, b)
    _close(_port(rows, vel6, lam0, meta, nr), grouped)


def test_envlast_wrapper_rejects_bad_inputs():
    rows, vel6, lam0, meta, nr = random_envlast_rows(2, 4)
    m = tse.make_envlast_meta(*meta, nr, "cpu")
    args = [torch.as_tensor(x) for x in (rows, vel6, lam0)]
    with pytest.raises(TypeError):
        tse.solver_sweep_envlast(args[0].double(), *args[1:], m, 1)
    with pytest.raises(ValueError):
        tse.solver_sweep_envlast(args[0][:, :28], *args[1:], m, 1)
    with pytest.raises(ValueError):
        tse.solver_sweep_envlast(args[0], args[1][:-1], args[2], m, 1)
    with pytest.raises(ValueError):
        tse.solver_sweep_envlast(args[0], args[1], args[2][:-1], m, 1)
    with pytest.raises(ValueError):
        tse.solver_sweep_envlast(args[0][:nr - 1], args[1], args[2][:nr - 1], m, 1)
    with pytest.raises(ValueError):
        tse.solver_sweep_envlast(args[0].transpose(0, 2).contiguous().transpose(0, 2),
                                 *args[1:], m, 1)
    before = tse.KERNEL.launches
    out = tse.solver_sweep_envlast(*args, m, 1)  # CPU: plain version, no launch
    assert tse.KERNEL.launches == before
    assert [tuple(o.shape) for o in out] == [tuple(vel6.shape), tuple(lam0.shape),
                                             tuple(vel6.shape)]


def _wrong_sweep(rows, vel6, lam0, meta, n_iters, fault):
    """sweep_envlast_plain with one fault: the push pass drops body B
    (``push_body_b``), two normal rows share a push slot (``push_slot``),
    the push pass leaves out inv_eff (``push_inv_eff``), or body A's
    velocity update is off by 1e-3 (``vel_update``)."""
    v, lam = vel6.clone(), lam0.clone()
    pv = torch.zeros_like(vel6)
    plam = torch.zeros((meta.n_push, vel6.shape[1]))
    zero = torch.zeros(())

    def visit(r):
        ia6, ib6, kind, parent, skip_b, pslot, mu = meta.rows[r]
        x = rows[r]
        j, dva, dvb = x[0:12], x[12:18], x[18:24]
        ib = None if skip_b else ib6
        stores = visit_row(v, lam, r, j, dva * (1 + 1e-3) if fault == "vel_update" else dva,
                           dvb, ia6, ib, x[24], x[27],
                           lambda c: clamp_impulse(kind, c, x[25], x[26], mu, lam, parent, zero))
        if pslot >= 0:
            stores += visit_row(
                pv, plam, pslot // 2 if fault == "push_slot" else pslot, j, dva, dvb, ia6,
                None if fault == "push_body_b" else ib, x[28],
                torch.ones_like(x[27]) if fault == "push_inv_eff" else x[27],
                lambda c: torch.maximum(c, zero))
        return stores

    for _ in range(n_iters):
        run_groups(None, len(meta.rows), visit)
    return v, lam, pv


@pytest.fixture(scope="module")
def card_check_inputs():
    model, meta, sets = chip_smoke.envlast_inputs(0, 4, torch.device("cpu"))
    refs = {k: tse.sweep_envlast_plain(*inp, meta, model.n_iterations)
            for k, inp in sets.items()}
    return model.n_iterations, meta, sets, refs


@pytest.mark.parametrize("fault", ["push_body_b", "push_slot", "push_inv_eff", "vel_update"])
def test_card_check_fails_a_wrong_sweep(card_check_inputs, fault):
    """chip_smoke.py's phase-12 check, on both its input sets (B=4 here),
    fails a sweep with the fault against the true plain version. On
    prof_step's rows the outputs are small: an absolute 1e-3 alone would
    pass the faults that leave every output within it, which is why the
    check is also relative to each output's size."""
    n_iters, meta, sets, refs = card_check_inputs
    for label, inp in sets.items():
        res = chip_smoke.envlast_errors(_wrong_sweep(*inp, meta, n_iters, fault), refs[label])
        assert not all(ok for *_, ok in res), (label, res)
        if label == "prof_step rows" and fault != "push_inv_eff":
            assert all(err <= chip_smoke.TOL for _, err, _, _ in res), res


# ---------------------------------------------------------------------------
# the CUDA kernel's launch plan (pure Python: it runs here)
# ---------------------------------------------------------------------------

OPTIN = 232_448  # H100: the shared memory one block may opt in to


def _prof_kernel_shapes(case, nr):
    """(nb6, nr_pad, n_rows, n_push) of one prof_kernel case."""
    from evomotion_tpu_torch.tools import prof_kernel

    meta = tse.make_envlast_meta(*prof_kernel.case_meta(case, nr, prof_kernel.BODIES), nr, "cpu")
    return prof_kernel.BODIES * 6, -(-nr // 32) * 32, nr, meta.n_push


def test_plan_fits_prof_step_rows_in_one_wave():
    """prof_step's rows (the spider's full sweep, 1,920 padded rows) get a
    plan of 16 envs per block within the opt-in: 128 blocks at B=2048, one
    wave on 132 SMs, rows by TMA."""
    m, meta, sets = chip_smoke.envlast_inputs(0, 1, torch.device("cpu"))
    rows = sets["prof_step rows"][0]
    pl = tse.plan(m.n_bodies * 6, rows.shape[0], len(meta.rows), meta.n_push, OPTIN)
    assert (rows.shape[0], len(meta.rows), meta.n_push) == (1920, 1896, 548)
    assert pl.smem_bytes <= OPTIN and pl.stages >= 2 and pl.threads == 64
    assert pl.envs == 16 and pl.blocks(2048) == 128 and pl.waves(2048, 132) == 1
    assert pl.copy(2048) == "tma"


@pytest.mark.parametrize("case", ["blocks6", "same", "roundrobin", "contact"])
def test_plan_fits_prof_kernel_2048_rows(case):
    """prof_kernel's cases at 2,048 rows, the largest row sets a caller
    uses, get a plan within the opt-in; the contact case (683 push slots)
    takes 8 envs per block."""
    nb6, nr_pad, nr, n_push = _prof_kernel_shapes(case, 2048)
    pl = tse.plan(nb6, nr_pad, nr, n_push, OPTIN)
    assert pl.smem_bytes <= OPTIN and pl.stages >= 2
    assert pl.envs == (8 if case == "contact" else 16)
    assert pl == tse.plan(nb6, nr_pad, nr, n_push, OPTIN)


@pytest.mark.parametrize("b", [1, 4, 17])
def test_plan_masks_the_last_block(b):
    """A batch that does not fill its last block leaves masked env slots;
    B not a multiple of 4 streams by plain loads."""
    pl = tse.plan(*_prof_kernel_shapes("blocks6", 1024), OPTIN)
    assert pl.masked(b) > 0 and pl.blocks(b) * pl.envs - pl.masked(b) == b
    assert pl.copy(b) == ("tma" if b % 4 == 0 else "plain")


def test_plan_raises_when_nothing_fits():
    with pytest.raises(ValueError, match="no launch plan fits"):
        tse.plan(6 * 8000, 2048, 2048, 683, OPTIN)
    with pytest.raises(ValueError, match="bad shapes"):
        tse.plan(252, 2047, 2048, 683, OPTIN)

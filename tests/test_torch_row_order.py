"""Row visit orders: the port's ``_schedule_rows``, ``_shuffled_order`` and
``_solver_meta`` against the JAX package's, at atol 0.

The orders are numpy on both sides, so the permutation, the groups and the
permuted per-row metadata must be identical: on the contact and dyn-only
models of test_torch_step.py and on the spider's full sweep, for the
``canonical``, ``scheduled`` and ``shuffled:7`` orders. The scheduled
order's groups must keep the invariant the sweeps check
(``kernels.sweep.check_groups``).
"""

import dataclasses

import numpy as np
import pytest

from evomotion_tpu.physics import engine as JE
from evomotion_tpu.physics.robot_compiler import compile_robot as j_compile
from evomotion_tpu.serialize import robot as j_robot
from evomotion_tpu_torch import convert
from evomotion_tpu_torch.envs.robot import DEFAULT_SKELETON
from evomotion_tpu_torch.kernels import sweep as tsp
from evomotion_tpu_torch.physics import engine as TE
from test_torch_step import _contact_model, _dyn_only_model

ORDERS = ["canonical", "scheduled", "shuffled:7"]


def _spider():
    jm, _ = j_compile(j_robot.load(DEFAULT_SKELETON))
    return dataclasses.replace(jm, solver="pallas")


MODELS = {"contact": _contact_model, "dyn_only": _dyn_only_model, "spider": _spider}


@pytest.fixture(scope="module", params=sorted(MODELS))
def model(request):
    return request.param, MODELS[request.param]()


def _metas(jm, order):
    jm = dataclasses.replace(jm, row_order=order)
    tm = convert.model_from_arrays(jm)
    n_pair, n_dyn = JE.n_manifold_pairs(jm), JE._n_dyn_contacts(jm)
    assert (n_pair, n_dyn) == (TE.n_manifold_pairs(tm), TE._n_dyn_contacts(tm))
    return (JE._solver_meta(jm, "full", n_pair, n_dyn),
            TE._solver_meta(tm, "full", n_pair, n_dyn))


@pytest.mark.parametrize("order", ORDERS)
def test_solver_meta_matches_jax(model, order):
    name, jm = model
    j_meta, t_meta = _metas(jm, order)
    for field, a, b in zip(TE.SolverMeta._fields, j_meta, t_meta):
        if field == "groups":
            assert a == b, field
        elif a is None:
            assert b is None, field
        else:
            assert a.dtype == b.dtype and a.shape == b.shape, field
            np.testing.assert_array_equal(a, b, err_msg=field)
    n = len(t_meta.idx6_a)
    if order == "canonical":
        assert t_meta.perm is None and t_meta.groups is None
    else:
        assert sorted(t_meta.perm.tolist()) == list(range(n))
        assert (t_meta.groups is None) == (order != "scheduled")
        if name == "spider":  # the permutation really moves rows
            assert (t_meta.perm != np.arange(n)).mean() > 0.5


def test_schedule_and_shuffle_match_jax(model):
    """The two order functions alone, on the canonical full-sweep rows, at
    the default chunk and at chunk 4."""
    _, jm = model
    c_meta, _ = _metas(jm, "canonical")
    ia, ib, parent, _mu, _kind, skip = c_meta[:6]
    for chunk in (8, 4):
        j_perm, j_groups = JE._schedule_rows(ia, ib, parent, skip, chunk)
        t_perm, t_groups = TE._schedule_rows(ia, ib, parent, skip, chunk)
        np.testing.assert_array_equal(t_perm, j_perm)
        assert t_perm.dtype == j_perm.dtype and t_groups == j_groups
    for seed in (7, 123):
        np.testing.assert_array_equal(TE._shuffled_order(len(ia), parent, seed),
                                      JE._shuffled_order(len(ia), parent, seed))


def test_scheduled_groups_keep_the_invariant(model):
    """The groups tile the rows in order, stay inside 8-row chunks, touch
    pairwise disjoint bodies, and put every friction parent in an earlier
    group: the check the sweeps run passes, on the port's own arithmetic."""
    name, jm = model
    _, t = _metas(jm, "scheduled")
    n = len(t.idx6_a)
    tsp.check_groups(t.groups, t.idx6_a, t.idx6_b, t.parent, t.skip_b, n, 8)
    starts = [s for s, _ in t.groups]
    assert starts == sorted(starts) and sum(z for _, z in t.groups) == n
    assert max(z for _, z in t.groups) <= 8
    if name == "spider":  # the shipped spider's schedule
        sizes = np.bincount([z for _, z in t.groups])
        assert n == 1896 and len(t.groups) == 298
        assert {z: int(c) for z, c in enumerate(sizes) if c} == {
            1: 50, 2: 16, 3: 5, 5: 2, 6: 2, 7: 7, 8: 216}


def test_scheduled_meta_carries_its_chunk(model, monkeypatch):
    """EVOMOTION_PALLAS_CHUNK is read once, when the meta is made: the
    groups match JAX's at that chunk, and make_sweep_meta checks
    them against the chunk the meta carries, not the variable as it stands
    later."""
    _, jm = model
    monkeypatch.setenv("EVOMOTION_PALLAS_CHUNK", "4")
    j_meta, t_meta = _metas(jm, "scheduled")
    assert t_meta.chunk == 4 and t_meta.groups == j_meta[7]
    assert max(z for _, z in t_meta.groups) <= 4
    monkeypatch.setenv("EVOMOTION_PALLAS_CHUNK", "3")
    n = len(t_meta.idx6_a)
    m = tsp.make_sweep_meta(np.ones(n * 6), *t_meta[:6], n, "cpu", groups=t_meta.groups,
                            chunk=t_meta.chunk)
    assert m.groups == t_meta.groups
    if any(s // 3 != (s + z - 1) // 3 for s, z in t_meta.groups):
        with pytest.raises(ValueError, match="chunk"):  # the same groups in 3-row chunks
            tsp.make_sweep_meta(np.ones(n * 6), *t_meta[:6], n, "cpu", groups=t_meta.groups,
                                chunk=3)


def test_strict_and_push_keep_canonical_order():
    jm = dataclasses.replace(_contact_model(), row_order="scheduled")
    tm = convert.model_from_arrays(jm)
    n_pair, n_dyn = TE.n_manifold_pairs(tm), TE._n_dyn_contacts(tm)
    assert TE._solver_meta(tm, "push", n_pair, n_dyn).perm is None
    strict = dataclasses.replace(tm, strict_bullet=True)
    assert TE._solver_meta(strict, "full", n_pair, n_dyn).perm is None
    with pytest.raises(ValueError, match="row_order"):
        TE._solver_meta(dataclasses.replace(tm, row_order="sorted"), "full", n_pair, n_dyn)

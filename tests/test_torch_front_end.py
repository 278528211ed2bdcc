"""The port's own copies of the numpy front end against the JAX package's.

The port keeps copies of the robot codec, shape library, model builder,
robot compiler and mt19937 stream (it may import no module of the JAX
package). Compiling the spider with both must give the same arrays: the
same numpy code, so integers exactly and floats at atol=0. The host-side
tables the batched step derives from the model (static face planes, hull
edge directions, per-row bodies, sweep metadata) must match too.
"""

import dataclasses

import numpy as np
import pytest

from evomotion_tpu.physics import engine as JE
from evomotion_tpu.physics.robot_compiler import compile_robot as j_compile
from evomotion_tpu.serialize import robot as j_robot
from evomotion_tpu.utils.mt19937 import reset_draw_table as j_table
from evomotion_tpu_torch.envs.robot import DEFAULT_SKELETON
from evomotion_tpu_torch.physics import engine as TE
from evomotion_tpu_torch.physics.robot_compiler import compile_robot as t_compile
from evomotion_tpu_torch.serialize import robot as t_robot
from evomotion_tpu_torch.utils.mt19937 import reset_draw_table as t_table


def _same(a, b, what):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    elif isinstance(a, tuple) and a and isinstance(a[0], (np.ndarray, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}[{i}]")
    else:
        assert a == b, what


@pytest.fixture(scope="module")
def spiders():
    jm, jmeta = j_compile(j_robot.load(DEFAULT_SKELETON))
    tm, tmeta = t_compile(t_robot.load(DEFAULT_SKELETON))
    return jm, jmeta, tm, tmeta


def test_spider_compiles_to_the_same_model(spiders):
    jm, jmeta, tm, tmeta = spiders
    assert [f.name for f in dataclasses.fields(jm)] == [f.name for f in dataclasses.fields(tm)]
    for f in dataclasses.fields(jm):
        _same(getattr(jm, f.name), getattr(tm, f.name), f.name)
    for f in dataclasses.fields(jmeta):
        _same(getattr(jmeta, f.name), getattr(tmeta, f.name), f.name)
    # shipped defaults of the slice's path
    assert tm.row_order == "canonical" and tm.row_dtype == "bf16"
    assert tm.member_topm == 48 and tm.n_rows == 252 and tmeta.obs_dim == 371


def test_resources_are_byte_copies():
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    for rel in ("resources/skeleton/spider.json", "resources/hulls/feet.npy"):
        a = (root / "evomotion_tpu" / rel).read_bytes()
        b = (root / "evomotion_tpu_torch" / rel).read_bytes()
        assert a == b, rel


def test_row_schedule_env_flag_sets_row_order(monkeypatch, spiders):
    """finalize()'s rule: canonical unless EVOMOTION_ROW_SCHEDULE=1; the
    flag's scheduled order gives the port the JAX package's permutation and
    groups."""
    monkeypatch.setenv("EVOMOTION_ROW_SCHEDULE", "1")
    tm, _ = t_compile(t_robot.load(DEFAULT_SKELETON))
    jm, _ = j_compile(j_robot.load(DEFAULT_SKELETON))
    assert tm.row_order == jm.row_order == "scheduled"
    n_pair, n_dyn = TE.n_manifold_pairs(tm), TE._n_dyn_contacts(tm)
    t_meta = TE._solver_meta(tm, "full", n_pair, n_dyn)
    j_meta = JE._solver_meta(jm, "full", n_pair, n_dyn)
    np.testing.assert_array_equal(t_meta.perm, j_meta[6])
    assert t_meta.groups == j_meta[7] and len(t_meta.groups) == 298


def test_host_tables_match(spiders):
    jm, _, tm, _ = spiders
    for a, b in zip(JE._static_face_planes(jm), TE._static_face_planes(tm)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(JE._get_hull_edges(jm), TE._get_hull_edges(tm)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(JE._static_row_bodies(jm), TE._static_row_bodies(tm)):
        np.testing.assert_array_equal(a, b)
    n_pair, n_dyn = JE.n_manifold_pairs(jm), JE._n_dyn_contacts(jm)
    assert (n_pair, n_dyn) == (TE.n_manifold_pairs(tm), TE._n_dyn_contacts(tm)) == (17, 480)
    for kind, n_rows in (("full", 1896), ("push", 548)):
        j_meta = JE._solver_meta(jm, kind, n_pair, n_dyn)
        t_meta = TE._solver_meta(tm, kind, n_pair, n_dyn)
        assert j_meta[6] is None and j_meta[7] is None  # canonical: no perm, no groups
        for a, b in zip(j_meta[:6], t_meta):
            np.testing.assert_array_equal(a, b, err_msg=kind)
        assert len(t_meta.idx6_a) == n_rows


def test_mt19937_reset_table_matches():
    np.testing.assert_array_equal(j_table(1234, 3, 64), t_table(1234, 3, 64))


@pytest.mark.parametrize("rel", ["serialize/legacy.py", "viewer/js_core.py",
                                 "viewer/html_viewer.py", "viewer/render3d.py",
                                 "builder/builder_env.py"])
def test_numpy_only_copies_match_their_originals(rel):
    """The port's copies of numpy-only modules are the originals' code: the
    same syntax tree once the module docstrings (which name the copy) are
    dropped."""
    import ast
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]

    def body(pkg):
        tree = ast.parse((root / pkg / rel).read_text())
        if ast.get_docstring(tree) is not None:
            tree.body = tree.body[1:]
        return ast.dump(tree)

    assert body("evomotion_tpu_torch") == body("evomotion_tpu")

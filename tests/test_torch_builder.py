"""The port's robot-builder environment against the JAX package's.

The scenarios of tests/test_builder.py, each run through both packages'
``RobotBuilderEnvironment`` with the same operations: every return value
equal, the saved robot JSON equal as text, and the compiled PhysicsModel
and RobotMeta equal at atol 0 (the same numpy code on both sides).
"""

import dataclasses

import numpy as np
import pytest

from evomotion_tpu.builder.builder_env import RobotBuilderEnvironment as JB
from evomotion_tpu_torch.builder.builder_env import RobotBuilderEnvironment as TB
from test_torch_front_end import _same

IDENT = np.array([0.0, 0.0, 0.0, 1.0], np.float32)


def _two_member(cls):
    b = cls("bot")
    r = [b.add_member("torso", "cube", (0, 1, 0), IDENT, (0.5, 0.2, 0.3), 2.0, 0.5),
         b.add_member("leg", "cube", (0.5, 0.5, 0), IDENT, (0.1, 0.4, 0.1), 0.5, 0.5),
         b.set_root("torso"),
         b.attach_hinge_constraint("hip", "torso", "leg", (0.5, 1.0, 0.0), (0, 0, 1), -0.5,
                                   0.5)]
    return b, r


def _bfs(b):
    return [b.update_member("torso", new_pos=(1.0, 1.0, 0.0)),
            b.get_member_transform("leg"), b.get_constraint_hinge_info("hip")]


def _rules(b):
    return [b.add_member("torso", "cube", (0, 0, 0), IDENT, (1, 1, 1), 1, 0.5),
            b.attach_hinge_constraint("hip", "torso", "leg", (0, 0, 0), (0, 0, 1)),
            b.update_member("nope", new_pos=(0, 0, 0)), b.remove_member("nope")]


def _rename_remove(b):
    return [b.rename_member("leg", "left_leg"), b.member_exists("left_leg"),
            b.get_constraint_members("hip"), b.remove_member("left_leg"),
            b.constraint_exists("hip"), b.get_members_count()]


def _clone(b):
    return [b.clone_body_part("leg", "c", (0.5, 0.5, 0.4), IDENT),
            b.get_member_transform("c_leg"), b.get_member_names()]


def _muscles(b):
    return [b.add_muscle("m0", "torso", "leg", (0.4, 0, 0), (0, 0.3, 0)),
            b.add_muscle("m0", "torso", "leg", (0, 0, 0), (0, 0, 0)),
            b.update_member("leg", new_rot=(0.0, 0.38268343, 0.0, 0.92387953), new_mass=0.7,
                            new_friction=0.3)]


def _ray_cast(b):
    return [b.ray_cast_member((0, 3, 0), (0, -1, 0)),
            b.ray_cast_member((10, 3, 10), (10, 2, 10)),
            b.ray_cast_constraint((0.5, 3.0, 0.0), (0.5, -1.0, 0.0))]


SCENARIOS = {"bfs_propagation": _bfs, "duplicate_rules": _rules,
             "rename_remove": _rename_remove, "clone": _clone, "muscles": _muscles,
             "ray_cast": _ray_cast}


def _equal(a, b, what):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=what)
    else:
        assert a == b, what


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_builder_ops_match_jax(name, tmp_path):
    (jb, jr), (tb, tr) = _two_member(JB), _two_member(TB)
    _equal(tr, jr, "setup")
    _equal(SCENARIOS[name](tb), SCENARIOS[name](jb), name)
    jp, tp = tmp_path / "jax.json", tmp_path / "torch.json"
    jb.save_robot(str(jp))
    tb.save_robot(str(tp))
    assert tp.read_text() == jp.read_text()
    # a saved robot loads back into the other package's builder unchanged
    back = TB()
    back.load_robot(str(jp))
    back.save_robot(str(tmp_path / "back.json"))
    assert (tmp_path / "back.json").read_text() == jp.read_text()


def test_builder_compiles_to_the_same_model():
    (jb, _), (tb, _) = _two_member(JB), _two_member(TB)
    for b in (jb, tb):
        b.add_muscle("m0", "torso", "leg", (0.4, 0, 0), (0, 0.3, 0))
    jm, jmeta = jb.compile()
    tm, tmeta = tb.compile()
    assert type(tm).__module__.startswith("evomotion_tpu_torch.")
    assert tm.n_hinge == 1 and tm.n_slider == 1 and tm.n_p2p == 2
    for f in dataclasses.fields(jm):
        _same(getattr(jm, f.name), getattr(tm, f.name), f.name)
    for f in dataclasses.fields(jmeta):
        _same(getattr(jmeta, f.name), getattr(tmeta, f.name), f.name)

"""The port's legacy tree-skeleton converter against the JAX package's.

The JAX test (tests/test_legacy_convert.py) needs the reference's old spider
asset, which is not in the repo. So this test writes a small tree skeleton
of its own (a root with two levels of children, hinge and fixed
constraints, nonzero rotate-around-point angles, option blocks, a limit
past pi, a muscle), runs it through both converters and holds the two
output JSON files equal as text; the output also loads in both packages'
robot loaders to the same skeleton.
"""

import json

import numpy as np

from evomotion_tpu.serialize import robot as j_robot
from evomotion_tpu.serialize.legacy import (
    convert_tree_skeleton_to_graph_skeleton as j_convert,
)
from evomotion_tpu_torch.serialize import robot as t_robot
from evomotion_tpu_torch.serialize.legacy import (
    convert_tree_skeleton_to_graph_skeleton as t_convert,
)


def _xyz(x, y, z):
    return {"x": x, "y": y, "z": z}


def _tr(t, point, axis, deg):
    return {"translation": _xyz(*t),
            "rotation": {"point": _xyz(*point), "axis": _xyz(*axis), "angle_degree": deg}}


def _member(name, shape, scale, mass, tr, children=(), option=None):
    m = {"name": name, "shape": shape, "scale": _xyz(*scale), "mass": mass,
         "transformation": tr, "children": list(children)}
    if option is not None:
        m["option"] = option
    return m


def _hinge(child, lo, hi, deg):
    return {"constraint_type": "hinge", "child_member": child,
            "frame_in_parent": _tr((0.5, 0.0, 0.1), (0, 0, 0), (0, 1, 0), deg),
            "frame_in_child": _tr((-0.4, 0.05, 0.0), (0.1, 0, 0), (1, 0, 0), -deg / 2),
            "limit_degree": {"min": lo, "max": hi}}


def _fixed(child):
    return {"constraint_type": "fixed", "child_member": child,
            "attach_in_parent": _tr((0.0, -0.3, 0.2), (0, 0.1, 0), (0, 0, 1), 30.0),
            "attach_in_child": _tr((0.0, 0.2, 0.0), (0, 0, 0), (1, 1, 0), 15.0)}


def tree_skeleton():
    foot = _member("foot", "feet", (0.2, 0.1, 0.3), 0.5,
                   _tr((0.1, -0.7, 0.0), (0.0, 0.35, 0.0), (1, 0, 0), 25.0),
                   option={"friction": 0.9})
    leg_a = _member("legA", "cube", (0.5, 0.1, 0.1), 1.0,
                    _tr((0.8, 0.0, 0.3), (-0.5, 0.0, 0.0), (0, 0, 1), -40.0),
                    children=[_hinge(foot, -30.0, 200.0, 12.0)])
    leg_b = _member("legB", "cylinder", (0.1, 0.4, 0.1), 0.75,
                    _tr((-0.8, 0.1, -0.2), (0.0, 0.2, 0.0), (1, 0, 1), 60.0),
                    option={"ignore_collision": True})
    head = _member("head", "sphere", (0.2, 0.2, 0.2), 0.3,
                   _tr((0.0, 0.5, 0.6), (0, 0, 0), (0, 1, 0), 90.0),
                   option={"friction": 0.2, "ignore_collision": True})
    body = _member("body", "cube", (1.0, 0.3, 0.6), 5.0,
                   _tr((0.0, 1.0, 0.0), (0.2, 0.0, 0.1), (0, 1, 0), 15.0),
                   children=[_hinge(leg_a, -90.0, 45.0, 0.0), _hinge(leg_b, 10.0, 270.0, 35.0),
                             _fixed(head)])
    muscle = {"name": "m0", "item_a": "body", "item_b": "body_legA", "attach_mass": 0.1,
              "attach_scale": _xyz(0.05, 0.05, 0.05), "pos_in_a": _xyz(0.3, 0.1, 0.0),
              "pos_in_b": _xyz(-0.2, 0.0, 0.05), "force": 40.0, "speed": 6.0}
    return {"robot_name": "tree_bot", "skeleton": body, "muscles": [muscle]}


def test_converters_write_the_same_json(tmp_path):
    src = tmp_path / "tree.json"
    src.write_text(json.dumps(tree_skeleton()))
    j_out, t_out = tmp_path / "jax.json", tmp_path / "torch.json"
    j_convert(str(src), str(j_out))
    t_convert(str(src), str(t_out))
    text = t_out.read_text()
    assert text == j_out.read_text()
    data = json.loads(text)
    assert data["root_name"] == "body" and data["robot_name"] == "tree_bot"
    assert [m["name"] for m in data["members"]] == [
        "body", "body_legA", "body_legB", "body_head", "body_legA_foot"]
    assert [c["type"] for c in data["constraints"]] == ["hinge", "hinge", "fixed", "hinge"]

    a, b = j_robot.load(str(j_out)), t_robot.load(str(t_out))
    assert [m.name for m in a.members] == [m.name for m in b.members]
    for m1, m2 in zip(a.members, b.members):
        for f in ("translation", "rotation", "scale"):
            np.testing.assert_array_equal(getattr(m1, f), getattr(m2, f))
        assert (m1.mass, m1.friction, m1.ignore_collision) == (
            m2.mass, m2.friction, m2.ignore_collision)
    assert [c.name for c in a.constraints] == [c.name for c in b.constraints]
    # the 270 degree limit wraps past pi, as _convert.cpp does
    assert b.constraints[1].limit_max < 0.0

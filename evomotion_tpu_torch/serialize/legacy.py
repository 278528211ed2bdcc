"""Legacy tree-skeleton JSON -> graph-skeleton converter.

Port copy of ``evomotion_tpu/serialize/legacy.py`` (numpy only): the port
keeps its own copy so that it imports no module of the JAX package; keep the
two in step (tests/test_torch_legacy.py holds their output equal as text).

Reference: src/_convert.cpp (convert_tree_skeleton_to_graph_skeleton, run at
gui startup with a hardcoded path; mirrored by
evo_motion_model/notebooks/conversion_json.ipynb). Behavior preserved:

- the old format nests members as a tree with per-member local
  "transformation" blocks (translation + rotate-around-point axis/angle in
  degrees); world transforms accumulate down the tree and are re-decomposed
  into absolute translation/rotation for the graph format;
- member names concatenate the path with '_' (body -> body_legA -> ...);
- constraints are renamed constraint_<i>; hinge limits converted deg->rad
  and wrapped into (-pi, pi]; the hinge axis is taken from the parent frame's
  third column, normalized in world, and re-expressed in both bodies;
- floats are rounded to 5 fractional binary digits before bit-string
  encoding (_convert.cpp:40-53) — the old format's coordinates are coarse.
"""

from __future__ import annotations

import json
import math

import numpy as np

from ..physics.model import _mat3_to_quat
from .codec import float_to_binary_string


def _round5(f: float) -> float:
    return round(f * 32.0) / 32.0


def _fb(f: float) -> str:
    return float_to_binary_string(np.float32(_round5(float(f))))


def _vec3(v) -> dict:
    return {"x": _fb(v[0]), "y": _fb(v[1]), "z": _fb(v[2])}


def _quat(q) -> dict:
    return {"x": _fb(q[0]), "y": _fb(q[1]), "z": _fb(q[2]), "w": _fb(q[3])}


def _rotation_matrix(axis, angle):
    axis = np.asarray(axis, float)
    n = np.linalg.norm(axis)
    axis = axis / n if n > 1e-12 else axis
    x, y, z = axis
    c, s = math.cos(angle), math.sin(angle)
    t = 1 - c
    return np.array(
        [
            [t * x * x + c, t * x * y - s * z, t * x * z + s * y],
            [t * x * y + s * z, t * y * y + c, t * y * z - s * x],
            [t * x * z - s * y, t * y * z + s * x, t * z * z + c],
        ]
    )


def _to_mat4(tr_json: dict) -> np.ndarray:
    """Old transformation block -> 4x4 (translate * rotate-around-point)."""
    pos = np.array(
        [tr_json["translation"][k] for k in ("x", "y", "z")], dtype=float
    )
    rot = tr_json["rotation"]
    point = np.array([rot["point"][k] for k in ("x", "y", "z")], dtype=float)
    axis = np.array([rot["axis"][k] for k in ("x", "y", "z")], dtype=float)
    angle = math.pi * float(rot["angle_degree"]) / 180.0

    m = np.eye(4)
    m[:3, :3] = _rotation_matrix(axis, angle)
    # translate_to_position * translate_back * R * translate_to_origin
    m[:3, 3] = point - m[:3, :3] @ point + pos
    return m


def _decompose(m: np.ndarray):
    pos = m[:3, 3]
    basis = m[:3, :3]
    scale = np.linalg.norm(basis, axis=0)
    rot = basis / np.maximum(scale[None, :], 1e-12)
    return pos, _mat3_to_quat(rot), scale


def _wrap_angle(deg: float) -> float:
    rad = float(deg) * math.pi / 180.0
    if rad > math.pi:
        rad -= 2.0 * math.pi
    return rad


def convert_tree_skeleton_to_graph_skeleton(
    input_path: str, output_path: str, robot_name: str = "converted_robot"
) -> None:
    with open(input_path) as f:
        robot_data = json.load(f)

    queue = [(robot_data["skeleton"], np.eye(4), [], None)]
    members, constraints = [], []
    root_name = None

    while queue:
        curr, parent_mat, parent_names, constraint = queue.pop(0)
        curr_mat = parent_mat @ _to_mat4(curr["transformation"])
        pos, quat, _ = _decompose(curr_mat)
        names = parent_names + [curr["name"]]
        full_name = "_".join(names)
        if root_name is None:
            root_name = full_name

        friction, ignore_col = 0.5, False
        option = curr.get("option", {})
        friction = option.get("friction", friction)
        ignore_col = option.get("ignore_collision", ignore_col)

        members.append(
            {
                "name": full_name,
                "mass": _fb(curr["mass"]),
                "shape": curr["shape"],
                "scale": _vec3([curr["scale"][k] for k in ("x", "y", "z")]),
                "rotation": _quat(quat),
                "translation": _vec3(pos),
                "friction": _fb(friction),
                "ignore_collision": bool(ignore_col),
            }
        )

        if constraint is not None:
            ctype = constraint["constraint_type"]
            parent_full = "_".join(parent_names)
            new_c = {
                "name": f"constraint_{len(constraints)}",
                "parent_name": parent_full,
                "child_name": full_name,
                "type": ctype,
            }
            if ctype == "hinge":
                frame_in_parent = _to_mat4(constraint["frame_in_parent"])
                frame_in_child = _to_mat4(constraint["frame_in_child"])
                new_c["limit_radian"] = {
                    "min": _fb(_wrap_angle(constraint["limit_degree"]["min"])),
                    "max": _fb(_wrap_angle(constraint["limit_degree"]["max"])),
                }
                new_c["pivot_in_parent"] = _vec3(frame_in_parent[:3, 3])
                new_c["pivot_in_child"] = _vec3(frame_in_child[:3, 3])
                # axis = third column of the parent frame; normalize in world
                # (glm's m[2] is the third column)
                axis = frame_in_parent[:3, 2]
                axis_world = parent_mat[:3, :3] @ axis
                axis_world = axis_world / max(np.linalg.norm(axis_world), 1e-12)
                axis_in_parent = np.linalg.inv(parent_mat)[:3, :3] @ axis_world
                axis_in_child = np.linalg.inv(curr_mat)[:3, :3] @ axis_world
                new_c["axis_in_parent"] = _vec3(axis_in_parent)
                new_c["axis_in_child"] = _vec3(axis_in_child)
            elif ctype == "fixed":
                pp, pq, _ = _decompose(_to_mat4(constraint["attach_in_parent"]))
                cp, cq, _ = _decompose(_to_mat4(constraint["attach_in_child"]))
                new_c["frame_in_parent"] = {"translation": _vec3(pp), "rotation": _quat(pq)}
                new_c["frame_in_child"] = {"translation": _vec3(cp), "rotation": _quat(cq)}
            else:
                raise ValueError(f"unknown constraint type {ctype!r}")
            constraints.append(new_c)

        for child_constraint in curr.get("children", []):
            queue.append((child_constraint["child_member"], curr_mat, names, child_constraint))

    muscles = [
        {
            "name": m["name"],
            "item_a": m["item_a"],
            "item_b": m["item_b"],
            "attach_mass": _fb(m["attach_mass"]),
            "attach_scale": _vec3([m["attach_scale"][k] for k in ("x", "y", "z")]),
            "pos_in_a": _vec3([m["pos_in_a"][k] for k in ("x", "y", "z")]),
            "pos_in_b": _vec3([m["pos_in_b"][k] for k in ("x", "y", "z")]),
            "force": _fb(m["force"]),
            "speed": _fb(m["speed"]),
        }
        for m in robot_data.get("muscles", [])
    ]

    out = {
        "robot_name": robot_data.get("robot_name", robot_name),
        "root_name": root_name,
        "members": members,
        "constraints": constraints,
        "muscles": muscles,
    }
    with open(output_path, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)

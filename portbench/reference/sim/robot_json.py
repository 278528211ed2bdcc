"""Robot skeleton (de)serialization — the graph JSON format.

Port copy of ``evomotion_tpu/serialize/robot.py`` (numpy only): the port keeps
its own copy so that it imports no module of the JAX package; keep the two
in step (tests/test_torch_front_end.py compares them).

Mirrors the reference's skeleton persistence exactly at the format level so
robots round-trip between the two frameworks:
- every float is a 32-char IEEE-754 bit string (json_serializer.cpp:67-69)
- members: name/shape/translation/rotation/scale/mass/friction/ignore_collision
  (robot/member.cpp:35-41 deserializing ctor)
- constraints: typed "hinge" (pivots+axes+limit_radian) or "fixed"
  (frame translation+rotation) (robot/constraint.cpp:71-81,151-168)
- muscles: attach_mass/attach_scale/item_a/item_b/pos_in_a/pos_in_b/force/speed
  (robot/muscle.cpp:71-81)
- top level: robot_name, root_name, members, constraints, muscles
  (robot/skeleton.cpp:27-53)
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

import numpy as np

from .codec import binary_string_to_float, float_to_binary_string


@dataclasses.dataclass
class MemberSpec:
    name: str
    shape: str  # sphere | cube | cylinder | feet
    translation: np.ndarray  # [3]
    rotation: np.ndarray  # quat xyzw
    scale: np.ndarray  # [3]
    mass: float
    friction: float
    ignore_collision: bool


@dataclasses.dataclass
class HingeSpec:
    name: str
    parent_name: str
    child_name: str
    pivot_in_parent: np.ndarray
    pivot_in_child: np.ndarray
    axis_in_parent: np.ndarray
    axis_in_child: np.ndarray
    limit_min: float
    limit_max: float


@dataclasses.dataclass
class FixedSpec:
    name: str
    parent_name: str
    child_name: str
    frame_in_parent_pos: np.ndarray
    frame_in_parent_quat: np.ndarray
    frame_in_child_pos: np.ndarray
    frame_in_child_quat: np.ndarray


@dataclasses.dataclass
class MuscleSpec:
    name: str
    attach_mass: float
    attach_scale: np.ndarray
    item_a: str
    item_b: str
    pos_in_a: np.ndarray
    pos_in_b: np.ndarray
    force: float
    speed: float


@dataclasses.dataclass
class SkeletonSpec:
    robot_name: str
    root_name: str
    members: list[MemberSpec]
    constraints: list[HingeSpec | FixedSpec]
    muscles: list[MuscleSpec]

    def member(self, name: str) -> MemberSpec:
        for m in self.members:
            if m.name == name:
                return m
        raise KeyError(f'Member "{name}" not found')


def _read_f(obj: Any) -> float:
    return binary_string_to_float(obj)


def _read_vec3(obj: dict) -> np.ndarray:
    return np.array([_read_f(obj["x"]), _read_f(obj["y"]), _read_f(obj["z"])], dtype=np.float32)


def _read_quat(obj: dict) -> np.ndarray:
    return np.array(
        [_read_f(obj["x"]), _read_f(obj["y"]), _read_f(obj["z"]), _read_f(obj["w"])],
        dtype=np.float32,
    )


def _write_vec3(v) -> dict:
    return {
        "x": float_to_binary_string(float(v[0])),
        "y": float_to_binary_string(float(v[1])),
        "z": float_to_binary_string(float(v[2])),
    }


def _write_quat(q) -> dict:
    return {
        "x": float_to_binary_string(float(q[0])),
        "y": float_to_binary_string(float(q[1])),
        "z": float_to_binary_string(float(q[2])),
        "w": float_to_binary_string(float(q[3])),
    }


def loads(text: str) -> SkeletonSpec:
    d = json.loads(text)
    members = [
        MemberSpec(
            name=m["name"],
            shape=m["shape"],
            translation=_read_vec3(m["translation"]),
            rotation=_read_quat(m["rotation"]),
            scale=_read_vec3(m["scale"]),
            mass=_read_f(m["mass"]),
            friction=_read_f(m["friction"]),
            ignore_collision=bool(m["ignore_collision"]),
        )
        for m in d["members"]
    ]
    constraints: list[HingeSpec | FixedSpec] = []
    for c in d["constraints"]:
        if c["type"] == "hinge":
            constraints.append(
                HingeSpec(
                    name=c["name"],
                    parent_name=c["parent_name"],
                    child_name=c["child_name"],
                    pivot_in_parent=_read_vec3(c["pivot_in_parent"]),
                    pivot_in_child=_read_vec3(c["pivot_in_child"]),
                    axis_in_parent=_read_vec3(c["axis_in_parent"]),
                    axis_in_child=_read_vec3(c["axis_in_child"]),
                    limit_min=_read_f(c["limit_radian"]["min"]),
                    limit_max=_read_f(c["limit_radian"]["max"]),
                )
            )
        elif c["type"] == "fixed":
            constraints.append(
                FixedSpec(
                    name=c["name"],
                    parent_name=c["parent_name"],
                    child_name=c["child_name"],
                    frame_in_parent_pos=_read_vec3(c["frame_in_parent"]["translation"]),
                    frame_in_parent_quat=_read_quat(c["frame_in_parent"]["rotation"]),
                    frame_in_child_pos=_read_vec3(c["frame_in_child"]["translation"]),
                    frame_in_child_quat=_read_quat(c["frame_in_child"]["rotation"]),
                )
            )
        else:
            raise ValueError(f"Unknown constraint type: {c['type']}")
    muscles = [
        MuscleSpec(
            name=m["name"],
            attach_mass=_read_f(m["attach_mass"]),
            attach_scale=_read_vec3(m["attach_scale"]),
            item_a=m["item_a"],
            item_b=m["item_b"],
            pos_in_a=_read_vec3(m["pos_in_a"]),
            pos_in_b=_read_vec3(m["pos_in_b"]),
            force=_read_f(m["force"]),
            speed=_read_f(m["speed"]),
        )
        for m in d["muscles"]
    ]
    return SkeletonSpec(
        robot_name=d["robot_name"],
        root_name=d["root_name"],
        members=members,
        constraints=constraints,
        muscles=muscles,
    )


def dumps(spec: SkeletonSpec) -> str:
    members = [
        {
            "name": m.name,
            "shape": m.shape,
            "translation": _write_vec3(m.translation),
            "rotation": _write_quat(m.rotation),
            "scale": _write_vec3(m.scale),
            "mass": float_to_binary_string(m.mass),
            "friction": float_to_binary_string(m.friction),
            "ignore_collision": m.ignore_collision,
        }
        for m in spec.members
    ]
    constraints = []
    for c in spec.constraints:
        if isinstance(c, HingeSpec):
            constraints.append(
                {
                    "type": "hinge",
                    "name": c.name,
                    "parent_name": c.parent_name,
                    "child_name": c.child_name,
                    "pivot_in_parent": _write_vec3(c.pivot_in_parent),
                    "pivot_in_child": _write_vec3(c.pivot_in_child),
                    "axis_in_parent": _write_vec3(c.axis_in_parent),
                    "axis_in_child": _write_vec3(c.axis_in_child),
                    "limit_radian": {
                        "min": float_to_binary_string(c.limit_min),
                        "max": float_to_binary_string(c.limit_max),
                    },
                }
            )
        else:
            constraints.append(
                {
                    "type": "fixed",
                    "name": c.name,
                    "parent_name": c.parent_name,
                    "child_name": c.child_name,
                    "frame_in_parent": {
                        "translation": _write_vec3(c.frame_in_parent_pos),
                        "rotation": _write_quat(c.frame_in_parent_quat),
                    },
                    "frame_in_child": {
                        "translation": _write_vec3(c.frame_in_child_pos),
                        "rotation": _write_quat(c.frame_in_child_quat),
                    },
                }
            )
    muscles = [
        {
            "name": m.name,
            "attach_mass": float_to_binary_string(m.attach_mass),
            "attach_scale": _write_vec3(m.attach_scale),
            "item_a": m.item_a,
            "item_b": m.item_b,
            "pos_in_a": _write_vec3(m.pos_in_a),
            "pos_in_b": _write_vec3(m.pos_in_b),
            "force": float_to_binary_string(m.force),
            "speed": float_to_binary_string(m.speed),
        }
        for m in spec.muscles
    ]
    return json.dumps(
        {
            "robot_name": spec.robot_name,
            "root_name": spec.root_name,
            "members": members,
            "constraints": constraints,
            "muscles": muscles,
        },
        indent=1,
        sort_keys=True,
    )


def load(path: str) -> SkeletonSpec:
    with open(path) as f:
        return loads(f.read())


def save(path: str, spec: SkeletonSpec) -> None:
    with open(path, "w") as f:
        f.write(dumps(spec))

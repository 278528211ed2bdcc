"""Skeleton -> PhysicsModel compiler.

Port copy of ``evomotion_tpu/physics/robot_compiler.py`` (numpy only): the port keeps
its own copy so that it imports no module of the JAX package; keep the two
in step (tests/test_torch_front_end.py compares them).

Reference equivalent: Skeleton's deserializing constructor wiring Members,
Hinge/Fixed constraints and Muscles into a Bullet world
(evo_motion_model/src/robot/skeleton.cpp:27-53, muscle.cpp:14-67,
constraint.cpp:52-170, env/robot_walk.cpp:17-46). Here the same graph is
compiled once into flat arrays plus metadata the env layer needs for
observations and actuation.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .robot_json import FixedSpec, HingeSpec, SkeletonSpec
from . import shapes
from .model import ModelBuilder, PhysicsModel


@dataclasses.dataclass(frozen=True)
class RobotMeta:
    """Observation/actuation metadata for a compiled robot."""

    floor_body: int
    root_body: int
    member_bodies: tuple[int, ...]  # in JSON order (includes root)
    non_root_bodies: tuple[int, ...]  # JSON order minus root (state order)
    muscle_sliders: tuple[int, ...]  # slider index per muscle, muscle order
    muscle_p2p_a: tuple[int, ...]  # p2p index anchoring attach_a, per muscle
    muscle_p2p_b: tuple[int, ...]
    muscle_speed: np.ndarray  # [M] max_speed (target vel = action * speed)
    n_muscles: int
    obs_dim: int
    action_dim: int
    initial_floor_touch: np.ndarray  # [NB] the ctor-time contactPairTest flag


def compile_robot(
    spec: SkeletonSpec,
    floor_pos=(0.0, -2.0, 2.0),
    floor_scale=(1000.0, 1.0, 1000.0),
    floor_friction: float = 0.5,
) -> tuple[PhysicsModel, RobotMeta]:
    """Build the physics scene of one robot env.

    The floor is the 1000x1x1000 static cube at (0,-2,2) with friction 0.5
    (robot_walk.cpp:22-32)."""
    b = ModelBuilder()

    cube = shapes.get_shape(shapes.CUBE).hull_verts
    floor = b.add_body(
        "base", cube, floor_scale, 0.0, np.asarray(floor_pos, float), (0, 0, 0, 1),
        friction=floor_friction,
    )

    member_idx: dict[str, int] = {}
    for m in spec.members:
        hull = shapes.get_shape(m.shape).hull_verts
        member_idx[m.name] = b.add_body(
            m.name, hull, m.scale, m.mass, m.translation, m.rotation,
            friction=m.friction, no_contact=m.ignore_collision,
        )

    for c in spec.constraints:
        pa = member_idx[c.parent_name]
        ch = member_idx[c.child_name]
        b.set_ignore_collision(pa, ch)  # constraint.cpp:63,145
        if isinstance(c, HingeSpec):
            b.add_hinge(
                pa, ch, c.pivot_in_parent, c.pivot_in_child,
                c.axis_in_parent, c.axis_in_child, c.limit_min, c.limit_max,
            )
        elif isinstance(c, FixedSpec):
            b.add_fixed(
                pa, ch, c.frame_in_parent_pos, c.frame_in_parent_quat,
                c.frame_in_child_pos, c.frame_in_child_quat,
            )

    # muscles (muscle.cpp:14-67): two no-contact sphere attach bodies placed at
    # member_transform * pos_in_X, a slider between them (identity frames, so
    # the slide axis is attach_a's local X), lin limits [0, 2*rest_length],
    # and two p2p constraints anchoring the attachs to the members.
    sphere = shapes.get_shape(shapes.SPHERE).hull_verts
    muscle_sliders, muscle_p2p_a, muscle_p2p_b, muscle_speed = [], [], [], []

    def member_world(name: str, local: np.ndarray) -> np.ndarray:
        m = spec.member(name)
        from .model import _quat_to_mat3

        return m.translation + _quat_to_mat3(m.rotation) @ np.asarray(local, float)

    for mu in spec.muscles:
        ma = spec.member(mu.item_a)
        mb = spec.member(mu.item_b)
        pos_a = member_world(mu.item_a, mu.pos_in_a)
        pos_b = member_world(mu.item_b, mu.pos_in_b)
        ia = b.add_body(
            f"{mu.name}_attach_a", sphere, mu.attach_scale, mu.attach_mass,
            pos_a, ma.rotation, no_contact=True,
        )
        ib = b.add_body(
            f"{mu.name}_attach_b", sphere, mu.attach_scale, mu.attach_mass,
            pos_b, mb.rotation, no_contact=True,
        )
        rest = float(np.linalg.norm(pos_a - pos_b))
        slider = b.add_slider(
            ia, ib, (0, 0, 0), (0, 0, 0, 1), (0, 0, 0), (0, 0, 0, 1),
            lin_lo=0.0, lin_hi=2.0 * rest,
            max_motor_force=mu.force, motor_index=len(muscle_sliders),
        )
        pa = b.add_p2p(member_idx[mu.item_a], ia, mu.pos_in_a, (0, 0, 0))
        pb = b.add_p2p(member_idx[mu.item_b], ib, mu.pos_in_b, (0, 0, 0))
        muscle_sliders.append(slider)
        muscle_p2p_a.append(pa)
        muscle_p2p_b.append(pb)
        muscle_speed.append(mu.speed)

    model = b.finalize()
    if len(model.dyn_pair_body) > 48:
        # robots are the only models with enough member pairs for the dense
        # narrowphase to dominate step time; cull to the 48 closest pairs
        # per env (the spider never has more than ~2 dozen members within
        # reach — physics unchanged, see PhysicsModel.member_topm)
        import dataclasses as _dc

        model = _dc.replace(model, member_topm=48)

    # ctor-time contactPairTest quirk (proprioception_state.cpp:17-18): the
    # floor-touched flag is set once at construction and never again; compute
    # it statically from the build pose.
    touch = np.zeros(model.n_bodies, dtype=np.float32)
    floor_top = float(floor_pos[1]) + float(floor_scale[1]) + 2 * 0.04
    for name, idx in member_idx.items():
        pts = model.hull[idx][model.hull_mask[idx] > 0]
        from .model import _quat_to_mat3

        world = (_quat_to_mat3(model.init_quat[idx]) @ pts.T).T + model.init_pos[idx]
        if world[:, 1].min() - 0.04 < floor_top:
            touch[idx] = 1.0

    member_bodies = tuple(member_idx[m.name] for m in spec.members)
    root = member_idx[spec.root_name]
    n_members = len(spec.members)
    n_muscles = len(spec.muscles)
    # per-member state 16 (+3) + root extra 3, muscles 4 each
    # (proprioception_state.cpp get_size: 3 + 3*4 + 1 (+3))
    obs_dim = (16 + 3) * n_members + 4 * n_muscles

    meta = RobotMeta(
        floor_body=floor,
        root_body=root,
        member_bodies=member_bodies,
        non_root_bodies=tuple(i for i in member_bodies if i != root),
        muscle_sliders=tuple(muscle_sliders),
        muscle_p2p_a=tuple(muscle_p2p_a),
        muscle_p2p_b=tuple(muscle_p2p_b),
        muscle_speed=np.asarray(muscle_speed, dtype=np.float32),
        n_muscles=n_muscles,
        obs_dim=obs_dim,
        action_dim=n_muscles,
        initial_floor_touch=touch,
    )
    return model, meta

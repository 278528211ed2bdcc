"""Robot-builder environment: programmatic robot editing.

Port copy of ``evomotion_tpu/builder/builder_env.py`` on the port's model
builder, shapes and robot serializer (no JAX): ``compile()`` returns the
port's PhysicsModel. Keep the two in step (tests/test_torch_builder.py
holds their saved JSON and compiled models equal).

Reference: RobotBuilderEnvironment (evo_motion_model/include/evo_motion_model/
robot/builder.h:142-254, src/robot_builder/*.cpp, ~1k LoC driven by the ImGui
GUI). TPU-native reframing: the builder edits a mutable skeleton description
(the same SkeletonSpec the serializer and physics compiler consume); physics
never runs while editing, so there is no Bullet world to keep in sync — the
edited robot compiles to a PhysicsModel on demand.

API parity (builder.h):
- set_root / add_member / clone_body_part / update_member / rename_member /
  remove_member (removing a member drops its constraints, environment.cpp:120)
- attach_hinge_constraint / attach_fixed_constraint from ABSOLUTE pivot/axis
  (frames recomputed into both bodies' local spaces, robot_builder/
  constraint.cpp:84-120), update_*_constraint, remove_constraint
- add_muscle / remove_muscle
- getters (member transform/mass/friction, constraint info/members/type)
- update_member propagates the delta transform through the skeleton graph by
  BFS so children follow their parent (environment.cpp:40-95)
- ray_cast_member: closest-hit ray vs member convex hulls (replaces
  btCollisionWorld::rayTest, environment.cpp:449-465)
- save_robot / load_robot via the bit-exact JSON serializer
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..physics.model import _mat3_to_quat, _quat_to_mat3
from ..physics.shapes import get_shape
from ..serialize import robot as robot_json
from ..serialize.robot import FixedSpec, HingeSpec, MemberSpec, MuscleSpec, SkeletonSpec


def _compose(pos, quat):
    m = np.eye(4)
    m[:3, :3] = _quat_to_mat3(np.asarray(quat, float))
    m[:3, 3] = np.asarray(pos, float)
    return m


def _decompose(m):
    pos = m[:3, 3].copy()
    basis = m[:3, :3]
    scale = np.linalg.norm(basis, axis=0)
    rot = basis / np.maximum(scale[None, :], 1e-12)
    return pos, _mat3_to_quat(rot), scale


class RobotBuilderEnvironment:
    def __init__(self, robot_name: str = "robot"):
        self.robot_name = robot_name
        self.root_name: str | None = None
        self.members: list[MemberSpec] = []
        self.constraints: list[HingeSpec | FixedSpec] = []
        self.muscles: list[MuscleSpec] = []
        # member -> [(constraint_name, other_member)] (skeleton_graph)
        self.skeleton_graph: dict[str, list[tuple[str, str]]] = {}

    # --- lookup ---

    def member_exists(self, name: str) -> bool:
        return any(m.name == name for m in self.members)

    def constraint_exists(self, name: str) -> bool:
        return any(c.name == name for c in self.constraints)

    def muscle_exists(self, name: str) -> bool:
        return any(m.name == name for m in self.muscles)

    def _member(self, name: str) -> MemberSpec:
        for m in self.members:
            if m.name == name:
                return m
        raise KeyError(f'Member "{name}" not found')

    def _constraint(self, name: str):
        for c in self.constraints:
            if c.name == name:
                return c
        raise KeyError(f'Constraint "{name}" not found')

    def get_member_names(self) -> list[str]:
        return [m.name for m in self.members]

    def get_members_count(self) -> int:
        return len(self.members)

    def get_robot_name(self) -> str:
        return self.robot_name

    def set_robot_name(self, new_name: str) -> None:
        self.robot_name = new_name

    def get_root_name(self) -> str | None:
        return self.root_name

    # --- members ---

    def set_root(self, member_name: str) -> bool:
        if not self.member_exists(member_name):
            return False
        self.root_name = member_name
        return True

    def add_member(
        self, member_name, shape_kind, center_pos, rotation, scale, mass, friction,
        ignore_collision: bool = False,
    ) -> bool:
        if self.member_exists(member_name):
            return False
        get_shape(shape_kind)  # validates the kind
        self.members.append(
            MemberSpec(
                name=member_name,
                shape=shape_kind,
                translation=np.asarray(center_pos, np.float32),
                rotation=np.asarray(rotation, np.float32),
                scale=np.asarray(scale, np.float32),
                mass=float(mass),
                friction=float(friction),
                ignore_collision=ignore_collision,
            )
        )
        self.skeleton_graph.setdefault(member_name, [])
        return True

    def clone_body_part(self, member_name, prefix_name, center_pos, rotation) -> bool:
        """Clone `member_name` and its whole subtree, re-rooting the clone at
        (center_pos, rotation) (environment.cpp:178+)."""
        if not self.member_exists(member_name):
            return False
        src = self._member(member_name)
        old_root_mat = _compose(src.translation, src.rotation)
        new_root_mat = _compose(center_pos, rotation)
        delta = new_root_mat @ np.linalg.inv(old_root_mat)

        visited: set[str] = set()
        queue = [member_name]
        name_map: dict[str, str] = {}
        while queue:
            cur = queue.pop(0)
            if cur in visited:
                continue
            visited.add(cur)
            m = self._member(cur)
            new_name = f"{prefix_name}_{cur}"
            if self.member_exists(new_name):
                return False
            name_map[cur] = new_name
            new_mat = delta @ _compose(m.translation, m.rotation)
            pos, quat, _ = _decompose(new_mat)
            self.add_member(
                new_name, m.shape, pos, quat, m.scale, m.mass, m.friction, m.ignore_collision
            )
            for cname, other in self.skeleton_graph.get(cur, []):
                c = self._constraint(cname)
                if c.child_name == other:  # only walk downward
                    queue.append(other)

        # clone the constraints among cloned members
        for c in list(self.constraints):
            if c.parent_name in name_map and c.child_name in name_map:
                new_c = dataclasses.replace(
                    c,
                    name=f"{prefix_name}_{c.name}",
                    parent_name=name_map[c.parent_name],
                    child_name=name_map[c.child_name],
                )
                self.constraints.append(new_c)
                self._graph_link(new_c.name, new_c.parent_name, new_c.child_name)
        return True

    def update_member(
        self, member_name, new_pos=None, new_rot=None, new_scale=None,
        new_friction=None, new_mass=None, new_ignore_collision=None,
    ) -> bool:
        """In-place member update; children follow via BFS transform
        propagation (environment.cpp:40-95)."""
        if not self.member_exists(member_name):
            return False
        m = self._member(member_name)
        old_mat = _compose(m.translation, m.rotation)
        if new_pos is not None:
            m.translation = np.asarray(new_pos, np.float32)
        if new_rot is not None:
            m.rotation = np.asarray(new_rot, np.float32)
        if new_scale is not None:
            m.scale = np.asarray(new_scale, np.float32)
        if new_friction is not None:
            m.friction = float(new_friction)
        if new_mass is not None:
            m.mass = float(new_mass)
        if new_ignore_collision is not None:
            m.ignore_collision = bool(new_ignore_collision)
        new_mat = _compose(m.translation, m.rotation)

        updated = {member_name}
        queue = [
            (old_mat, new_mat, other) for _, other in self.skeleton_graph.get(member_name, [])
        ]
        while queue:
            p_old, p_new, cur = queue.pop(0)
            if cur in updated:
                continue
            c = self._member(cur)
            c_old = _compose(c.translation, c.rotation)
            in_parent = np.linalg.inv(p_old) @ c_old
            c_new = p_new @ in_parent
            pos, quat, _ = _decompose(c_new)
            c.translation = pos.astype(np.float32)
            c.rotation = quat.astype(np.float32)
            updated.add(cur)
            for _, other in self.skeleton_graph.get(cur, []):
                if other not in updated:
                    queue.append((c_old, c_new, other))
        return True

    def rename_member(self, old_name: str, new_name: str) -> bool:
        if self.member_exists(new_name) or not self.member_exists(old_name):
            return False
        self._member(old_name).name = new_name
        if self.root_name == old_name:
            self.root_name = new_name
        self.skeleton_graph[new_name] = self.skeleton_graph.pop(old_name, [])
        for key in self.skeleton_graph:
            self.skeleton_graph[key] = [
                (c, new_name if n == old_name else n) for c, n in self.skeleton_graph[key]
            ]
        for c in self.constraints:
            if c.parent_name == old_name:
                c.parent_name = new_name
            if c.child_name == old_name:
                c.child_name = new_name
        for mu in self.muscles:
            if mu.item_a == old_name:
                mu.item_a = new_name
            if mu.item_b == old_name:
                mu.item_b = new_name
        return True

    def remove_member(self, member_name: str) -> bool:
        if not self.member_exists(member_name):
            return False
        for cname, _ in list(self.skeleton_graph.get(member_name, [])):
            self.remove_constraint(cname)
        self.members = [m for m in self.members if m.name != member_name]
        self.muscles = [
            mu for mu in self.muscles if member_name not in (mu.item_a, mu.item_b)
        ]
        self.skeleton_graph.pop(member_name, None)
        if self.root_name == member_name:
            self.root_name = None
        return True

    def get_member_transform(self, member_name):
        m = self._member(member_name)
        return m.translation.copy(), m.rotation.copy(), m.scale.copy()

    def get_member_mass(self, member_name) -> float:
        return self._member(member_name).mass

    def get_member_friction(self, member_name) -> float:
        return self._member(member_name).friction

    # --- constraints ---

    def _graph_link(self, constraint_name, parent, child):
        self.skeleton_graph.setdefault(parent, []).append((constraint_name, child))
        self.skeleton_graph.setdefault(child, []).append((constraint_name, parent))

    def _graph_unlink(self, constraint_name):
        for key in self.skeleton_graph:
            self.skeleton_graph[key] = [
                (c, n) for c, n in self.skeleton_graph[key] if c != constraint_name
            ]

    def attach_hinge_constraint(
        self, constraint_name, parent_name, child_name,
        absolute_pivot, absolute_axis, limit_angle_min=1.0, limit_angle_max=-1.0,
    ) -> bool:
        """Hinge from an absolute pivot point and axis; both re-expressed in
        the current member frames (robot_builder/constraint.cpp:84-120)."""
        if self.constraint_exists(constraint_name):
            return False
        if not (self.member_exists(parent_name) and self.member_exists(child_name)):
            return False
        p = self._member(parent_name)
        c = self._member(child_name)
        rp = _quat_to_mat3(p.rotation)
        rc = _quat_to_mat3(c.rotation)
        piv = np.asarray(absolute_pivot, float)
        ax = np.asarray(absolute_axis, float)
        ax = ax / max(np.linalg.norm(ax), 1e-12)
        self.constraints.append(
            HingeSpec(
                name=constraint_name,
                parent_name=parent_name,
                child_name=child_name,
                pivot_in_parent=(rp.T @ (piv - p.translation)).astype(np.float32),
                pivot_in_child=(rc.T @ (piv - c.translation)).astype(np.float32),
                axis_in_parent=(rp.T @ ax).astype(np.float32),
                axis_in_child=(rc.T @ ax).astype(np.float32),
                limit_min=float(limit_angle_min),
                limit_max=float(limit_angle_max),
            )
        )
        self._graph_link(constraint_name, parent_name, child_name)
        return True

    def attach_fixed_constraint(
        self, constraint_name, parent_name, child_name, absolute_fixed_point, absolute_rotation,
    ) -> bool:
        if self.constraint_exists(constraint_name):
            return False
        if not (self.member_exists(parent_name) and self.member_exists(child_name)):
            return False
        p = self._member(parent_name)
        c = self._member(child_name)
        frame_world = _compose(absolute_fixed_point, absolute_rotation)
        in_parent = np.linalg.inv(_compose(p.translation, p.rotation)) @ frame_world
        in_child = np.linalg.inv(_compose(c.translation, c.rotation)) @ frame_world
        pp, pq, _ = _decompose(in_parent)
        cp, cq, _ = _decompose(in_child)
        self.constraints.append(
            FixedSpec(
                name=constraint_name,
                parent_name=parent_name,
                child_name=child_name,
                frame_in_parent_pos=pp.astype(np.float32),
                frame_in_parent_quat=pq.astype(np.float32),
                frame_in_child_pos=cp.astype(np.float32),
                frame_in_child_quat=cq.astype(np.float32),
            )
        )
        self._graph_link(constraint_name, parent_name, child_name)
        return True

    def update_hinge_constraint(
        self, name, new_pos=None, new_axis=None, new_limit_angle_min=None, new_angle_limit_max=None,
    ) -> bool:
        if not self.constraint_exists(name):
            return False
        c = self._constraint(name)
        if not isinstance(c, HingeSpec):
            return False
        pivot_abs, axis_abs, lo, hi = self.get_constraint_hinge_info(name)
        pivot_abs = new_pos if new_pos is not None else pivot_abs
        axis_abs = new_axis if new_axis is not None else axis_abs
        lo = new_limit_angle_min if new_limit_angle_min is not None else lo
        hi = new_angle_limit_max if new_angle_limit_max is not None else hi
        self.remove_constraint(name)
        return self.attach_hinge_constraint(
            name, c.parent_name, c.child_name, pivot_abs, axis_abs, lo, hi
        )

    def update_fixed_constraint(self, name, new_pos=None, new_rot=None) -> bool:
        if not self.constraint_exists(name):
            return False
        c = self._constraint(name)
        if not isinstance(c, FixedSpec):
            return False
        pos_abs, rot_abs = self.get_constraint_fixed_info(name)
        pos_abs = new_pos if new_pos is not None else pos_abs
        rot_abs = new_rot if new_rot is not None else rot_abs
        self.remove_constraint(name)
        return self.attach_fixed_constraint(name, c.parent_name, c.child_name, pos_abs, rot_abs)

    def remove_constraint(self, constraint_name: str) -> bool:
        if not self.constraint_exists(constraint_name):
            return False
        self.constraints = [c for c in self.constraints if c.name != constraint_name]
        self._graph_unlink(constraint_name)
        return True

    def get_constraint_type(self, name) -> str:
        return "hinge" if isinstance(self._constraint(name), HingeSpec) else "fixed"

    def get_constraint_members(self, name):
        c = self._constraint(name)
        return c.parent_name, c.child_name

    def get_constraint_hinge_info(self, name):
        c = self._constraint(name)
        p = self._member(c.parent_name)
        rp = _quat_to_mat3(p.rotation)
        pivot_abs = p.translation + rp @ c.pivot_in_parent
        axis_abs = rp @ c.axis_in_parent
        return pivot_abs, axis_abs, c.limit_min, c.limit_max

    def get_constraint_fixed_info(self, name):
        c = self._constraint(name)
        p = self._member(c.parent_name)
        world = _compose(p.translation, p.rotation) @ _compose(
            c.frame_in_parent_pos, c.frame_in_parent_quat
        )
        pos, quat, _ = _decompose(world)
        return pos, quat

    # --- muscles ---

    def add_muscle(
        self, muscle_name, item_a, item_b, pos_in_a, pos_in_b,
        attach_mass=0.1875, attach_scale=(0.0625, 0.0625, 0.0625),
        force=64.0, max_speed=8.0,
    ) -> bool:
        if self.muscle_exists(muscle_name):
            return False
        if not (self.member_exists(item_a) and self.member_exists(item_b)):
            return False
        self.muscles.append(
            MuscleSpec(
                name=muscle_name,
                attach_mass=float(attach_mass),
                attach_scale=np.asarray(attach_scale, np.float32),
                item_a=item_a,
                item_b=item_b,
                pos_in_a=np.asarray(pos_in_a, np.float32),
                pos_in_b=np.asarray(pos_in_b, np.float32),
                force=float(force),
                speed=float(max_speed),
            )
        )
        return True

    def remove_muscle(self, muscle_name: str) -> bool:
        if not self.muscle_exists(muscle_name):
            return False
        self.muscles = [m for m in self.muscles if m.name != muscle_name]
        return True

    # --- ray casting (environment.cpp:449-465) ---

    def ray_cast_member(self, from_absolute, to_absolute) -> str | None:
        """Closest hit of the segment against member convex hulls (slab test
        on each hull's face planes)."""
        from scipy.spatial import ConvexHull

        o = np.asarray(from_absolute, float)
        d = np.asarray(to_absolute, float) - o
        best_t, best_name = np.inf, None
        for m in self.members:
            verts = get_shape(m.shape).hull_verts * np.asarray(m.scale)[None, :]
            world = (_quat_to_mat3(m.rotation) @ verts.T).T + m.translation
            try:
                hull = ConvexHull(world, qhull_options="QJ")
            except Exception:
                continue
            t_in, t_out = 0.0, 1.0
            for n_x, n_y, n_z, off in hull.equations:
                n = np.array([n_x, n_y, n_z])
                denom = n @ d
                dist = n @ o + off
                if abs(denom) < 1e-12:
                    if dist > 0:
                        t_in, t_out = 1.0, 0.0
                        break
                else:
                    t_hit = -dist / denom
                    if denom < 0:
                        t_in = max(t_in, t_hit)
                    else:
                        t_out = min(t_out, t_hit)
            if t_in <= t_out and t_in < best_t:
                best_t, best_name = t_in, m.name
        return best_name

    def ray_cast_constraint(self, from_absolute, to_absolute) -> str | None:
        """Closest constraint marker hit: small spheres at joint frames
        (replaces the temporary fake-body trick, environment.cpp:467-518)."""
        o = np.asarray(from_absolute, float)
        d = np.asarray(to_absolute, float) - o
        dn = np.linalg.norm(d)
        if dn < 1e-12:
            return None
        best_t, best_name = np.inf, None
        for c in self.constraints:
            if isinstance(c, HingeSpec):
                center = self.get_constraint_hinge_info(c.name)[0]
            else:
                center = self.get_constraint_fixed_info(c.name)[0]
            radius = 0.1
            oc = o - center
            b = 2 * (d @ oc)
            a = d @ d
            disc = b * b - 4 * a * ((oc @ oc) - radius * radius)
            if disc < 0:
                continue
            t = (-b - np.sqrt(disc)) / (2 * a)
            if 0 <= t <= 1 and t < best_t:
                best_t, best_name = t, c.name
        return best_name

    # --- persistence ---

    def to_spec(self) -> SkeletonSpec:
        return SkeletonSpec(
            robot_name=self.robot_name,
            root_name=self.root_name or "",
            members=self.members,
            constraints=self.constraints,
            muscles=self.muscles,
        )

    def save_robot(self, output_json_path: str) -> None:
        robot_json.save(output_json_path, self.to_spec())

    def load_robot(self, input_json_path: str) -> None:
        spec = robot_json.load(input_json_path)
        self.robot_name = spec.robot_name
        self.root_name = spec.root_name
        self.members = spec.members
        self.constraints = spec.constraints
        self.muscles = spec.muscles
        self.skeleton_graph = {m.name: [] for m in self.members}
        for c in self.constraints:
            self._graph_link(c.name, c.parent_name, c.child_name)

    def compile(self):
        """Compile the edited robot into a PhysicsModel (ready for envs)."""
        from ..physics.robot_compiler import compile_robot

        return compile_robot(self.to_spec())

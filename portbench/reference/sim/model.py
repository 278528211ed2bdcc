"""Physics model compiler: host-side builder producing flat, static arrays.

Port copy of ``evomotion_tpu/physics/model.py`` (numpy only): the port keeps
its own copy so that it imports no module of the JAX package; keep the two
in step (tests/test_torch_front_end.py compares them).

The reference assembles a mutable Bullet world of heap objects
(btRigidBody / btTypedConstraint, evo_motion_model/src/environment.cpp,
src/robot/*.cpp). The TPU-native design compiles the same information once,
on host, into a frozen `PhysicsModel` of numpy arrays with static shapes:

  bodies      -> inv_mass / inv_inertia / friction / hull points [NB, V, 3]
  constraints -> typed struct-of-arrays (p2p / hinge / fixed / slider)
  contacts    -> precomputed candidate pairs (body x static floor, body x body)
  solver      -> precomputed graph-coloring of constraint blocks so a
                 Gauss-Seidel sweep runs as a short sequence of vectorized
                 color phases instead of a long scalar loop

Behavior-parity notes:
- Convex-hull inertia matches Bullet's AABB box approximation
  (btPolyhedralConvexShape::calculateLocalInertia: AABB incl. margin, plus
  margin again on each half extent).
- Note on solver iterations: the reference calls
  ``setOverrideNumSolverIterations(getOverrideNumSolverIterations() * N)``
  (muscle.cpp:62-67, constraint.cpp:65-68,147-149) but the initial override is
  -1 ("no override") in Bullet, so the multiplication keeps it negative and
  every constraint actually runs at the world default of 10 iterations. We
  replicate the *effective* behavior: 10 iterations for everything.
- Hinge reference frames are built exactly as the
  ``btHingeConstraint(rbA, rbB, pivotA, pivotB, axisA, axisB)`` constructor
  does (axis becomes the Z column; X/Y from the body A basis at build time),
  so hinge-angle measurement and limits agree.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

CONVEX_MARGIN = 0.04  # Bullet CONVEX_DISTANCE_MARGIN
MAX_CONTACTS_PER_PAIR = 4  # Bullet persistent manifold size


def _normalize(v: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(v)
    return v / n if n > 1e-12 else v


def _quat_to_mat3(q: np.ndarray) -> np.ndarray:
    x, y, z, w = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ],
        dtype=np.float64,
    )


def _mat3_to_quat(m: np.ndarray) -> np.ndarray:
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array(
            [(m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s, 0.25 * s]
        )
    i = int(np.argmax(np.diag(m)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(m[i, i] - m[j, j] - m[k, k] + 1.0, 1e-18)) * 2
    q = np.zeros(4)
    q[i] = 0.25 * s
    q[j] = (m[j, i] + m[i, j]) / s
    q[k] = (m[k, i] + m[i, k]) / s
    q[3] = (m[k, j] - m[j, k]) / s
    return q / np.linalg.norm(q)


@dataclasses.dataclass
class _Body:
    name: str
    hull: np.ndarray  # scaled local points [V, 3]
    scale: np.ndarray
    mass: float
    friction: float
    restitution: float
    pos: np.ndarray
    quat: np.ndarray  # xyzw
    no_contact: bool  # CF_NO_CONTACT_RESPONSE
    margin: float


@dataclasses.dataclass(frozen=True)
class PhysicsModel:
    """Frozen, statically shaped physics scene description."""

    # --- bodies ---
    n_bodies: int
    body_names: tuple[str, ...]
    mass: np.ndarray  # [NB]
    inv_mass: np.ndarray  # [NB]
    inv_inertia_local: np.ndarray  # [NB, 3]
    friction: np.ndarray  # [NB]
    restitution: np.ndarray  # [NB]
    hull: np.ndarray  # [NB, V, 3] scaled points, padded (pad = repeat of pt 0)
    hull_mask: np.ndarray  # [NB, V] 1.0 for real points
    margin: np.ndarray  # [NB]
    init_pos: np.ndarray  # [NB, 3]
    init_quat: np.ndarray  # [NB, 4]
    # --- p2p constraints ---
    p2p_body: np.ndarray  # [NP2P, 2]
    p2p_pivot: np.ndarray  # [NP2P, 2, 3] pivot in each body frame
    # --- hinge constraints ---
    hinge_body: np.ndarray  # [NH, 2]
    hinge_pivot: np.ndarray  # [NH, 2, 3]
    hinge_frame_quat: np.ndarray  # [NH, 2, 4] rbAFrame/rbBFrame basis (axis = Z col)
    hinge_limit: np.ndarray  # [NH, 2] (lo, hi); lo > hi means no limit
    # --- fixed constraints ---
    fixed_body: np.ndarray  # [NF, 2]
    fixed_pivot: np.ndarray  # [NF, 2, 3]
    fixed_frame_quat: np.ndarray  # [NF, 2, 4]
    # --- slider constraints (incl. powered linear motors) ---
    slider_body: np.ndarray  # [NS, 2]
    slider_pivot: np.ndarray  # [NS, 2, 3] frame origins in body frames
    slider_frame_quat: np.ndarray  # [NS, 2, 4] (slide axis = X col of frame A)
    slider_lin_limit: np.ndarray  # [NS, 2] (lo, hi); lo > hi = free
    slider_max_motor_force: np.ndarray  # [NS]
    slider_motor_index: np.ndarray  # [NS] action slot driving this motor (-1 = none)
    # --- contact candidate pairs ---
    pair_body: np.ndarray  # [NPAIR, 2] (dynamic body, other body); other may be static
    # dynamic-dynamic candidate pairs (member-member collision): SAT
    # vertex-vs-hull-face narrowphase over per-body PROXY hulls (decimated to
    # <= NP_VERTS points, faces precomputed in the local frame). The
    # reference runs Bullet's GJK/EPA on the full hulls (item.cpp:17-52);
    # the proxy + vertex-face formulation is the batched equivalent — the
    # deepest penetrating vertex of either hull in the other gives the
    # contact (edge-edge crossings engage once a vertex passes the combined
    # 0.08 margin, slightly later than EPA would report them).
    dyn_pair_body: np.ndarray  # [NDP, 2]
    np_hull: np.ndarray  # [NB, NPV, 3] proxy hull points (pad = repeat pt 0)
    np_hull_mask: np.ndarray  # [NB, NPV]
    # marks the TRUE decimated hull vertices within np_hull (the tail of the
    # point budget is long-edge subdivision TEST points — needed for the
    # vertex-vs-face crossing test but never extreme under a linear
    # functional, so support/interval projections skip them)
    np_support_mask: np.ndarray  # [NB, NPV]
    np_face: np.ndarray  # [NB, NPF, 4] local face planes (n, d): n.x+d<=0 inside
    np_face_mask: np.ndarray  # [NB, NPF]
    # static coloring of dyn pairs for the xla backend's Gauss-Seidel phases
    # (pairs in one color touch disjoint bodies)
    dyn_pair_color: tuple  # tuple of np.ndarray pair-index groups
    # --- solver schedule (graph coloring over constraint blocks) ---
    # each block is (kind, index): kind 0=p2p, 1=hinge, 2=fixed, 3=slider
    color_groups: tuple[tuple[tuple[int, int], ...], ...]
    # flat row-id phases: rows within one phase touch disjoint dynamic bodies
    # and are solved as one vectorized Gauss-Seidel step. Row-id layout:
    # p2p 3/block, hinge 6/block, fixed 6/block, slider 7/block (see engine).
    row_phases: tuple[np.ndarray, ...]
    # padded phase table [n_phases, max_rows]: same schedule as row_phases but
    # rectangular so the solver can fori_loop over phases (small HLO, fast
    # compile); padding points at the dummy row n_rows (zero effective mass)
    phase_table: np.ndarray
    # inverse mapping row id -> (phase, slot) for reading impulses back out
    row_phase_slot: np.ndarray  # [n_rows, 2]
    n_rows: int
    n_iterations: int = 10
    # velocity-solver backend: "xla" (colored-phase einsum loop) or "pallas"
    # (fused sequential sweep kernel, exact Bullet row ordering). Switch with
    # dataclasses.replace(model, solver="pallas").
    solver: str = "xla"
    # member-member (dyn-dyn) SAT contacts (both backends)
    member_contacts: bool = True
    # manifold points per dyn pair: the K deepest proxy-hull vertices of
    # either body in the other (Bullet keeps up-to-4-point persistent
    # manifolds per convex-convex pair, item.cpp:17-52 via GJK/EPA +
    # incident-face clipping; K penetrating corner vertices represent the
    # same face-face patch). K=1 reproduces the round-2 single-point contact.
    member_manifold_k: int = 4
    # edge-edge separating axes in the member narrowphase (support SAT over
    # cross(edge_a, edge_b); resolves edge-on-edge interlocks EPA would).
    # Default on — the fidelity configuration; turn off to trade the
    # edge-axis support passes for throughput.
    member_edge_contacts: bool = True
    # unique edge directions per proxy hull tested by the edge-edge SAT
    # (cost grows as member_edge_dirs^2 cross axes; tools/fidelity_mtv.py
    # quantifies accuracy vs this budget)
    member_edge_dirs: int = 4
    # batched-path broadphase cull: run the member SAT narrowphase only on
    # the member_topm pairs with smallest conservative clearance (center
    # distance minus bounding radii) per env, scattering manifolds back to
    # canonical pair slots. Bullet narrowphases only broadphase-overlapping
    # AABB pairs (btDbvtBroadphase feeding the dispatcher manifolds that
    # item.cpp:17-52 reads); the dense batched mirror paid all P pairs per
    # env per step. 0 disables (dense). Physics is UNCHANGED as long as
    # every pair with an active contact ranks in the top M — unselected
    # pairs produce the same zero rows the dense path gives beyond-margin
    # pairs (equality pinned by tests/test_batched_step.py).
    member_topm: int = 0
    # pallas-sweep ROW VISIT ORDER for non-strict models (strict_bullet
    # always keeps the canonical Bullet order). Values:
    #   "canonical"      — sequential build order (joints | normals | frics)
    #   "scheduled"      — dependency-spaced permutation + <=8-wide disjoint
    #                      Jacobi groups (engine._schedule_rows)
    #   "shuffled:<N>"   — seeded random friction-after-parent order; used
    #                      to train gait robustness to solver micro-order
    # The solve order is physics-visible for trained policies (r4 finding:
    # checkpoints overfit to it), so it is a MODEL field — serialized into
    # run configs / checkpoint metadata, not an ambient env var. finalize()
    # seeds the default from EVOMOTION_ROW_SCHEDULE for compatibility.
    row_order: str = "scheduled"
    # dtype of the J columns streamed by the pallas sweep: "bf16" halves the
    # kernel's HBM row traffic (the measured bottleneck — PERF.jsonl r4);
    # "f32" is exact. strict_bullet always uses f32. The per-env fat-row
    # kernel keeps f32 either way; cross-backend equivalence tests pin
    # row_dtype="f32".
    row_dtype: str = "bf16"
    # strict-Bullet configuration for parity runs (engine.py module docstring
    # lists the default-mode divergences this flag removes):
    # - limit-row correction velocity uncapped (Bullet applies no cap)
    # - joint rows warm-started from cached impulses x 0.85 (Bullet
    #   warm-starts every btSolverConstraint, not only contacts)
    # - single slip-aligned friction direction per contact point (Bullet's
    #   default solver mode; the default here uses two fixed tangents)
    strict_bullet: bool = False

    @property
    def n_p2p(self) -> int:
        return len(self.p2p_body)

    @property
    def n_hinge(self) -> int:
        return len(self.hinge_body)

    @property
    def n_fixed(self) -> int:
        return len(self.fixed_body)

    @property
    def n_slider(self) -> int:
        return len(self.slider_body)


class ModelBuilder:
    """Imperative scene assembly; `finalize()` freezes to a PhysicsModel."""

    def __init__(self):
        self.bodies: list[_Body] = []
        self._name_to_idx: dict[str, int] = {}
        self.p2p: list[tuple] = []
        self.hinge: list[tuple] = []
        self.fixed: list[tuple] = []
        self.slider: list[tuple] = []
        self.ignore_pairs: set[tuple[int, int]] = set()

    def add_body(
        self,
        name: str,
        hull_verts: np.ndarray,
        scale,
        mass: float,
        pos,
        quat,
        friction: float = 0.5,
        restitution: float = 0.0,
        no_contact: bool = False,
        margin: float = CONVEX_MARGIN,
    ) -> int:
        """Add a rigid body (reference: RigidBodyItem, item.cpp:17-52).

        Bullet's default friction for a new body is 0.5; members override it
        from JSON (robot/member.cpp:30)."""
        scale = np.asarray(scale, dtype=np.float64)
        body = _Body(
            name=name,
            hull=np.asarray(hull_verts, dtype=np.float64) * scale[None, :],
            scale=scale,
            mass=float(mass),
            friction=float(friction),
            restitution=float(restitution),
            pos=np.asarray(pos, dtype=np.float64),
            quat=np.asarray(quat, dtype=np.float64),
            no_contact=no_contact,
            margin=margin,
        )
        idx = len(self.bodies)
        self.bodies.append(body)
        self._name_to_idx[name] = idx
        return idx

    def body_index(self, name: str) -> int:
        return self._name_to_idx[name]

    def set_ignore_collision(self, a: int, b: int):
        """Mirror btRigidBody::setIgnoreCollisionCheck."""
        self.ignore_pairs.add((min(a, b), max(a, b)))

    def add_p2p(self, body_a: int, body_b: int, pivot_a, pivot_b) -> int:
        self.p2p.append((body_a, body_b, np.asarray(pivot_a, float), np.asarray(pivot_b, float)))
        return len(self.p2p) - 1

    def add_hinge(
        self, body_a: int, body_b: int, pivot_a, pivot_b, axis_a, axis_b,
        limit_lo: float = 1.0, limit_hi: float = -1.0,
    ) -> int:
        """Hinge from pivots + axes; frames built like the Bullet ctor.

        Default limits lo > hi disable the limit (Bullet convention;
        cartpole's hinge never calls setLimit — cartpole.cpp:70-74)."""
        # Exact btHingeConstraint ctor frame construction — including its
        # mixed local/world quirk: rbAxisA1 starts as body A's *world* basis
        # column 0 but is crossed against the *local* axisInA, and the
        # shortest-arc quat maps local axisInA to local axisInB. Members carry
        # non-identity build rotations (spider JSON), so reproducing this
        # exactly is what makes initial hinge angles sit inside their limit
        # sectors like Bullet's do.
        a_rot = _quat_to_mat3(self.bodies[body_a].quat)
        axis_a = _normalize(np.asarray(axis_a, float))
        axis_b = _normalize(np.asarray(axis_b, float))

        rb_axis_a1 = a_rot[:, 0]
        proj = float(axis_a @ rb_axis_a1)
        if proj >= 1.0 - 1e-5:
            rb_axis_a1 = -a_rot[:, 2]
            rb_axis_a2 = a_rot[:, 1]
        elif proj <= -1.0 + 1e-5:
            rb_axis_a1 = a_rot[:, 2]
            rb_axis_a2 = a_rot[:, 1]
        else:
            rb_axis_a2 = np.cross(axis_a, rb_axis_a1)
            rb_axis_a1 = np.cross(rb_axis_a2, axis_a)
        # Bullet leaves these unnormalized (uniformly scaled cols 0/1, which
        # cancels in the atan2 angle); normalize for quaternion storage.
        frame_a = np.stack([_normalize(rb_axis_a1), _normalize(rb_axis_a2), axis_a], axis=1)

        rot_arc = _shortest_arc_quat(axis_a, axis_b)
        arc = _quat_to_mat3(rot_arc)
        rb_axis_b1 = arc @ rb_axis_a1
        rb_axis_b2 = np.cross(axis_b, rb_axis_b1)
        frame_b = np.stack([_normalize(rb_axis_b1), _normalize(rb_axis_b2), axis_b], axis=1)

        self.hinge.append(
            (
                body_a, body_b,
                np.asarray(pivot_a, float), np.asarray(pivot_b, float),
                _mat3_to_quat(frame_a), _mat3_to_quat(frame_b),
                float(limit_lo), float(limit_hi),
            )
        )
        return len(self.hinge) - 1

    def add_fixed(self, body_a: int, body_b: int, frame_pos_a, frame_quat_a, frame_pos_b, frame_quat_b) -> int:
        self.fixed.append(
            (
                body_a, body_b,
                np.asarray(frame_pos_a, float), np.asarray(frame_quat_a, float),
                np.asarray(frame_pos_b, float), np.asarray(frame_quat_b, float),
            )
        )
        return len(self.fixed) - 1

    def add_slider(
        self, body_a: int, body_b: int, frame_pos_a, frame_quat_a, frame_pos_b, frame_quat_b,
        lin_lo: float = 1.0, lin_hi: float = -1.0,
        max_motor_force: float = 0.0, motor_index: int = -1,
    ) -> int:
        """Slider along the X axis of frame A (btSliderConstraint convention).

        Angular motion is locked (the reference always runs sliders with
        lower==upper==0 angular limits — the Bullet default, and explicitly for
        muscles, muscle.cpp:41-42)."""
        self.slider.append(
            (
                body_a, body_b,
                np.asarray(frame_pos_a, float), np.asarray(frame_quat_a, float),
                np.asarray(frame_pos_b, float), np.asarray(frame_quat_b, float),
                float(lin_lo), float(lin_hi), float(max_motor_force), int(motor_index),
            )
        )
        return len(self.slider) - 1

    # --- finalize ---

    def _inertia(self, body: _Body) -> np.ndarray:
        """Bullet convex-hull inertia: box approximation from the AABB.

        btPolyhedralConvexShape::calculateLocalInertia uses the AABB including
        margin, then adds the margin to each half extent again."""
        if body.mass == 0.0:
            return np.zeros(3)
        mn, mx = body.hull.min(axis=0), body.hull.max(axis=0)
        half = (mx - mn) * 0.5 + body.margin  # AABB incl. margin
        lx, ly, lz = 2.0 * (half + body.margin)
        m = body.mass
        return np.array(
            [m / 12.0 * (ly * ly + lz * lz), m / 12.0 * (lx * lx + lz * lz), m / 12.0 * (lx * lx + ly * ly)]
        )

    def _collision_pairs(self) -> np.ndarray:
        pairs = []
        nb = len(self.bodies)
        for i in range(nb):
            for j in range(i + 1, nb):
                bi, bj = self.bodies[i], self.bodies[j]
                if bi.mass == 0.0 and bj.mass == 0.0:
                    continue
                if bi.no_contact or bj.no_contact:
                    continue
                if (i, j) in self.ignore_pairs:
                    continue
                # order: dynamic body first
                if bi.mass == 0.0:
                    pairs.append((j, i))
                else:
                    pairs.append((i, j))
        return np.array(pairs, dtype=np.int32).reshape(-1, 2)

    def _color_blocks(self) -> tuple:
        """Greedy graph-coloring of constraint blocks.

        Two blocks conflict iff they share a *dynamic* body; blocks of the
        same color are solved in one vectorized phase (a valid Gauss-Seidel
        ordering — each body's velocity is read/written by at most one block
        per phase). Static bodies never conflict (their velocity is fixed)."""
        blocks: list[tuple[int, int, set[int]]] = []

        def dyn(bds):
            return {b for b in bds if self.bodies[b].mass > 0.0}

        for i, c in enumerate(self.p2p):
            blocks.append((0, i, dyn(c[:2])))
        for i, c in enumerate(self.hinge):
            blocks.append((1, i, dyn(c[:2])))
        for i, c in enumerate(self.fixed):
            blocks.append((2, i, dyn(c[:2])))
        for i, c in enumerate(self.slider):
            blocks.append((3, i, dyn(c[:2])))

        colors: list[list[tuple[int, int]]] = []
        colors_bodies: list[set[int]] = []
        for kind, idx, bds in blocks:
            placed = False
            for ci in range(len(colors)):
                if not (colors_bodies[ci] & bds):
                    colors[ci].append((kind, idx))
                    colors_bodies[ci] |= bds
                    placed = True
                    break
            if not placed:
                colors.append([(kind, idx)])
                colors_bodies.append(set(bds))
        return tuple(tuple(c) for c in colors)

    # rows per block kind: p2p=3, hinge=3 lin + 2 ang-align + 1 limit,
    # fixed=3 lin + 3 ang, slider=2 lin-perp + 3 ang + 1 lin-limit + 1 motor
    _ROWS_PER_KIND = (3, 6, 6, 7)

    def _row_schedule(self, colors) -> tuple[tuple, int]:
        """Expand block coloring into flat row-id phases.

        Rows of one block share bodies, so a block's rows are spread over
        consecutive phases of its color; rows in one phase belong to distinct
        blocks of one color and therefore touch disjoint dynamic bodies."""
        counts = [len(self.p2p), len(self.hinge), len(self.fixed), len(self.slider)]
        bases = [0]
        for k in range(3):
            bases.append(bases[-1] + counts[k] * self._ROWS_PER_KIND[k])
        n_rows = bases[-1] + counts[3] * self._ROWS_PER_KIND[3]

        phases = []
        for group in colors:
            max_rows = max(self._ROWS_PER_KIND[k] for k, _ in group)
            for r in range(max_rows):
                ids = [
                    bases[k] + i * self._ROWS_PER_KIND[k] + r
                    for k, i in group
                    if r < self._ROWS_PER_KIND[k]
                ]
                phases.append(np.array(sorted(ids), dtype=np.int32))
        return tuple(phases), n_rows

    NP_VERTS = 12  # proxy-hull vertex budget for dyn-dyn narrowphase
    NP_TEST = 24  # test-point budget (verts + long-edge subdivision points)

    def _narrowphase_geometry(self, dyn_pairs: np.ndarray):
        """Proxy hulls + local-frame face planes for bodies in dyn pairs.

        Feet-sized hulls (48 verts, ~90 faces) would blow up the SAT stream;
        they are decimated to <= NP_VERTS extreme points (role of Bullet's
        btShapeHull, applied a second time for the pair narrowphase) and
        their coplanar-deduped faces are stored as (n, d) with n.x + d <= 0
        inside. The TEST-POINT set additionally subdivides the longest hull
        edges (up to NP_TEST points): a vertex-vs-hull test alone misses
        edge-face crossings (two elongated members crossing like an X have no
        vertex of either hull inside the other); surface points along long
        edges catch those contacts. Bodies not in any dyn pair get empty
        masks."""
        from scipy.spatial import ConvexHull

        from .shapes import reduce_to_hull

        nb = len(self.bodies)
        used = set(int(x) for x in dyn_pairs.flatten()) if len(dyn_pairs) else set()
        verts_per, faces_per, n_hull_verts = {}, {}, {}
        vmax = fmax = 1
        for i in sorted(used):
            pts = reduce_to_hull(self.bodies[i].hull, self.NP_VERTS)
            hull = ConvexHull(pts.astype(np.float64), qhull_options="QJ")
            eq = hull.equations
            uniq = []
            for e in eq:
                if not any(
                    np.allclose(e[:3], u[:3], atol=1e-4)
                    and abs(e[3] - u[3]) < 1e-4
                    for u in uniq
                ):
                    uniq.append(e)
            # surface test points: hull verts + subdivision of the longest
            # edges (split the current longest segment until the budget is
            # spent or segments get short relative to the body size)
            edges = set()
            for simplex in hull.simplices:
                for a_, b_ in ((0, 1), (1, 2), (2, 0)):
                    e_ = (min(simplex[a_], simplex[b_]), max(simplex[a_], simplex[b_]))
                    edges.add(e_)
            segs = [
                (float(np.linalg.norm(pts[e0] - pts[e1])), pts[e0], pts[e1])
                for e0, e1 in edges
            ]
            body_scale = float(np.linalg.norm(pts.max(0) - pts.min(0)))
            test_pts = [p for p in pts]
            import heapq

            heap = [(-l, k, a_, b_) for k, (l, a_, b_) in enumerate(segs)]
            heapq.heapify(heap)
            ctr = len(segs)
            while heap and len(test_pts) < self.NP_TEST:
                neg_l, _, a_, b_ = heapq.heappop(heap)
                if -neg_l < 0.35 * body_scale:
                    break  # remaining segments are short; points add little
                mid = (a_ + b_) / 2.0
                test_pts.append(mid)
                for half in ((a_, mid), (mid, b_)):
                    ctr += 1
                    heapq.heappush(
                        heap,
                        (-float(np.linalg.norm(half[0] - half[1])), ctr, *half),
                    )
            verts_per[i] = np.asarray(test_pts, dtype=np.float32)
            n_hull_verts[i] = len(pts)  # true hull verts precede test points
            faces_per[i] = np.array(uniq)
            vmax = max(vmax, len(test_pts))
            fmax = max(fmax, len(uniq))
        np_hull = np.zeros((nb, vmax, 3), dtype=np.float32)
        np_hull_mask = np.zeros((nb, vmax), dtype=np.float32)
        np_support_mask = np.zeros((nb, vmax), dtype=np.float32)
        np_face = np.zeros((nb, fmax, 4), dtype=np.float32)
        # unreal faces: a plane far below everything keeps max() harmless
        np_face[:, :, 1] = 1.0
        np_face[:, :, 3] = -1e9
        np_face_mask = np.zeros((nb, fmax), dtype=np.float32)
        for i in sorted(used):
            v, f = verts_per[i], faces_per[i]
            np_hull[i, : len(v)] = v
            np_hull[i, len(v):] = v[0]
            np_hull_mask[i, : len(v)] = 1.0
            np_support_mask[i, : n_hull_verts[i]] = 1.0
            np_face[i, : len(f)] = f
            np_face_mask[i, : len(f)] = 1.0
        return np_hull, np_hull_mask, np_support_mask, np_face, np_face_mask

    def _prune_unreachable_dyn_pairs(self, dyn_pairs: np.ndarray) -> np.ndarray:
        """Drop member pairs that provably can NEVER touch given joint limits
        (VERDICT r3 perf lever: the all-pairs list carries pairs whose
        narrowphase/solver rows are permanently dead weight in the sweep).

        Conservative kinematic bound over the hinge/fixed skeleton tree:
        with A held fixed, rotating a hinge j on the A–B path by at most its
        limit range swings everything on B's side of j along an arc of
        radius <= the rest-pose pivot-chain length from j to B's hull
        (pivot-to-pivot and pivot-to-hull distances are within single rigid
        bodies, hence configuration-invariant). If

            dist(c_A, c_B) - r_A - r_B - sum_j range_j * chainlen(j -> B)
                > margins + breaking threshold + safety

        the pair cannot collide in any reachable configuration. Joints that
        only further RESTRICT motion (muscle sliders/p2p) are ignored — that
        keeps the bound conservative. Pairs not connected through the
        hinge/fixed tree are always kept."""
        if not len(dyn_pairs):
            return dyn_pairs
        import collections

        # adjacency over hinge + fixed joints; edge payload = (swing range,
        # world pivot at rest)
        def world_pivot(body, local):
            b = self.bodies[body]
            return _quat_to_mat3(b.quat) @ np.asarray(local, float) + b.pos

        adj = collections.defaultdict(list)
        for h in self.hinge:
            a, b = h[0], h[1]
            lo, hi = h[6], h[7]
            swing = 2.0 * np.pi if lo > hi else min(hi - lo, 2.0 * np.pi)
            pv = world_pivot(a, h[2])
            adj[a].append((b, swing, pv))
            adj[b].append((a, swing, pv))
        for fx in self.fixed:
            a, b = fx[0], fx[1]
            pv = world_pivot(a, fx[2])
            adj[a].append((b, 0.0, pv))
            adj[b].append((a, 0.0, pv))

        def hull_center_radius(i):
            pts = self.bodies[i].hull
            c = self.bodies[i].pos  # hulls are origin-centered local points
            r = float(np.linalg.norm(pts, axis=1).max()) if len(pts) else 0.0
            return c, r

        def bfs_path(a, b):
            """Joint path a->b as a list of (swing, world_pivot); None if
            not connected."""
            prev = {a: None}
            q = collections.deque([a])
            while q:
                u = q.popleft()
                if u == b:
                    break
                for v, swing, pv in adj[u]:
                    if v not in prev:
                        prev[v] = (u, swing, pv)
                        q.append(v)
            if b not in prev:
                return None
            path = []
            u = b
            while prev[u] is not None:
                pu, swing, pv = prev[u]
                path.append((swing, pv))
                u = pu
            return path[::-1]  # a -> b order

        SAFETY = 0.05
        keep = np.ones(len(dyn_pairs), bool)
        for idx, (a, b) in enumerate(dyn_pairs):
            path = bfs_path(int(a), int(b))
            if path is None:
                continue  # free-floating relative motion: keep
            c_a, r_a = hull_center_radius(int(a))
            c_b, r_b = hull_center_radius(int(b))
            d0 = float(np.linalg.norm(c_a - c_b))
            # chain length from each joint's pivot to B's center: rest-pose
            # consecutive-pivot distances (rigid within a body)
            pivots = [pv for _, pv in path]
            disp = 0.0
            for j, (swing, pv) in enumerate(path):
                chain = 0.0
                for k_ in range(j, len(pivots) - 1):
                    chain += float(np.linalg.norm(pivots[k_ + 1] - pivots[k_]))
                chain += float(np.linalg.norm(c_b - pivots[-1])) + r_b
                disp += swing * chain
            clearance = d0 - r_a - r_b - disp
            margins = self.bodies[int(a)].margin + self.bodies[int(b)].margin
            if clearance > margins + 0.02 + SAFETY:  # 0.02 = breaking thresh
                keep[idx] = False
        return dyn_pairs[keep]

    def _color_dyn_pairs(self, dyn_pairs: np.ndarray) -> tuple:
        """Greedy-color dyn pairs so one color's pairs touch disjoint bodies
        (a valid vectorized Gauss-Seidel phase on the xla backend)."""
        colors: list[list[int]] = []
        colors_bodies: list[set[int]] = []
        for p, (a, b) in enumerate(dyn_pairs):
            bodies = {int(a), int(b)}
            for ci in range(len(colors)):
                if not (colors_bodies[ci] & bodies):
                    colors[ci].append(p)
                    colors_bodies[ci] |= bodies
                    break
            else:
                colors.append([p])
                colors_bodies.append(set(bodies))
        return tuple(np.array(c, dtype=np.int32) for c in colors)

    def finalize(self) -> PhysicsModel:
        colors = self._color_blocks()
        phases, n_rows = self._row_schedule(colors)
        if phases:
            max_rows = max(len(p) for p in phases)
            phase_table = np.full((len(phases), max_rows), n_rows, dtype=np.int32)
            row_phase_slot = np.zeros((n_rows, 2), dtype=np.int32)
            for i, p in enumerate(phases):
                phase_table[i, : len(p)] = p
                for s, rid in enumerate(p):
                    row_phase_slot[rid] = (i, s)
        else:
            phase_table = np.zeros((0, 1), dtype=np.int32)
            row_phase_slot = np.zeros((n_rows, 2), dtype=np.int32)
        nb = len(self.bodies)
        vmax = max((len(b.hull) for b in self.bodies), default=1)
        hull = np.zeros((nb, vmax, 3), dtype=np.float32)
        hull_mask = np.zeros((nb, vmax), dtype=np.float32)
        for i, b in enumerate(self.bodies):
            v = len(b.hull)
            hull[i, :v] = b.hull
            hull[i, v:] = b.hull[0]  # pad with a real point (keeps support fns exact)
            hull_mask[i, :v] = 1.0

        all_pairs = self._collision_pairs()
        if len(all_pairs):
            is_static = np.array([self.bodies[j].mass == 0.0 for j in all_pairs[:, 1]])
            dyn_pairs = all_pairs[~is_static]
        else:
            dyn_pairs = np.zeros((0, 2), dtype=np.int32)
        dyn_pairs = self._prune_unreachable_dyn_pairs(dyn_pairs)

        # narrowphase proxy hulls + local face planes for dyn-dyn SAT
        (np_hull, np_hull_mask, np_support_mask, np_face,
         np_face_mask) = self._narrowphase_geometry(dyn_pairs)
        dyn_pair_color = self._color_dyn_pairs(dyn_pairs)

        inertia = np.stack([self._inertia(b) for b in self.bodies])
        inv_inertia = np.where(inertia > 0, 1.0 / np.maximum(inertia, 1e-18), 0.0)
        mass = np.array([b.mass for b in self.bodies])
        inv_mass = np.where(mass > 0, 1.0 / np.maximum(mass, 1e-18), 0.0)

        def arr(lst, pick, dtype=np.float32, shape=()):
            if not lst:
                return np.zeros((0,) + shape, dtype=dtype)
            return np.array([pick(x) for x in lst], dtype=dtype)

        return PhysicsModel(
            n_bodies=nb,
            body_names=tuple(b.name for b in self.bodies),
            mass=mass.astype(np.float32),
            inv_mass=inv_mass.astype(np.float32),
            inv_inertia_local=inv_inertia.astype(np.float32),
            friction=np.array([b.friction for b in self.bodies], dtype=np.float32),
            restitution=np.array([b.restitution for b in self.bodies], dtype=np.float32),
            hull=hull,
            hull_mask=hull_mask,
            margin=np.array([b.margin for b in self.bodies], dtype=np.float32),
            init_pos=np.stack([b.pos for b in self.bodies]).astype(np.float32)
            if nb
            else np.zeros((0, 3), np.float32),
            init_quat=np.stack([b.quat for b in self.bodies]).astype(np.float32)
            if nb
            else np.zeros((0, 4), np.float32),
            p2p_body=arr(self.p2p, lambda c: c[:2], np.int32, (2,)),
            p2p_pivot=arr(self.p2p, lambda c: [c[2], c[3]], np.float32, (2, 3)),
            hinge_body=arr(self.hinge, lambda c: c[:2], np.int32, (2,)),
            hinge_pivot=arr(self.hinge, lambda c: [c[2], c[3]], np.float32, (2, 3)),
            hinge_frame_quat=arr(self.hinge, lambda c: [c[4], c[5]], np.float32, (2, 4)),
            hinge_limit=arr(self.hinge, lambda c: [c[6], c[7]], np.float32, (2,)),
            fixed_body=arr(self.fixed, lambda c: c[:2], np.int32, (2,)),
            fixed_pivot=arr(self.fixed, lambda c: [c[2], c[4]], np.float32, (2, 3)),
            fixed_frame_quat=arr(self.fixed, lambda c: [c[3], c[5]], np.float32, (2, 4)),
            slider_body=arr(self.slider, lambda c: c[:2], np.int32, (2,)),
            slider_pivot=arr(self.slider, lambda c: [c[2], c[4]], np.float32, (2, 3)),
            slider_frame_quat=arr(self.slider, lambda c: [c[3], c[5]], np.float32, (2, 4)),
            slider_lin_limit=arr(self.slider, lambda c: [c[6], c[7]], np.float32, (2,)),
            slider_max_motor_force=arr(self.slider, lambda c: c[8], np.float32),
            slider_motor_index=arr(self.slider, lambda c: c[9], np.int32),
            pair_body=all_pairs,
            dyn_pair_body=dyn_pairs.astype(np.int32),
            np_hull=np_hull,
            np_hull_mask=np_hull_mask,
            np_support_mask=np_support_mask,
            np_face=np_face,
            np_face_mask=np_face_mask,
            dyn_pair_color=dyn_pair_color,
            color_groups=colors,
            row_phases=phases,
            phase_table=phase_table,
            row_phase_slot=row_phase_slot,
            n_rows=n_rows,
            # Default CANONICAL since r5: the scheduled permutation measured
            # ~0 kernel gain while its row/lam gathers cost ~1.8 ms/step at
            # B=2048 (PERF.jsonl), and it was only pinned ON in r4 because
            # trained gaits overfit one solve order — r5 checkpoints train
            # under cycled orders and win under both (tests/test_walk_ckpt).
            # The pre-r5 EVOMOTION_ROW_SCHEDULE=1 switch still maps onto the
            # field; tools and checkpoint metadata override per model via
            # dataclasses.replace(model, row_order=...)
            row_order="canonical",
        )


def _shortest_arc_quat(v0: np.ndarray, v1: np.ndarray) -> np.ndarray:
    """btQuaternion shortestArcQuat: rotation taking v0 to v1 (xyzw)."""
    c = np.cross(v0, v1)
    d = float(v0 @ v1)
    if d < -1.0 + 1e-7:
        # pick any perpendicular axis
        n, _ = _plane_space(v0)
        return np.array([n[0], n[1], n[2], 0.0])
    s = np.sqrt((1.0 + d) * 2.0)
    q = np.array([c[0] / s, c[1] / s, c[2] / s, s * 0.5])
    return q / np.linalg.norm(q)


def _plane_space(n: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """btPlaneSpace1: two unit vectors orthogonal to n."""
    if abs(n[2]) > 0.70710678:
        a = n[1] * n[1] + n[2] * n[2]
        k = 1.0 / np.sqrt(a)
        p = np.array([0.0, -n[2] * k, n[1] * k])
        q = np.array([a * k, -n[0] * p[2], n[0] * p[1]])
    else:
        a = n[0] * n[0] + n[1] * n[1]
        k = 1.0 / np.sqrt(a)
        p = np.array([-n[1] * k, n[0] * k, 0.0])
        q = np.array([-n[2] * p[1], n[2] * p[0], a * k])
    return p, q

"""Physics constants, state, host-side model tables and the step entry point.

Port of ``evomotion_tpu/physics/engine.py``: the solver constants,
:class:`PhysicsState` and :class:`StepDiagnostics`, :func:`init_state`, the
numpy tables computed once per model (static face planes, per-row bodies,
hull edge directions and the sweeps' per-row metadata), and
:func:`physics_step`, which steps one world with the per-env step
(:mod:`.perenv`, the fat-row sweep) and a batch of worlds with the batched
step (:mod:`.batched`, the slim fused sweep), as the JAX function's
custom_vmap rule does.

Reference hot path: ``Environment::do_step`` -> ``btDiscreteDynamicsWorldMt::
stepSimulation`` (evo_motion_model/src/environment.cpp:33-43).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..kernels.sweep import KIND_FRICTION, KIND_JOINT, KIND_NORMAL
from .model import MAX_CONTACTS_PER_PAIR, PhysicsModel, _quat_to_mat3

GRAVITY = (0.0, -9.8, 0.0)  # environment.cpp:30
ERP = 0.2  # btContactSolverInfo m_erp (joints)
ERP2 = 0.8  # m_erp2 (contact position correction)
TURN_ERP = 0.1  # m_splitImpulseTurnErp
HINGE_LIMIT_BIAS = 0.3  # btHingeConstraint default _biasFactor
# Cap on limit-row correction velocity (rad/s resp. m/s); a documented
# divergence from Bullet, removed by strict_bullet (see the JAX engine).
LIMIT_BIAS_CAP = 3.0
CONTACT_BREAKING = 0.02  # gContactBreakingThreshold
WARMSTART = 0.85  # m_warmstartingFactor


class PhysicsState(NamedTuple):
    """Dynamic state of one world, or of a batch of worlds with the env axis
    FIRST (the layout of a vmapped JAX ``PhysicsState``)."""

    pos: torch.Tensor  # [B, NB, 3]
    quat: torch.Tensor  # [B, NB, 4] xyzw
    lin_vel: torch.Tensor  # [B, NB, 3]
    ang_vel: torch.Tensor  # [B, NB, 3]
    contact_lambda: torch.Tensor  # [B, NPAIR, K, 3] (normal, t1, t2)
    contact_vid: torch.Tensor  # [B, NPAIR, K] int32 hull-vertex id, -1 = empty
    joint_lambda: torch.Tensor  # [B, NRJ]
    dyn_lambda: torch.Tensor  # [B, NDC, 3]
    dyn_vid: torch.Tensor  # [B, NDC] int32 feature id, -1 = empty


class StepDiagnostics(NamedTuple):
    """Per-step solver outputs the observation layer reads (env axis first)."""

    slider_lin_pos: torch.Tensor  # [B, NS]
    slider_applied_impulse: torch.Tensor  # [B, NS]
    p2p_applied_impulse: torch.Tensor  # [B, NP2P]
    floor_contact: torch.Tensor  # [B, NB]


def default_solver() -> str:
    """The velocity-solver backend the envs build their models with.

    The port has one: the fused sequential sweep (``"pallas"`` in the JAX
    package's naming), a CUDA kernel on the card and its plain version on
    the CPU. The JAX package's colored-phase ``"xla"`` loop is not ported."""
    return "pallas"


def n_manifold_pairs(model: PhysicsModel) -> int:
    """Pairs that currently generate contact manifolds (body vs static)."""
    if len(model.pair_body) == 0:
        return 0
    return int((model.inv_mass[model.pair_body[:, 1]] == 0.0).sum())


def _n_dyn_contacts(model: PhysicsModel) -> int:
    """Member-member contact points (= normal rows) across all dyn pairs."""
    if not model.member_contacts:
        return 0
    return len(model.dyn_pair_body) * model.member_manifold_k


def init_state(model: PhysicsModel, n_envs: int, device) -> PhysicsState:
    """The model's build pose at rest, repeated over ``n_envs`` envs."""
    npair = n_manifold_pairs(model)
    k = MAX_CONTACTS_PER_PAIR
    ndc = _n_dyn_contacts(model)
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    nb = model.n_bodies
    return PhysicsState(
        pos=torch.as_tensor(model.init_pos, **f32).expand(n_envs, nb, 3).clone(),
        quat=torch.as_tensor(model.init_quat, **f32).expand(n_envs, nb, 4).clone(),
        lin_vel=torch.zeros((n_envs, nb, 3), **f32),
        ang_vel=torch.zeros((n_envs, nb, 3), **f32),
        contact_lambda=torch.zeros((n_envs, npair, k, 3), **f32),
        contact_vid=torch.full((n_envs, npair, k), -1, **i32),
        joint_lambda=torch.zeros((n_envs, model.n_rows), **f32),
        dyn_lambda=torch.zeros((n_envs, ndc, 3), **f32),
        dyn_vid=torch.full((n_envs, ndc), -1, **i32),
    )


# ---------------------------------------------------------------------------
# joint-row helpers (Bullet formulas, elementwise)
# ---------------------------------------------------------------------------


def _normalize_angle(a):
    """btNormalizeAngle: wrap to [-pi, pi] (jnp.mod semantics: floor)."""
    a = torch.remainder(a, 2 * math.pi)
    return torch.where(
        a < -math.pi, a + 2 * math.pi, torch.where(a > math.pi, a - 2 * math.pi, a)
    )


def _adjust_angle_to_limits(angle, lo, hi):
    """btAdjustAngleToLimits: shift by +/- 2*pi toward the nearer bound."""
    no_limit = lo >= hi
    below = angle < lo
    above = angle > hi
    diff_lo_b = torch.abs(_normalize_angle(lo - angle))
    diff_hi_b = torch.abs(_normalize_angle(hi - angle))
    adj_below = torch.where(diff_lo_b < diff_hi_b, angle, angle + 2 * math.pi)
    diff_hi_a = torch.abs(_normalize_angle(angle - hi))
    diff_lo_a = torch.abs(_normalize_angle(angle - lo))
    adj_above = torch.where(diff_hi_a < diff_lo_a, angle, angle - 2 * math.pi)
    return torch.where(
        no_limit, angle, torch.where(below, adj_below, torch.where(above, adj_above, angle))
    )


def _motor_factor(pos, lo, hi, vel, fps):
    """btTypedConstraint::getMotorFactor (ramp motor near limits)."""
    free = lo > hi
    locked = torch.abs(hi - lo) < 1e-12
    delta_max = vel / fps
    neg = delta_max < 0
    one = torch.ones_like(delta_max)
    lim_neg = torch.where(
        (pos >= lo) & (pos < lo - delta_max),
        (lo - pos) / torch.where(neg, delta_max, one),
        torch.where(pos < lo, 0.0, 1.0),
    )
    pose = delta_max > 0
    lim_pos = torch.where(
        (pos <= hi) & (pos > hi - delta_max),
        (hi - pos) / torch.where(pose, delta_max, one),
        torch.where(pos > hi, 0.0, 1.0),
    )
    fact = torch.where(neg, lim_neg, torch.where(pose, lim_pos, 0.0))
    return torch.where(free, 1.0, torch.where(locked, 0.0, fact))


# ---------------------------------------------------------------------------
# host-side model tables (numpy, computed once per model)
# ---------------------------------------------------------------------------


def _static_face_planes(model: PhysicsModel) -> tuple[np.ndarray, np.ndarray]:
    """World-space face planes of static bodies (they never move).

    Returns (planes [NB, F, 4] as (normal, offset) with n.x + d = dist, mask)."""
    from scipy.spatial import ConvexHull

    fmax = 1
    planes_per_body = []
    for i in range(model.n_bodies):
        if model.inv_mass[i] > 0:
            planes_per_body.append(np.zeros((0, 4)))
            continue
        pts = model.hull[i][model.hull_mask[i] > 0]
        q = model.init_quat[i]
        world = (_quat_to_mat3(q) @ pts.T).T + model.init_pos[i]
        hull = ConvexHull(world, qhull_options="QJ")
        eq = hull.equations  # n.x + d <= 0 inside
        uniq = []
        for e in eq:
            if not any(np.allclose(e, u, atol=1e-5) for u in uniq):
                uniq.append(e)
        planes_per_body.append(np.array(uniq))
        fmax = max(fmax, len(uniq))
    planes = np.zeros((model.n_bodies, fmax, 4), dtype=np.float32)
    mask = np.zeros((model.n_bodies, fmax), dtype=np.float32)
    for i, pl in enumerate(planes_per_body):
        planes[i, : len(pl)] = pl
        # unreal planes get offset pushing everything far outside
        planes[i, len(pl):] = np.array([0, 1, 0, -1e9])
        mask[i, : len(pl)] = 1.0
    return planes, mask


def _static_row_bodies(model: PhysicsModel) -> tuple[np.ndarray, np.ndarray]:
    """Per-row (body_a, body_b) in the canonical flat joint-row layout."""
    idx_a, idx_b = [], []

    def emit(a, b, count):
        idx_a.extend([int(a)] * count)
        idx_b.extend([int(b)] * count)

    for a, b in model.p2p_body:
        emit(a, b, 3)
    for a, b in model.hinge_body:
        emit(a, b, 6)
    for a, b in model.fixed_body:
        emit(a, b, 6)
    for a, b in model.slider_body:
        emit(a, b, 7)
    return np.array(idx_a, np.int32), np.array(idx_b, np.int32)


# near-duplicate manifold points closer than this are deduplicated (the
# best-K-of-2K merge can keep both directions' view of one contact)
DEDUP_TOL = 0.01
_EDGE_DIRS = 4  # default unique edge directions kept per proxy hull


def _get_hull_edges(model: PhysicsModel):
    """Per-body unique proxy-hull edge directions (local frame) for the
    edge-edge separating-axis test: ([NB, E, 3], [NB, E]) numpy.

    Directions are deduped up to sign (cos > 0.99) and ranked by total edge
    length, keeping the top E. Bodies outside every dyn pair get empty masks."""
    from scipy.spatial import ConvexHull, QhullError

    n_dirs = int(getattr(model, "member_edge_dirs", _EDGE_DIRS))
    nb = model.np_hull.shape[0]
    dirs = np.zeros((nb, n_dirs, 3), np.float32)
    mask = np.zeros((nb, n_dirs), np.float32)
    for i in range(nb):
        if model.np_hull_mask[i].sum() < 4:
            continue
        pts = model.np_hull[i][model.np_hull_mask[i] > 0].astype(np.float64)
        try:
            hull = ConvexHull(pts, qhull_options="QJ")
        except (QhullError, ValueError):
            continue
        acc: list[list] = []  # [unit dir, total length]
        for s in hull.simplices:
            for a_, b_ in ((0, 1), (1, 2), (2, 0)):
                v = pts[s[a_]] - pts[s[b_]]
                ln = float(np.linalg.norm(v))
                if ln < 1e-9:
                    continue
                d = v / ln
                for ent in acc:
                    if abs(float(np.dot(d, ent[0]))) > 0.99:
                        ent[1] += ln
                        break
                else:
                    acc.append([d, ln])
        acc.sort(key=lambda e: -e[1])
        for j, (dv, _) in enumerate(acc[:n_dirs]):
            dirs[i, j] = dv
            mask[i, j] = 1.0
    return dirs, mask


class SolverMeta(NamedTuple):
    """Static per-row metadata of a sweep (canonical row order)."""

    idx6_a: np.ndarray  # [NR] int32 body-A offset into vel6 (body * 6)
    idx6_b: np.ndarray  # [NR] int32
    parent: np.ndarray  # [NR] int32 friction parent row, -1 elsewhere
    mu: np.ndarray  # [NR] f32 friction coefficient
    kind: np.ndarray  # [NR] int32 KIND_*
    skip_b: np.ndarray  # [NR] bool: body B is static


def _solver_meta(model: PhysicsModel, kind: str, n_pair: int, n_dyn: int) -> SolverMeta:
    """Per-row sweep metadata in the canonical order.

    ``kind="full"``: the velocity sweep over joints | floor normals | member
    normals | floor frictions | member frictions (the batched step's fused
    sweep runs its push pass over the same normal rows). ``kind="push"``:
    the per-env step's split-impulse pass over floor normals | member
    normals only. ``n_dyn`` counts member contact points (pairs x
    member_manifold_k), flattened pair-major.

    Only the canonical order is ported: ``scheduled`` and ``shuffled:*``
    visit orders of the full sweep need the kernels' ``groups`` mode and the
    row permutation, a later slice (ROADMAP item 0)."""
    if kind not in ("full", "push"):
        raise ValueError(f"solver meta kind {kind!r}: 'full' or 'push'")
    order = getattr(model, "row_order", "scheduled")
    if kind == "full" and order != "canonical" and not model.strict_bullet:
        raise NotImplementedError(
            f"row_order={order!r}: only 'canonical' is ported (the scheduled "
            "and shuffled orders need the sweeps' groups mode, ROADMAP item 0)"
        )
    k = MAX_CONTACTS_PER_PAIR
    pair_np = model.pair_body
    static_sel = model.inv_mass[pair_np[:, 1]] == 0.0 if len(pair_np) else np.zeros(0, bool)
    body_np = pair_np[static_sel][:, 0] if len(pair_np) else np.zeros(0, np.int64)
    if n_dyn:
        dp = model.dyn_pair_body
        kd = n_dyn // len(dp)
        dyn_a = np.repeat(dp[:, 0], kd).astype(np.int32)
        dyn_b = np.repeat(dp[:, 1], kd).astype(np.int32)
    else:
        dyn_a = dyn_b = np.zeros((0,), np.int32)

    if kind == "push":
        n = n_pair * k + n_dyn
        return SolverMeta(
            idx6_a=np.concatenate([np.repeat(body_np, k) * 6, dyn_a * 6]).astype(np.int32),
            idx6_b=np.concatenate([np.zeros(n_pair * k, np.int32), dyn_b * 6]).astype(np.int32),
            parent=np.full(n, -1, np.int32),
            mu=np.zeros(n, np.float32),
            kind=np.full(n, KIND_NORMAL, np.int32),
            skip_b=np.concatenate([np.ones(n_pair * k, bool), np.zeros(n_dyn, bool)]),
        )

    nrj = model.n_rows
    ja, jb = _static_row_bodies(model)
    fric_np = (
        np.clip(model.friction[body_np] * model.friction[pair_np[static_sel][:, 1]], 0, 10)
        if len(body_np) else np.zeros(0, np.float32)
    )
    fric_dyn = np.clip(model.friction[dyn_a] * model.friction[dyn_b], 0, 10)
    idx6_a = np.concatenate(
        [ja * 6, np.repeat(body_np, k) * 6, dyn_a * 6,
         np.repeat(body_np, 2 * k) * 6, np.repeat(dyn_a, 2) * 6]
    ).astype(np.int32)
    idx6_b = np.concatenate(
        [jb * 6, np.zeros(n_pair * k, np.int32), dyn_b * 6,
         np.zeros(n_pair * 2 * k, np.int32), np.repeat(dyn_b, 2) * 6]
    ).astype(np.int32)
    floor_normal_ids = nrj + np.arange(n_pair * k)
    member_normal_ids = nrj + n_pair * k + np.arange(n_dyn)
    parent = np.concatenate(
        [
            np.full(nrj + n_pair * k + n_dyn, -1, np.int32),
            np.repeat(floor_normal_ids, 2).astype(np.int32),
            np.repeat(member_normal_ids, 2).astype(np.int32),
        ]
    )
    mu = np.concatenate(
        [
            np.zeros(nrj + n_pair * k + n_dyn, np.float32),
            np.repeat(fric_np, 2 * k).astype(np.float32),
            np.repeat(fric_dyn, 2).astype(np.float32),
        ]
    )
    kind_arr = np.concatenate(
        [
            np.full(nrj, KIND_JOINT, np.int32),
            np.full(n_pair * k + n_dyn, KIND_NORMAL, np.int32),
            np.full(n_pair * 2 * k + n_dyn * 2, KIND_FRICTION, np.int32),
        ]
    )
    # floor contact rows have a static body B: skip the B-side work
    skip_b = np.concatenate(
        [
            np.zeros(nrj, bool),
            np.ones(n_pair * k, bool), np.zeros(n_dyn, bool),
            np.ones(n_pair * 2 * k, bool), np.zeros(n_dyn * 2, bool),
        ]
    )
    return SolverMeta(idx6_a, idx6_b, parent, mu, kind_arr, skip_b)


# ---------------------------------------------------------------------------
# the step entry point
# ---------------------------------------------------------------------------


def physics_step(model: PhysicsModel, state: PhysicsState, motor_target, motor_enabled,
                 dt: float):
    """Advance one world, or a batch of worlds, by one fixed substep.

    One world (``state.pos`` is ``[NB, 3]``, ``motor_target`` ``[NS]``) runs
    the per-env step: fat rows and two calls of the fat-row sweep (the
    split-impulse push pass and the velocity sweep), dense member
    narrowphase. A batch (a leading env axis on every field) runs the
    batched step: slim rows and one call of the fused sweep, as the JAX
    function's custom_vmap rule routes a vmapped call. Both run on the
    device the state lies on. Each call builds its step object: a caller
    that steps one model many times builds :class:`.perenv.PerEnvStep` or
    :class:`.batched.BatchedStep` once and calls it, as the envs do."""
    from .batched import BatchedStep
    from .perenv import PerEnvStep

    dev = state.pos.device
    one_world = state.pos.dim() == 2
    cls = PerEnvStep if one_world else BatchedStep
    step = cls(model, dt, device=dev)
    if not one_world:
        return step(state, motor_target, motor_enabled)
    out_state, diag = step(PhysicsState(*(x[None] for x in state)), motor_target[None],
                           motor_enabled[None])
    return (PhysicsState(*(x[0] for x in out_state)),
            StepDiagnostics(*(x[0] for x in diag)))

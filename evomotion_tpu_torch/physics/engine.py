"""Physics constants, state, host-side model tables and the step entry point.

Port of ``evomotion_tpu/physics/engine.py``: the solver constants,
:class:`PhysicsState` and :class:`StepDiagnostics`, :func:`init_state`, the
numpy tables computed once per model (static face planes, per-row bodies,
hull edge directions and the sweeps' per-row metadata in the model's row
visit order), and
:func:`physics_step`, which steps one world with the per-env step
(:mod:`.perenv`, the fat-row sweep) and a batch of worlds with the batched
step (:mod:`.batched`, the slim fused sweep), as the JAX function's
custom_vmap rule does; a ``solver="xla"`` model takes the colored-phase
solves of :mod:`.phases` either way.

Reference hot path: ``Environment::do_step`` -> ``btDiscreteDynamicsWorldMt::
stepSimulation`` (evo_motion_model/src/environment.cpp:33-43).
"""

from __future__ import annotations

import math
import os
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
    """The velocity-solver backend the envs build their models with:
    ``"pallas"``, the fused sequential sweep, a CUDA kernel on the card and
    its plain version on the CPU (the JAX package's choice on its
    accelerator). The colored-phase ``"xla"`` branch (:mod:`.phases`, the
    JAX package's default off the TPU and the solver of the strict-Bullet
    artifact) is selected explicitly through ``model.solver``, e.g.
    ``env.model = dataclasses.replace(env.model, solver="xla")``."""
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
    """Static per-row metadata of a sweep, in visit order."""

    idx6_a: np.ndarray  # [NR] int32 body-A offset into vel6 (body * 6)
    idx6_b: np.ndarray  # [NR] int32
    parent: np.ndarray  # [NR] int32 friction parent row, -1 elsewhere
    mu: np.ndarray  # [NR] f32 friction coefficient
    kind: np.ndarray  # [NR] int32 KIND_*
    skip_b: np.ndarray  # [NR] bool: body B is static
    perm: np.ndarray | None = None  # [NR] int32 canonical row of each visit; None: canonical
    groups: tuple | None = None  # ((start, size), ...) disjoint-body groups of visits
    chunk: int | None = None  # the row chunk the groups were built and checked against


def row_chunk() -> int:
    """Rows per DMA chunk of the TPU kernels, which bounds the scheduled
    order's groups: ``EVOMOTION_PALLAS_CHUNK`` (default 8), read as the JAX
    package reads it, so that both packages make the same groups. Read once
    per :class:`SolverMeta`, which carries it to ``make_sweep_meta`` and
    ``make_fat_meta``."""
    return int(os.environ.get("EVOMOTION_PALLAS_CHUNK", "8"))


class RowOrder:
    """A sweep's visit order on the device: gathers canonical rows into
    visit order and scatters per-row results back (identity where
    ``perm`` is None, the canonical order). Built once per row set."""

    def __init__(self, perm, device):
        self.perm = self.inv = None
        if perm is not None:
            self.perm = torch.as_tensor(perm, dtype=torch.int64, device=device)
            self.inv = torch.argsort(self.perm)

    def to_visit(self, *xs):
        """Each ``x`` (canonical rows on dim 0) in visit order."""
        return xs if self.perm is None else tuple(x[self.perm] for x in xs)

    def to_canonical(self, x):
        """``x`` (visit-order rows on dim 0) back in canonical order."""
        return x if self.perm is None else x[self.inv]


def _schedule_rows(idx6_a, idx6_b, parent, skip_b, chunk=8):
    """Visit order and disjoint-body GROUPS of the ``scheduled`` row order
    (port of JAX ``engine._schedule_rows``, same greedy choices).

    Rows are packed chunk by chunk into groups whose rows touch pairwise
    disjoint dynamic bodies (body A, and body B unless ``skip_b``); a
    friction row becomes eligible once its parent normal sits in a CLOSED
    (earlier) group, and no group spans a chunk boundary. Within a chunk the
    next row is the one whose bodies were used least recently (earlier row
    first on ties). Returns (perm [N] int32, ((start, size), ...))."""
    n = len(idx6_a)
    a = idx6_a // 6
    bb = np.where(skip_b, -1, idx6_b // 6)
    last_use = np.full(int(max(a.max(), bb.max()) + 2), -(10**9), np.int64)
    scheduled = np.zeros(n, bool)
    parent_ok = parent < 0  # eligible once the parent's group is closed
    perm = np.empty(n, np.int64)
    groups = []
    order_bias = -np.arange(n) * 1e-9  # stable tie-break: earlier first
    t = 0
    while t < n:
        in_chunk = 0
        while in_chunk < chunk and t < n:
            group_start = t
            used = set()
            closed_parent_ok = parent_ok.copy()
            while in_chunk < chunk and t < n:
                score_a = t - last_use[a]
                score_b = np.where(bb >= 0, t - last_use[bb], 10**9)
                score = np.minimum(score_a, score_b).astype(np.float64) + order_bias
                score[scheduled] = -np.inf
                score[~closed_parent_ok] = -np.inf
                if used:
                    bad = np.isin(a, list(used)) | ((bb >= 0) & np.isin(bb, list(used)))
                    score[bad] = -np.inf
                v = int(np.argmax(score))
                if not np.isfinite(score[v]):
                    break  # nothing fits this group
                perm[t] = v
                scheduled[v] = True
                used.add(int(a[v]))
                if bb[v] >= 0:
                    used.add(int(bb[v]))
                last_use[a[v]] = t
                if bb[v] >= 0:
                    last_use[bb[v]] = t
                t += 1
                in_chunk += 1
            if t == group_start:
                # stuck: no candidate's parent is in the snapshot of closed
                # groups; recompute eligibility against every scheduled row
                # and emit a single-row group
                elig = ~scheduled & ((parent < 0) | scheduled[np.clip(parent, 0, n - 1)])
                v = int(np.nonzero(elig)[0][0])
                perm[t] = v
                scheduled[v] = True
                last_use[a[v]] = t
                if bb[v] >= 0:
                    last_use[bb[v]] = t
                t += 1
                in_chunk += 1
                groups.append((group_start, 1))
            else:
                groups.append((group_start, t - group_start))
            # a group closes: its rows' children become eligible
            parent_ok = parent_ok | ((parent >= 0) & scheduled[np.clip(parent, 0, n - 1)])
            if in_chunk >= chunk:
                in_chunk = 0
    return perm.astype(np.int32), tuple(groups)


def _shuffled_order(n, parent, seed: int) -> np.ndarray:
    """The ``shuffled:<seed>`` visit order (port of JAX
    ``engine._shuffled_order``): a seeded random permutation in which every
    friction row follows its parent normal, siblings in row order."""
    rng = np.random.RandomState(seed)
    keys = rng.rand(n)
    child = parent >= 0
    keys[child] = keys[np.clip(parent, 0, None)][child] + 1e-9 * (1.0 + np.arange(n)[child])
    return np.argsort(keys, kind="stable").astype(np.int32)


def _permuted(meta: SolverMeta, order: str) -> SolverMeta:
    """``meta`` in the visit order ``order`` ("scheduled" or "shuffled:<seed>"):
    per-row fields gathered by ``perm``, friction parents remapped through
    its inverse (JAX ``_solver_meta``'s non-canonical branch). The scheduled
    groups carry the chunk they were built for, and ``make_sweep_meta`` and
    ``make_fat_meta`` check them against it."""
    chunk = None
    if order == "scheduled":
        chunk = row_chunk()
        perm, groups = _schedule_rows(meta.idx6_a, meta.idx6_b, meta.parent, meta.skip_b,
                                      chunk)
    elif order.startswith("shuffled:"):
        perm, groups = _shuffled_order(len(meta.idx6_a), meta.parent,
                                       int(order.split(":")[1])), None
    else:
        raise ValueError(f"unknown row_order {order!r}")
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm), dtype=np.int32)
    old_parent = meta.parent[perm]
    parent = np.where(old_parent >= 0, inv[np.clip(old_parent, 0, None)], -1).astype(np.int32)
    return SolverMeta(meta.idx6_a[perm], meta.idx6_b[perm], parent, meta.mu[perm],
                      meta.kind[perm], meta.skip_b[perm], perm, groups, chunk)


def _solver_meta(model: PhysicsModel, kind: str, n_pair: int, n_dyn: int) -> SolverMeta:
    """Per-row sweep metadata, in the visit order of ``model.row_order``.

    ``kind="full"``: the velocity sweep over joints | floor normals | member
    normals | floor frictions | member frictions (the batched step's fused
    sweep runs its push pass over the same normal rows). ``kind="push"``:
    the per-env step's split-impulse pass over floor normals | member
    normals only. ``n_dyn`` counts member contact points (pairs x
    member_manifold_k), flattened pair-major.

    For ``kind="full"`` on a model that is not strict_bullet, a row order
    other than ``canonical`` (``scheduled``, ``shuffled:<seed>``) permutes
    the rows: ``perm`` gives the canonical row of each visit, and callers
    gather row data and initial impulses by it and scatter the impulses back
    through its inverse. ``scheduled`` also returns the disjoint-body
    ``groups`` the sweeps take. The order is read from the model as given
    (``finalize`` sets it). The push pass and strict_bullet models keep the
    canonical order, as in JAX."""
    if kind not in ("full", "push"):
        raise ValueError(f"solver meta kind {kind!r}: 'full' or 'push'")
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
    meta = SolverMeta(idx6_a, idx6_b, parent, mu, kind_arr, skip_b)
    order = getattr(model, "row_order", "scheduled")
    if order != "canonical" and not model.strict_bullet and len(idx6_a) > 1:
        meta = _permuted(meta, order)
    return meta


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
    function's custom_vmap rule routes a vmapped call. A ``solver="xla"``
    model runs the per-env step with the colored-phase solves in both
    cases, as JAX's vmap of that branch does. Both run on the
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

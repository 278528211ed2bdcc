"""Env-last batched physics step in PyTorch (port of ``evomotion_tpu/physics/batched.py``).

Every tensor keeps the env batch on the LAST axis (vectors ``[..., 3, B]``,
quaternions ``[..., 4, B]``), as the JAX module does, so the row streams come
out directly in the sweep kernel's coalesced layout ``[NR, 12, B]``.

The numerics follow the JAX module formula by formula: same row order, same
clamps, same deepest-K selection with first-index tie-breaking. Where the JAX
module gathers and scatters through one-hot contractions (a TPU lowering
workaround), this port uses index gathers (``torch.gather``, ``index_add_``);
the results are the same, not the formulation.

Entry points: :class:`BatchedStep` (env axis first, the counterpart of the
JAX custom_vmap rule ``vmapped_step``) and :func:`step_envlast`.

Reference: the ``stepSimulation`` hot path of
evo_motion_model/src/environment.cpp:41-43 (Bullet Mt world).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..device import resolve
from ..kernels import sweep as sp
from . import engine as E
from .maths import _ANGULAR_MOTION_THRESHOLD
from .model import MAX_CONTACTS_PER_PAIR, PhysicsModel

_INF = math.inf
_BIG = 1e9

# ---------------------------------------------------------------------------
# env-last math: vectors are [..., 3, B], quats [..., 4, B]
# ---------------------------------------------------------------------------


def _dot(a, b):
    return (a * b).sum(-2)


def _cross(a, b):
    ax, ay, az = a[..., 0, :], a[..., 1, :], a[..., 2, :]
    bx, by, bz = b[..., 0, :], b[..., 1, :], b[..., 2, :]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-2
    )


def _qmul(q1, q2):
    x1, y1, z1, w1 = q1[..., 0, :], q1[..., 1, :], q1[..., 2, :], q1[..., 3, :]
    x2, y2, z2, w2 = q2[..., 0, :], q2[..., 1, :], q2[..., 2, :], q2[..., 3, :]
    return torch.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        dim=-2,
    )


def _qconj(q):
    return torch.cat([-q[..., :3, :], q[..., 3:4, :]], dim=-2)


def _qrot(q, v):
    """Rotate v [..., 3, B] by q [..., 4, B] (same formula as maths.quat_rotate)."""
    qv = q[..., :3, :]
    w = q[..., 3:4, :]
    t = 2.0 * _cross(qv, v)
    return v + w * t + _cross(qv, t)


def _q2m(q):
    """Rotation matrix [..., 3, 3, B] from quat [..., 4, B]."""
    x, y, z, w = q[..., 0, :], q[..., 1, :], q[..., 2, :], q[..., 3, :]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    one = torch.ones_like(x)
    rows = [
        [one - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)],
        [2 * (xy + wz), one - 2 * (xx + zz), 2 * (yz - wx)],
        [2 * (xz - wy), 2 * (yz + wx), one - 2 * (xx + yy)],
    ]
    return torch.stack([torch.stack(r, dim=-2) for r in rows], dim=-3)


def _qnormalize(q, eps=1e-12):
    n = torch.sqrt((q * q).sum(-2, keepdim=True))
    return q / torch.clamp(n, min=eps)


def _qintegrate(q, omega, dt):
    """btTransformUtil::integrateTransform (mirrors maths.quat_integrate)."""
    angle = torch.sqrt((omega * omega).sum(-2, keepdim=True))
    limit = _ANGULAR_MOTION_THRESHOLD / dt
    angle = torch.clamp(angle, max=limit)
    half = angle * (dt * 0.5)
    small = angle * dt < 0.001
    factor = torch.where(
        small,
        0.5 * dt - (dt * dt * dt) * (1.0 / 48.0) * angle * angle,
        torch.sin(half) / torch.clamp(angle, min=1e-12),
    )
    axis = omega * factor
    dorn = torch.cat([axis, torch.cos(half)], dim=-2)
    return _qnormalize(_qmul(dorn, q))


def _plane_space(n):
    """btPlaneSpace1 for env-last normals [..., 3, B]."""
    nx, ny, nz = n[..., 0, :], n[..., 1, :], n[..., 2, :]
    use_z = torch.abs(nz) > 0.70710678
    a_z = ny * ny + nz * nz
    k_z = torch.rsqrt(torch.clamp(a_z, min=1e-18))
    p_z = torch.stack([torch.zeros_like(nx), -nz * k_z, ny * k_z], -2)
    q_z = torch.stack([a_z * k_z, -nx * p_z[..., 2, :], nx * p_z[..., 1, :]], -2)
    a_x = nx * nx + ny * ny
    k_x = torch.rsqrt(torch.clamp(a_x, min=1e-18))
    p_x = torch.stack([-ny * k_x, nx * k_x, torch.zeros_like(nx)], -2)
    q_x = torch.stack([-nz * p_x[..., 1, :], nz * p_x[..., 0, :], a_x * k_x], -2)
    uz = use_z[..., None, :]
    return torch.where(uz, p_z, p_x), torch.where(uz, q_z, q_x)


def _friction_dirs(n, rel_vel, strict):
    """Friction row directions: two fixed tangents, or (strict) one tangent
    along the lateral slip velocity with the second row disabled."""
    p1, p2 = _plane_space(n)
    if not strict:
        return p1, p2, 1.0
    lat = rel_vel - n * (rel_vel * n).sum(-2, keepdim=True)
    lat2 = (lat * lat).sum(-2, keepdim=True)
    t1 = torch.where(
        lat2 > 1.19209290e-07,
        lat * torch.rsqrt(torch.clamp(lat2, min=1e-30)),
        p1,
    )
    return t1, p2, 0.0


def _rot_error_vec(quat_fa_w, quat_fb_w):
    q_err = _qmul(quat_fb_w, _qconj(quat_fa_w))
    sign = torch.where(q_err[..., 3:4, :] < 0, -1.0, 1.0)
    return 2.0 * q_err[..., :3, :] * sign


# ---------------------------------------------------------------------------
# static model tables on the device (made once per model)
# ---------------------------------------------------------------------------


class Statics:
    """The model's static arrays as tensors on one device, plus the slim
    sweep's per-row metadata: everything the step reads that does not change."""

    def __init__(self, model: PhysicsModel, device):
        dev = torch.device(device)

        def f(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=dev)

        def i(x):
            return torch.as_tensor(np.asarray(x, np.int64), device=dev)

        dyn = (model.inv_mass > 0).astype(np.float32)[:, None, None]
        self.dyn = f(dyn)  # [NB, 1, 1]
        self.gravity = f(dyn * np.asarray(E.GRAVITY, np.float32)[None, :, None])
        self.inv_inertia_local = f(model.inv_inertia_local)  # [NB, 3]

        # joints: body index pairs and static frames, [N, 2, C, 1]
        for name in ("p2p", "hinge", "fixed", "slider"):
            body = getattr(model, f"{name}_body")
            setattr(self, f"{name}_a", i(body[:, 0]) if len(body) else None)
            setattr(self, f"{name}_b", i(body[:, 1]) if len(body) else None)
            setattr(self, f"{name}_piv", f(getattr(model, f"{name}_pivot"))[..., None])
            if name != "p2p":
                setattr(self, f"{name}_fq", f(getattr(model, f"{name}_frame_quat"))[..., None])
        self.eye = torch.eye(3, device=dev)[None, :, :, None]
        self.hinge_lo = f(model.hinge_limit[:, 0])[:, None]  # [NH, 1]
        self.hinge_hi = f(model.hinge_limit[:, 1])[:, None]
        self.slider_lo = f(model.slider_lin_limit[:, 0])[:, None]  # [NS, 1]
        self.slider_hi = f(model.slider_lin_limit[:, 1])[:, None]
        self.slider_max_f = f(model.slider_max_motor_force)[:, None]
        # joint rows read back for the diagnostics: slider axial rows (limit,
        # motor) and the three rows of each p2p
        s_ids = model.n_rows - 7 * model.n_slider + 7 * np.arange(model.n_slider)
        self.slider_rows = (i(s_ids + 5), i(s_ids + 6))
        p_ids = 3 * np.arange(model.n_p2p)
        self.p2p_rows = (i(p_ids), i(p_ids + 1), i(p_ids + 2))

        # floor (body vs static) contact pairs
        self.n_pair = E.n_manifold_pairs(model)
        if self.n_pair:
            planes_np, _ = E._static_face_planes(model)
            pair = model.pair_body
            pairs = pair[model.inv_mass[pair[:, 1]] == 0.0]
            self.fl_a = i(pairs[:, 0])
            self.fl_hull = f(model.hull[pairs[:, 0]])[..., None]  # [NP, V, 3, 1]
            self.fl_hmask = torch.as_tensor(model.hull_mask[pairs[:, 0]] > 0, device=dev)
            self.fl_pl3 = f(planes_np[pairs[:, 1]][..., :3])  # [NP, F, 3]
            self.fl_off = f(planes_np[pairs[:, 1]][..., 3])  # [NP, F]
            self.fl_marg = f(model.margin[pairs[:, 0]] + model.margin[pairs[:, 1]])
            self.fl_inv_m = f(model.inv_mass[pairs[:, 0]])[:, None, None, None]

        # member-member pairs
        self.n_dyn = E._n_dyn_contacts(model)
        if self.n_dyn:
            dp = model.dyn_pair_body
            hull, hmask = model.np_hull, model.np_hull_mask
            self.dp_a, self.dp_b = i(dp[:, 0]), i(dp[:, 1])
            brad = (np.linalg.norm(hull, axis=2) * (hmask > 0)).max(1) + np.asarray(
                model.margin
            )  # static bounding radius per body, margin included
            self.dp_brad = f(brad[dp[:, 0]] + brad[dp[:, 1]])  # [P]
            self.dp_marg = f(model.margin[dp[:, 0]] + model.margin[dp[:, 1]])  # [P]
            self.np_hull = f(hull)  # [NB, V, 3]
            self.np_hmask = f(hmask)  # [NB, V]
            self.np_face = f(model.np_face)  # [NB, F, 4]
            edirs, emask = E._get_hull_edges(model)
            self.edirs, self.emask = f(edirs), f(emask)
            kd = model.member_manifold_k
            self.md_a = i(np.repeat(dp[:, 0], kd))  # per contact point
            self.md_b = i(np.repeat(dp[:, 1], kd))
            self.md_inv_m_a = f(model.inv_mass[np.repeat(dp[:, 0], kd)])[:, None, None]
            self.md_inv_m_b = f(model.inv_mass[np.repeat(dp[:, 1], kd)])[:, None, None]

        # strict-mode joint warm start
        ja, jb = E._static_row_bodies(model)
        self.ja, self.jb = i(ja), i(jb)
        self.j_inv_m_a = f(model.inv_mass[ja])[:, None, None]
        self.j_inv_m_b = f(model.inv_mass[jb])[:, None, None]

        self._inv_mass = model.inv_mass
        self._dev = dev
        # the full sweep's rows in model.row_order's visit order
        self.full_meta = E._solver_meta(model, "full", self.n_pair, self.n_dyn)
        self.n_full = len(self.full_meta.idx6_a)
        self.row_order = E.RowOrder(self.full_meta.perm, dev)

    @functools.cached_property
    def sweep_meta(self):
        """The slim sweep's per-row metadata on the device, made at its first
        use: the per-env step shares these statics and never reads it."""
        meta = self.full_meta
        return sp.make_sweep_meta(
            self._inv_mass, meta.idx6_a, meta.idx6_b, meta.parent, meta.mu,
            meta.kind, meta.skip_b, self.n_full, self._dev, groups=meta.groups,
            chunk=meta.chunk,
        )


# ---------------------------------------------------------------------------
# row building
# ---------------------------------------------------------------------------


def _point_rows(pa, pb, com_a, com_b, dirs):
    """Point-coincidence rows; pivots/coms [N, 1, 3, B], dirs [N, D, 3, B].

    Returns (j [N, D, 4, 3, B], c [N, D, B])."""
    r_a = (pa - com_a).expand(dirs.shape)
    r_b = (pb - com_b).expand(dirs.shape)
    j = torch.stack(
        [dirs, _cross(r_a, dirs), -dirs, -_cross(r_b, dirs)], dim=-3
    )
    c = ((pa - pb) * dirs).sum(-2)
    return j, c


def _ang_rows(dirs):
    zeros = torch.zeros_like(dirs)
    return torch.stack([zeros, dirs, zeros, -dirs], dim=-3)


def _pack(j, rhs, lo, hi, rhs_push=None, j_dtype=torch.float32):
    """Slim two-stream rows: J columns [n, ROW_J, B] in j_dtype and f32
    scalars [n, ROW_S, B] (rhs, lo, hi, rhs_push). Row gating is folded into
    J by the callers (zeroed J -> eff 0 -> ie 0 -> no-op row)."""
    n, _, _, b = j.shape
    if rhs_push is None:
        rhs_push = torch.zeros_like(rhs)
    return (
        j.reshape(n, 12, b).to(j_dtype),
        torch.stack([rhs, lo, hi, rhs_push], dim=1),
    )


def _finish_dv(idx_a, idx_b, inv_m_a, inv_m_b, j, iinv_world):
    """Minv*J for flat rows j [NR, 4, 3, B] (warm-start application only)."""
    ii_a = iinv_world[idx_a]  # [NR, 3, 3, B]
    ii_b = iinv_world[idx_b]
    dva_lin = inv_m_a * j[:, 0]
    dva_ang = (ii_a * j[:, 1][:, None]).sum(2)
    dvb_lin = inv_m_b * j[:, 2]
    dvb_ang = (ii_b * j[:, 3][:, None]).sum(2)
    return torch.stack([dva_lin, dva_ang], 1), torch.stack([dvb_lin, dvb_ang], 1)


def build_joint_rows(model: PhysicsModel, st: Statics, pos, quat, motor_target,
                     motor_enabled, dt, j_dtype=torch.float32, bias_cap=E.LIMIT_BIAS_CAP):
    """All joint rows in the canonical order (p2p | hinge | fixed | slider);
    returns (j [NRJ, 12, B] in j_dtype, scalars [NRJ, 4, B], slider_lin_pos).

    ``bias_cap`` caps the limit rows' correction velocity. The JAX env-last
    step always caps it; the JAX per-env step lifts the cap for strict_bullet
    models (Bullet leaves it uncapped), so the per-env port passes inf there."""
    b = pos.shape[-1]
    dev = pos.device
    erp_dt = E.ERP / dt
    parts_j, parts_rhs, parts_lo, parts_hi = [], [], [], []

    def emit(j, rhs, lo, hi):
        nb_, rpb = rhs.shape[:2]
        parts_j.append(j.reshape(nb_ * rpb, 4, 3, b))
        parts_rhs.append(rhs.reshape(nb_ * rpb, b))
        for parts, x in ((parts_lo, lo), (parts_hi, hi)):
            x = x.expand(rhs.shape) if torch.is_tensor(x) else torch.full_like(rhs, x)
            parts.append(x.reshape(nb_ * rpb, b))

    def eye_dirs(n):
        return st.eye.expand(n, 3, 3, b)

    def frames(name):
        ia, ib = getattr(st, f"{name}_a"), getattr(st, f"{name}_b")
        piv = getattr(st, f"{name}_piv")  # [N, 2, 3, 1]
        pa = pos[ia] + _qrot(quat[ia], piv[:, 0])
        pb = pos[ib] + _qrot(quat[ib], piv[:, 1])
        return ia, ib, pa, pb

    def world_frames(name, ia, ib):
        fq = getattr(st, f"{name}_fq")  # [N, 2, 4, 1]
        qa_f = _qmul(quat[ia], fq[:, 0].expand(quat[ia].shape))
        qb_f = _qmul(quat[ib], fq[:, 1].expand(quat[ib].shape))
        return qa_f, qb_f

    # ---- p2p ----
    if model.n_p2p:
        ia, ib, pa, pb = frames("p2p")
        j, c = _point_rows(pa[:, None], pb[:, None], pos[ia][:, None], pos[ib][:, None],
                           eye_dirs(model.n_p2p))
        emit(j, -erp_dt * c, -_INF, _INF)

    # ---- hinge ----
    if model.n_hinge:
        ia, ib, pa, pb = frames("hinge")
        qa_f, qb_f = world_frames("hinge", ia, ib)
        ra = _q2m(qa_f)  # [N, 3, 3, B]
        rb = _q2m(qb_f)
        ax_a, p, q = ra[..., :, 2, :], ra[..., :, 0, :], ra[..., :, 1, :]
        ax_b = rb[..., :, 2, :]

        j_lin, c_lin = _point_rows(pa[:, None], pb[:, None], pos[ia][:, None],
                                   pos[ib][:, None], eye_dirs(model.n_hinge))
        u = _cross(ax_a, ax_b)
        dirs_ang = torch.stack([p, q], dim=1)
        j_ang = _ang_rows(dirs_ang)
        rhs_ang = erp_dt * (u[:, None] * dirs_ang).sum(-2)

        ref_x, ref_y = ra[..., :, 0, :], ra[..., :, 1, :]
        swing = rb[..., :, 1, :]
        angle = torch.arctan2(_dot(swing, ref_x), _dot(swing, ref_y))
        lo_l, hi_l = st.hinge_lo, st.hinge_hi
        angle = E._adjust_angle_to_limits(angle, lo_l, hi_l)
        has_limit = lo_l <= hi_l
        below = angle < lo_l
        above = angle > hi_l
        j_lim = _ang_rows(ax_a[:, None])[:, 0]
        corr = torch.where(below, lo_l - angle, torch.where(above, hi_l - angle, 0.0))
        rhs_lim = torch.clamp(E.HINGE_LIMIT_BIAS / dt * corr, -bias_cap, bias_cap)
        zero = torch.zeros_like(angle)
        lo_b = torch.where(has_limit & below, zero,
                           torch.where(has_limit & above, -_INF, zero))
        hi_b = torch.where(has_limit & below, _INF, zero)

        nh = model.n_hinge
        j_all = torch.cat([j_lin, j_ang, j_lim[:, None]], dim=1)
        rhs_all = torch.cat([-erp_dt * c_lin, rhs_ang, rhs_lim[:, None]], dim=1)
        lo_all = torch.cat(
            [torch.full((nh, 5, b), -_INF, device=dev), lo_b[:, None]], dim=1
        )
        hi_all = torch.cat(
            [torch.full((nh, 5, b), _INF, device=dev), hi_b[:, None]], dim=1
        )
        emit(j_all, rhs_all, lo_all, hi_all)

    # ---- fixed ----
    if model.n_fixed:
        ia, ib, pa, pb = frames("fixed")
        dirs = eye_dirs(model.n_fixed)
        j_lin, c_lin = _point_rows(pa[:, None], pb[:, None], pos[ia][:, None],
                                   pos[ib][:, None], dirs)
        qa_f, qb_f = world_frames("fixed", ia, ib)
        err = _rot_error_vec(qa_f, qb_f)
        j_ang = _ang_rows(dirs)
        rhs_ang = erp_dt * (err[:, None] * dirs).sum(-2)
        j_all = torch.cat([j_lin, j_ang], dim=1)
        rhs_all = torch.cat([-erp_dt * c_lin, rhs_ang], dim=1)
        emit(j_all, rhs_all, -_INF, _INF)

    # ---- slider ----
    slider_lin_pos = torch.zeros((model.n_slider, b), device=dev)
    if model.n_slider:
        ia, ib, pa, pb = frames("slider")
        qa_f, qb_f = world_frames("slider", ia, ib)
        ra = _q2m(qa_f)
        axis, p, q = ra[..., :, 0, :], ra[..., :, 1, :], ra[..., :, 2, :]

        delta = pb - pa
        lin_pos = _dot(delta, axis)
        slider_lin_pos = lin_pos

        dirs_perp = torch.stack([p, q], dim=1)
        j_perp, c_perp = _point_rows(
            pa[:, None], pb[:, None], pos[ia][:, None], pos[ib][:, None], dirs_perp
        )
        err = _rot_error_vec(qa_f, qb_f)
        dirs3 = eye_dirs(model.n_slider)
        j_ang = _ang_rows(dirs3)
        rhs_ang = erp_dt * (err[:, None] * dirs3).sum(-2)

        r_a = pa - pos[ia]
        r_b = pb - pos[ib]
        j_axial = torch.stack(
            [-axis, -_cross(r_a, axis), axis, _cross(r_b, axis)], dim=-3
        )
        lo_l, hi_l = st.slider_lo, st.slider_hi
        has_lim = lo_l <= hi_l
        locked = torch.abs(hi_l - lo_l) < 1e-9
        below = lin_pos < lo_l
        above = lin_pos > hi_l
        corr = torch.where(
            locked, lo_l - lin_pos,
            torch.where(below, lo_l - lin_pos,
                        torch.where(above, hi_l - lin_pos, 0.0)),
        )
        rhs_lim = torch.clamp(erp_dt * corr, -bias_cap, bias_cap)
        zero = torch.zeros_like(lin_pos)
        lo_b = torch.where(
            has_lim,
            torch.where(locked, -_INF,
                        torch.where(below, zero, torch.where(above, -_INF, zero))),
            zero,
        )
        hi_b = torch.where(
            has_lim,
            torch.where(locked, _INF, torch.where(below, _INF, zero)),
            zero,
        )
        mot_fact = E._motor_factor(lin_pos, lo_l, hi_l, motor_target, 1.0 / dt)
        rhs_mot = mot_fact * motor_target
        imp = torch.where(motor_enabled, st.slider_max_f * dt, zero)

        ns = model.n_slider
        j_all = torch.cat([j_perp, j_ang, j_axial[:, None], j_axial[:, None]], dim=1)
        rhs_all = torch.cat(
            [-erp_dt * c_perp, rhs_ang, rhs_lim[:, None], rhs_mot[:, None]], dim=1
        )
        lo_all = torch.cat(
            [torch.full((ns, 5, b), -_INF, device=dev), lo_b[:, None], -imp[:, None]], dim=1
        )
        hi_all = torch.cat(
            [torch.full((ns, 5, b), _INF, device=dev), hi_b[:, None], imp[:, None]], dim=1
        )
        emit(j_all, rhs_all, lo_all, hi_all)

    if parts_j:
        j = torch.cat(parts_j, 0)
        rhs = torch.cat(parts_rhs, 0)
        lo = torch.cat(parts_lo, 0)
        hi = torch.cat(parts_hi, 0)
    else:
        j = torch.zeros((0, 4, 3, b), device=dev)
        rhs = lo = hi = torch.zeros((0, b), device=dev)
    jj, ss = _pack(j, rhs, lo, hi, j_dtype=j_dtype)
    return jj, ss, slider_lin_pos


# ---------------------------------------------------------------------------
# contacts
# ---------------------------------------------------------------------------


def _gather_at(x, idx, dim: int):
    """x [*lead, N, *rest, B] at the per-env index idx [*lead, B] along
    ``dim`` (= len(lead)); returns x with that axis removed. The index
    broadcasts over ``rest``."""
    n_rest = x.dim() - dim - 2
    ind = idx.reshape(idx.shape[:-1] + (1,) * n_rest + (idx.shape[-1],)).unsqueeze(dim)
    shape = list(x.shape)
    shape[dim] = 1
    return torch.gather(x, dim, ind.expand(shape)).squeeze(dim)


def detect_contacts(model: PhysicsModel, st: Statics, pos, quat):
    """Hull-vertex vs static-face contacts, deepest K per pair (env-last).

    Returns (point [NP,K,3,B], normal [NP,K,3,B], gap [NP,K,B],
    active [NP,K,B] bool, vid [NP,K,B] int32)."""
    b = pos.shape[-1]
    k = MAX_CONTACTS_PER_PAIR
    dev = pos.device
    if st.n_pair == 0:
        z = torch.zeros((0, k, b), device=dev)
        return (
            torch.zeros((0, k, 3, b), device=dev), torch.zeros((0, k, 3, b), device=dev),
            z, z > 0, torch.zeros((0, k, b), dtype=torch.int32, device=dev),
        )
    ia = st.fl_a
    hull = st.fl_hull  # [NP, V, 3, 1]
    world = pos[ia][:, None] + _qrot(quat[ia][:, None], hull)  # [NP, V, 3, B]
    pl3 = st.fl_pl3  # [NP, F, 3]
    d = (
        world[:, :, None, 0, :] * pl3[:, None, :, 0, None]
        + world[:, :, None, 1, :] * pl3[:, None, :, 1, None]
        + world[:, :, None, 2, :] * pl3[:, None, :, 2, None]
    ) + st.fl_off[:, None, :, None]  # [NP, V, F, B]
    face = torch.argmax(d, dim=2)  # [NP, V, B]
    dist = torch.amax(d, dim=2)
    gap = dist - st.fl_marg[:, None, None]
    gap = torch.where(st.fl_hmask[:, :, None], gap, _BIG)

    # deepest-K selection along the vertex axis (iterative argmin, first
    # index on ties, as lax.top_k(-gap))
    g = gap
    sel_gap, sel_pt, sel_n, vids = [], [], [], []
    for _ in range(k):
        vid = torch.argmin(g, dim=1)  # [NP, B]
        sel_gap.append(_gather_at(g, vid, 1))
        sel_pt.append(_gather_at(world, vid, 1))  # [NP, 3, B]
        f_sel = _gather_at(face, vid, 1)  # [NP, B]
        n_sel = pl3[torch.arange(len(pl3), device=dev)[:, None], f_sel]  # [NP, B, 3]
        sel_n.append(n_sel.permute(0, 2, 1))
        vids.append(vid.to(torch.int32))
        g = g.scatter(1, vid[:, None], _BIG)

    gap_k = torch.stack(sel_gap, dim=1)  # [NP, K, B]
    pt_k = torch.stack(sel_pt, dim=1)  # [NP, K, 3, B]
    n_k = torch.stack(sel_n, dim=1)
    vid_k = torch.stack(vids, dim=1)
    active = gap_k < E.CONTACT_BREAKING
    return pt_k, n_k, gap_k, active, vid_k


# ---------------------------------------------------------------------------
# member-member narrowphase
# ---------------------------------------------------------------------------


def _select_pairs(model: PhysicsModel, st: Statics, pos):
    """Per env, the ``member_topm`` pairs of smallest conservative clearance
    (center distance minus bounding radii, margins included): [M, B].

    The JAX path selects with ``lax.top_k(-clear)``, which orders equal
    clearances by pair index; a stable ascending sort keeps that order."""
    ca = pos[st.dp_a]  # [P, 3, B]
    cb = pos[st.dp_b]
    clear = torch.sqrt(((ca - cb) ** 2).sum(1)) - st.dp_brad[:, None]  # [P, B]
    order = torch.sort(clear, dim=0, stable=True).indices
    return order[: int(model.member_topm)]


def _dyn_narrowphase_sel(model: PhysicsModel, st: Statics, pos, quat, sel=None):
    """Up-to-K SAT contacts for the member pairs ``sel`` [M, B] of each env
    (default: the top-M cull of :func:`_select_pairs`), scattered back to the
    canonical pair slots.

    For every selected pair: the K deepest proxy-hull vertices of each body
    against the other's faces (in the vertex body's frame), the K deepest of
    those 2K, a near-duplicate dedup, then the edge-edge separating-axis
    test. Unselected pairs get gap=+1e9 and vid=-1, the inactive manifold a
    beyond-margin pair gets.

    Returns (point [P,K,3,B], normal [P,K,3,B] from B toward A, gap [P,K,B],
    vid [P,K,B] int32)."""
    if sel is None:
        sel = _select_pairs(model, st, pos)
    kd = model.member_manifold_k
    b = pos.shape[-1]
    npair = len(model.dyn_pair_body)
    m_sel = sel.shape[0]
    nv = st.np_hull.shape[1]
    dev = pos.device

    body_a = st.dp_a[sel]  # [M, B]
    body_b = st.dp_b[sel]

    def _body(idx, arr):  # [NB, C, B] at per-env bodies -> [M, C, B]
        return torch.gather(arr, 0, idx[:, None, :].expand(m_sel, arr.shape[1], b))

    def _tab(idx, tab):  # static [NB, ...] at per-env bodies -> [M, ..., B]
        t = tab[idx]  # [M, B, ...]
        return t.movedim(1, -1)

    pos_a, pos_b = _body(body_a, pos), _body(body_b, pos)
    quat_a, quat_b = _body(body_a, quat), _body(body_b, quat)

    def _hull_xyz(idx, lim=None):
        h = st.np_hull[:, :lim] if lim else st.np_hull
        return [_tab(idx, h[:, :, c]) for c in range(3)]  # 3 x [M, V, B]

    def deepest(qw, pw, hw_xyz, hw_m, qf, pf, nl, dl):
        """K deepest verts of body W against faces of body F, W-local frame."""
        q_rel = _qmul(_qconj(qf), qw)  # [M, 4, B]
        t_rel = _qrot(_qconj(qf), pw - pf)  # [M, 3, B]
        nrot = _qrot(_qconj(q_rel)[:, None], nl)  # [M, F, 3, B]
        doff = (nl * t_rel[:, None]).sum(-2) + dl  # [M, F, B]
        hx, hy, hz = (h[:, :, None] for h in hw_xyz)  # [M, V, 1, B]
        d = (
            hx * nrot[:, None, :, 0, :]
            + hy * nrot[:, None, :, 1, :]
            + hz * nrot[:, None, :, 2, :]
            + doff[:, None]
        )  # [M, V, F, B]
        dist = torch.amax(d, dim=2)  # [M, V, B]
        fid = torch.argmax(d, dim=2)
        dist = torch.where(hw_m > 0, dist, _BIG)
        pen_face = (
            -torch.amax(torch.amin(d, 1), 1) if model.member_edge_contacts else None
        )  # [M, B]

        pts, nrms, gaps, vids = [], [], [], []
        g = dist
        for _ in range(kd):
            v_id = torch.argmin(g, dim=1)  # [M, B]
            gaps.append(_gather_at(g, v_id, 1))
            vids.append(v_id.to(torch.float32))
            hsel = torch.stack([_gather_at(h, v_id, 1) for h in hw_xyz], 1)
            pts.append(pw + _qrot(qw, hsel))  # world
            f_sel = _gather_at(fid, v_id, 1)  # [M, B]
            nl_sel = _gather_at(nl, f_sel, 1)  # [M, 3, B]
            nrms.append(_qrot(qf, nl_sel))  # world
            g = g.scatter(1, v_id[:, None], _BIG)
        return (
            torch.stack(pts, 1), torch.stack(nrms, 1), torch.stack(gaps, 1),
            torch.stack(vids, 1), pen_face,
        )

    face = st.np_face
    nl_a = _tab(body_a, face[..., :3])  # [M, F, 3, B]
    dl_a = _tab(body_a, face[..., 3])  # [M, F, B]
    nl_b = _tab(body_b, face[..., :3])
    dl_b = _tab(body_b, face[..., 3])
    hx_a, hm_a = _hull_xyz(body_a), _tab(body_a, st.np_hmask)
    hx_b, hm_b = _hull_xyz(body_b), _tab(body_b, st.np_hmask)

    pt1, nrm1, gap1, vid1, pen_face1 = deepest(
        quat_b, pos_b, hx_b, hm_b, quat_a, pos_a, nl_a, dl_a
    )  # B's verts in A's faces
    pt2, nrm2, gap2, vid2, pen_face2 = deepest(
        quat_a, pos_a, hx_a, hm_a, quat_b, pos_b, nl_b, dl_b
    )  # A's verts in B's faces

    # contact normal points from B toward A
    cand_pt = torch.cat([pt1, pt2], 1)  # [M, 2K, 3, B]
    cand_n = torch.cat([-nrm1, nrm2], 1)
    cand_gap = torch.cat([gap1, gap2], 1)
    cand_vid = torch.cat([vid1, nv + vid2], 1)

    pts, nrms, gaps, vids = [], [], [], []
    g = cand_gap
    for _ in range(kd):
        c_id = torch.argmin(g, dim=1)
        gaps.append(_gather_at(g, c_id, 1))
        pts.append(_gather_at(cand_pt, c_id, 1))
        nrms.append(_gather_at(cand_n, c_id, 1))
        vids.append(_gather_at(cand_vid, c_id, 1))
        g = g.scatter(1, c_id[:, None], _BIG)

    point = torch.stack(pts, 1)  # [M, K, 3, B]
    n = torch.stack(nrms, 1)
    raw_gap = torch.stack(gaps, 1)  # [M, K, B]
    vid = torch.stack(vids, 1)

    # near-duplicate dedup: deactivate a point within DEDUP_TOL of an
    # earlier (deeper) selection
    d2 = ((point[:, :, None] - point[:, None, :]) ** 2).sum(3)  # [M, K, K, B]
    ar = torch.arange(kd, device=dev)
    later = (ar[None, :, None] > ar[None, None, :])[..., None]
    raw_gap = torch.where(((d2 < E.DEDUP_TOL**2) & later).any(2), _BIG, raw_gap)

    marg = st.dp_marg[sel]  # [M, B]
    covered = torch.zeros((npair, b), device=dev).scatter(0, sel, 1.0)

    def _scatter(vals):  # [M, K(, 3), B] -> [P, K(, 3), B], 0 elsewhere
        idx = sel.reshape((m_sel,) + (1,) * (vals.dim() - 2) + (b,)).expand(vals.shape)
        out = torch.zeros((npair,) + tuple(vals.shape[1:]), device=dev)
        return out.scatter(0, idx, vals)

    def _finish(point, n, raw_gap, vid):
        gap = raw_gap - marg[:, None]
        vid = torch.where(raw_gap > 1e8, -1.0, vid)
        un = (1.0 - covered)[:, None]  # [P, 1, B]: unselected slots
        point_f = _scatter(point)
        # unselected slots keep a unit normal so _friction_dirs stays finite
        # (their act=0 zeroes the rows regardless)
        n_f = _scatter(n)
        n_f[:, :, 2, :] += un
        gap_f = _scatter(gap) + un * _BIG
        vid_f = _scatter(vid) - un
        return point_f, n_f, gap_f, torch.round(vid_f).to(torch.int32)

    if not model.member_edge_contacts:
        return _finish(point, n, raw_gap, vid)

    ed_a = _tab(body_a, st.edirs)  # [M, E, 3, B]
    ed_b = _tab(body_b, st.edirs)
    em_a = _tab(body_a, st.emask)  # [M, E, B]
    em_b = _tab(body_b, st.emask)
    ea = _qrot(quat_a[:, None], ed_a)  # [M, E, 3, B] world
    eb = _qrot(quat_b[:, None], ed_b)
    cr = _cross(ea[:, :, None], eb[:, None, :])  # [M, E, E, 3, B]
    cr_len = torch.sqrt((cr * cr).sum(3))
    cr_ok = (cr_len > 1e-6) & (em_a[:, :, None] > 0) & (em_b[:, None, :] > 0)
    ne = st.edirs.shape[1]
    e_axes = (cr / torch.clamp(cr_len, min=1e-12)[:, :, :, None]).reshape(
        m_sel, ne * ne, 3, b
    )
    e_ok = cr_ok.reshape(m_sel, ne * ne, b)

    nsupp = min(12, nv)
    hs_a = _hull_xyz(body_a, lim=nsupp)  # 3 x [M, S, B]
    hs_b = _hull_xyz(body_b, lim=nsupp)
    ms_a = _tab(body_a, st.np_hmask[:, :nsupp])
    ms_b = _tab(body_b, st.np_hmask[:, :nsupp])

    def _supports(h_xyz, m_, axes_local):
        """[M,Q,3,B] local axes -> (min, max) projections [M,Q,B]."""
        hx, hy, hz = (h[:, None] for h in h_xyz)  # [M, 1, S, B]
        proj = (
            hx * axes_local[:, :, None, 0, :]
            + hy * axes_local[:, :, None, 1, :]
            + hz * axes_local[:, :, None, 2, :]
        )  # [M, Q, S, B]
        mm = m_[:, None] > 0
        return (
            torch.amin(torch.where(mm, proj, _BIG), 2),
            torch.amax(torch.where(mm, proj, -_BIG), 2),
        )

    def sat_overlap(axes_w, ok):
        amin, amax = _supports(hs_a, ms_a, _qrot(_qconj(quat_a)[:, None], axes_w))
        bmin, bmax = _supports(hs_b, ms_b, _qrot(_qconj(quat_b)[:, None], axes_w))
        oa = (axes_w * pos_a[:, None]).sum(2)
        ob = (axes_w * pos_b[:, None]).sum(2)
        overlap = torch.minimum(oa + amax, ob + bmax) - torch.maximum(oa + amin, ob + bmin)
        return torch.where(ok, overlap, _BIG)

    pen_f = torch.minimum(pen_face1, pen_face2)  # [M, B]
    pen_edges = sat_overlap(e_axes, e_ok)
    e_best = torch.argmin(pen_edges, dim=1)  # [M, B]
    pen_e = _gather_at(pen_edges, e_best, 1)
    ax_e = _gather_at(e_axes, e_best, 1)  # [M, 3, B]
    sgn = torch.sign((ax_e * (pos_a - pos_b)).sum(1))
    ax_e = ax_e * torch.where(sgn == 0.0, 1.0, sgn)[:, None]

    la_e = _qrot(_qconj(quat_a), ax_e)
    lb_e = _qrot(_qconj(quat_b), ax_e)

    def _support_pt(h_xyz, m_, axis_local, take_max):
        proj = (
            h_xyz[0] * axis_local[:, None, 0, :]
            + h_xyz[1] * axis_local[:, None, 1, :]
            + h_xyz[2] * axis_local[:, None, 2, :]
        )  # [M, S, B]
        proj = torch.where(m_ > 0, proj, -_BIG if take_max else _BIG)
        v_id = (torch.argmax if take_max else torch.argmin)(proj, dim=1)
        return torch.stack([_gather_at(h, v_id, 1) for h in h_xyz], 1)  # [M, 3, B]

    sa = pos_a + _qrot(quat_a, _support_pt(hs_a, ms_a, la_e, False))
    sb = pos_b + _qrot(quat_b, _support_pt(hs_b, ms_b, lb_e, True))
    da = _gather_at(ea, torch.div(e_best, ne, rounding_mode="floor"), 1)  # [M, 3, B]
    db = _gather_at(eb, e_best % ne, 1)
    r_ab = sa - sb
    b_dd = (da * db).sum(1)
    d_dr = (da * r_ab).sum(1)
    e_dr = (db * r_ab).sum(1)
    denom = 1.0 - b_dd * b_dd
    safe = torch.abs(denom) > 1e-9
    one = torch.ones_like(denom)
    t1 = torch.where(safe, (b_dd * e_dr - d_dr) / torch.where(safe, denom, one), 0.0)
    t2 = torch.where(safe, (e_dr - b_dd * d_dr) / torch.where(safe, denom, one), 0.0)
    pt_e = 0.5 * (sa + t1[:, None] * da + sb + t2[:, None] * db)

    use_edge = (pen_e < _BIG / 2) & (pen_e > 0) & (pen_e < 0.95 * pen_f)  # [M, B]
    ue3 = use_edge[:, None, None]
    point_e = point.clone()
    point_e[:, 0] = pt_e
    point = torch.where(ue3, point_e, point)
    n_e = n.clone()
    n_e[:, 0] = ax_e
    n = torch.where(ue3, n_e, n)
    vid_e = vid.clone()
    vid_e[:, 0] = float(2 * nv) + e_best.to(torch.float32)
    vid = torch.where(use_edge[:, None], vid_e, vid)
    edge_gap = raw_gap.clone()
    edge_gap[:, 0] = -pen_e
    if kd > 1:
        edge_gap[:, 1:] = _BIG
    raw_gap = torch.where(use_edge[:, None], edge_gap, raw_gap)
    return _finish(point, n, raw_gap, vid)


def _dyn_narrowphase(model: PhysicsModel, st: Statics, pos, quat):
    """Up-to-K SAT contacts per member pair: the top-M cull when
    ``0 < member_topm < P``, else every pair (dense)."""
    npair = len(model.dyn_pair_body)
    topm = int(getattr(model, "member_topm", 0) or 0)
    if 0 < topm < npair:
        return _dyn_narrowphase_sel(model, st, pos, quat)
    sel = torch.arange(npair, device=pos.device)[:, None].expand(npair, pos.shape[-1])
    return _dyn_narrowphase_sel(model, st, pos, quat, sel=sel)


def _dyn_warm_match(kd: int, vid, act, dyn_vid, dyn_lambda):
    """Member contacts' warm-start impulses: this step's feature ids vid
    [NDC, B] matched against the cached ones within each pair, the cached
    impulses (x WARMSTART) carried for active persisting contacts: [NDC, 3, B]."""
    b = vid.shape[-1]
    old_vid = dyn_vid.reshape(-1, kd, b)
    old_lam = dyn_lambda.reshape(-1, kd, 3, b)
    newv = vid.reshape(-1, kd, b)
    match = (newv[:, :, None] == old_vid[:, None, :]) & (old_vid[:, None, :] >= 0)
    lam = (match[:, :, :, None].to(torch.float32) * old_lam[:, None]).sum(2)
    lam = lam.reshape(-1, 3, b)
    return torch.where(act[:, None] > 0, lam * E.WARMSTART, 0.0)


def _member_contact_rows(model: PhysicsModel, st: Statics, pos, quat, lin_vel, ang_vel,
                         iinv_world, dt, warm_cache=None, j_dtype=torch.float32):
    """Member-member contact rows (pairs x member_manifold_k points, pair-major).

    Returns (normal (j, s), friction (j, s), extras) two-stream row parts,
    the split-impulse rhs carried in the normal rows' scalars."""
    kd = model.member_manifold_k
    b = pos.shape[-1]
    dev = pos.device
    ia, ib = st.md_a, st.md_b
    point, n, gap, vid = _dyn_narrowphase(model, st, pos, quat)
    point = point.reshape(-1, 3, b)
    n = n.reshape(-1, 3, b)
    gap = gap.reshape(-1, b)
    vid = vid.reshape(-1, b)
    act = (gap < E.CONTACT_BREAKING).to(torch.float32)

    rel_a = point - pos[ia]
    rel_b = point - pos[ib]

    def rows_for(d):
        # gating folds into J (slim layout: zeroed J -> no-op row)
        ja_ang = _cross(rel_a, d)
        jb_ang = -_cross(rel_b, d)
        return torch.stack([d, ja_ang, -d, jb_ang], dim=1) * act[:, None, None]

    ndc = len(model.dyn_pair_body) * kd
    jn_m = rows_for(n)
    rhs_n = torch.where(gap > 0, -gap / dt, 0.0)
    rhs_push = torch.where(gap < 0, -gap * E.ERP2 / dt, 0.0)
    zeros = torch.zeros((ndc, b), device=dev)
    inf_ = torch.full((ndc, b), _INF, device=dev)
    normal_rows = _pack(jn_m, rhs_n, zeros, inf_, rhs_push, j_dtype=j_dtype)

    rel_vel = (
        lin_vel[ia] + _cross(ang_vel[ia], rel_a)
        - lin_vel[ib] - _cross(ang_vel[ib], rel_b)
    )
    t1, t2, t2_en = _friction_dirs(n, rel_vel, model.strict_bullet)
    fr = []
    for ti, d in enumerate((t1, t2)):
        en = 1.0 if ti == 0 else t2_en
        fr.append(_pack(rows_for(d) * en, zeros, zeros, zeros, j_dtype=j_dtype))
    friction_rows = (
        torch.stack([f[0] for f in fr], dim=1).reshape(ndc * 2, -1, b),
        torch.stack([f[1] for f in fr], dim=1).reshape(ndc * 2, -1, b),
    )
    extras = {"act": act, "vid": vid}
    if warm_cache is not None:
        # persistent warm start: match feature ids, carry impulses, add
        # their velocity contribution
        warm = _dyn_warm_match(kd, vid, act, *warm_cache)
        lam_n0 = warm[:, 0]
        lam_t0 = warm[:, 1:]
        ja_n, jb_n = _cross(rel_a, n), -_cross(rel_b, n)
        ja_1, jb_1 = _cross(rel_a, t1), -_cross(rel_b, t1)
        ja_2, jb_2 = _cross(rel_a, t2), -_cross(rel_b, t2)
        inv_m_a, inv_m_b = st.md_inv_m_a, st.md_inv_m_b
        ii_a = iinv_world[ia]
        ii_b = iinv_world[ib]

        def _imp(d, ja, jb, lam_):
            la = lam_[:, None]
            return (
                torch.cat([inv_m_a * d, (ii_a * ja[:, None]).sum(2)], 1) * la,
                torch.cat([-inv_m_b * d, (ii_b * jb[:, None]).sum(2)], 1) * la,
            )

        ia6, ib6 = _imp(n, ja_n, jb_n, lam_n0)
        for d, ja, jb, lam_ in (
            (t1, ja_1, jb_1, lam_t0[:, 0]),
            (t2 * t2_en, ja_2 * t2_en, jb_2 * t2_en, lam_t0[:, 1]),
        ):
            xa, xb = _imp(d, ja, jb, lam_)
            ia6 = ia6 + xa
            ib6 = ib6 + xb
        imp6 = torch.zeros((model.n_bodies, 6, b), device=dev)
        extras["imp6"] = imp6.index_add(0, ia, ia6).index_add(0, ib, ib6)
        extras["lam_n0"] = lam_n0
        extras["lam_t0"] = lam_t0
    return normal_rows, friction_rows, extras


# ---------------------------------------------------------------------------
# the full step
# ---------------------------------------------------------------------------


def _j_dtype(model: PhysicsModel):
    """J-column dtype of the streamed rows: bf16 is the throughput
    configuration; strict parity always keeps f32."""
    if getattr(model, "row_dtype", "f32") == "bf16" and not model.strict_bullet:
        return torch.bfloat16
    return torch.float32


def _iinv_world(st: Statics, quat):
    """World inverse inertia R diag(inv_inertia_local) R^T: [NB, 3, 3, B]."""
    rot = _q2m(quat)  # [NB, 3, 3, B]
    return (rot[:, :, None] * st.inv_inertia_local[:, None, None, :, None] * rot[:, None]).sum(3)


def _warm_start_match(vid_k, active, contact_vid, contact_lambda):
    """Floor contacts' warm-start impulses: cached impulses (x WARMSTART) of
    the points whose hull-vertex id persists, zero for inactive points:
    [NP, K, 3, B]."""
    match = (vid_k[:, :, None] == contact_vid[:, None, :]) & (contact_vid[:, None, :] >= 0)
    warm = (match[:, :, :, None].to(torch.float32) * contact_lambda[:, None]).sum(2)
    return torch.where(active[:, :, None], warm * E.WARMSTART, 0.0)


def step_envlast(model: PhysicsModel, st: Statics, dt: float, pos, quat, lin_vel,
                 ang_vel, contact_lambda, contact_vid, joint_lambda, dyn_lambda,
                 dyn_vid, motor_target, motor_enabled):
    """One substep for B envs, env axis last everywhere.

    pos [NB,3,B], quat [NB,4,B], vels [NB,3,B], contact_lambda [NP,K,3,B],
    contact_vid [NP,K,B], joint_lambda [NRJ,B], dyn_lambda [NDC,3,B],
    dyn_vid [NDC,B], motor_target/enabled [NS,B]. Returns the same state
    tuple plus env-last diagnostics (slider_lin_pos, slider_applied_impulse,
    p2p_applied_impulse, floor_contact)."""
    b = pos.shape[-1]
    dev = pos.device
    k = MAX_CONTACTS_PER_PAIR
    n_pair = st.n_pair
    n_dyn = st.n_dyn
    nb = model.n_bodies
    j_dtype = _j_dtype(model)

    lin_vel = lin_vel + st.gravity * dt

    iinv_world = _iinv_world(st, quat)

    # contacts + warm-start match
    pt_k, n_k, gap_k, active, vid_k = detect_contacts(model, st, pos, quat)
    warm = _warm_start_match(vid_k, active, contact_vid, contact_lambda)

    joint_j, joint_s, slider_lin_pos = build_joint_rows(
        model, st, pos, quat, motor_target, motor_enabled, dt, j_dtype=j_dtype,
    )
    nrj = model.n_rows

    vel6 = torch.cat([lin_vel, ang_vel], dim=1)  # [NB, 6, B]

    # joint warm starting (strict mode only): the slim rows carry no dv, so
    # Minv*J^T is computed here
    if model.strict_bullet and nrj:
        jl0 = joint_lambda * E.WARMSTART  # [NRJ, B]
        j_flat = joint_j.to(torch.float32).reshape(nrj, 4, 3, b)
        dv_a_j, dv_b_j = _finish_dv(st.ja, st.jb, st.j_inv_m_a, st.j_inv_m_b,
                                    j_flat, iinv_world)
        dva = dv_a_j.reshape(nrj, 6, b) * jl0[:, None]
        dvb = dv_b_j.reshape(nrj, 6, b) * jl0[:, None]
        vel6 = vel6 + torch.zeros_like(vel6).index_add(0, st.ja, dva).index_add(0, st.jb, dvb)
    else:
        jl0 = torch.zeros((nrj, b), device=dev)

    zrow = (torch.zeros((0, sp.ROW_J, b), dtype=j_dtype, device=dev),
            torch.zeros((0, sp.ROW_S, b), device=dev))
    if n_pair:
        body = st.fl_a
        r_a = pt_k - pos[body][:, None]
        rel_vel = lin_vel[body][:, None] + _cross(ang_vel[body][:, None], r_a)  # B static
        t1, t2, t2_en = _friction_dirs(n_k, rel_vel, model.strict_bullet)
        actf = active.to(torch.float32)
        inv_m = st.fl_inv_m  # [NP, 1, 1, 1]
        ii = iinv_world[body]  # [NP, 3, 3, B]

        def contact_rows(d):
            # J gated by the active flag; dv only feeds the warm start
            j_ang = _cross(r_a, d)
            zeros = torch.zeros_like(d)
            gate = actf[:, :, None]
            j = torch.stack([d * gate, j_ang * gate, zeros, zeros], dim=2)  # [NP,K,4,3,B]
            dv_lin = inv_m * j[:, :, 0]
            dv_ang = (ii[:, None] * j[:, :, 1][:, :, None]).sum(3)
            return j, torch.stack([dv_lin, dv_ang], dim=2)  # dv [NP, K, 2, 3, B]

        jn, dv_n = contact_rows(n_k)
        jt1, dv_t1 = contact_rows(t1)
        jt2, dv_t2 = contact_rows(t2)
        jt2 = jt2 * t2_en
        dv_t2 = dv_t2 * t2_en
        rhs_n = torch.where(gap_k > 0, -gap_k / dt, 0.0)
        rhs_push = torch.where(gap_k < 0, -gap_k * E.ERP2 / dt, 0.0)
        zeros_pk = torch.zeros((n_pair * k, b), device=dev)
        inf_pk = torch.full((n_pair * k, b), _INF, device=dev)
        normal_packed = _pack(
            jn.reshape(n_pair * k, 4, 3, b), rhs_n.reshape(-1, b), zeros_pk, inf_pk,
            rhs_push.reshape(-1, b), j_dtype=j_dtype,
        )
        jt = torch.stack([jt1, jt2], dim=2)  # [NP, K, 2, 4, 3, B]
        zeros_f = torch.zeros((n_pair * k * 2, b), device=dev)
        friction_packed = _pack(
            jt.reshape(n_pair * k * 2, 4, 3, b), zeros_f, zeros_f, zeros_f, j_dtype=j_dtype,
        )
    else:
        normal_packed = friction_packed = zrow

    if n_dyn:
        member_normal, member_friction, member_x = _member_contact_rows(
            model, st, pos, quat, lin_vel, ang_vel, iinv_world, dt,
            warm_cache=(dyn_vid, dyn_lambda), j_dtype=j_dtype,
        )
    else:
        member_normal = member_friction = zrow
        member_x = None

    # ---- warm start contact impulses into velocities ----
    lam_n0 = warm[..., 0, :]  # [NP, K, B]
    lam_t0 = warm[..., 1:, :]  # [NP, K, 2, B]
    if n_pair:
        imp = (
            dv_n * lam_n0[:, :, None, None]
            + dv_t1 * lam_t0[:, :, 0][:, :, None, None]
            + dv_t2 * lam_t0[:, :, 1][:, :, None, None]
        ).sum(1)  # [NP, 2, 3, B]
        vel6 = vel6 + torch.zeros_like(vel6).index_add(0, st.fl_a, imp.reshape(n_pair, 6, b))
    if n_dyn:
        vel6 = vel6 + member_x["imp6"]

    # ---- velocity pass + fused split impulse: one sweep, in visit order ----
    n_full = nrj + n_pair * k + n_dyn + n_pair * k * 2 + n_dyn * 2
    parts = [(joint_j, joint_s), normal_packed, member_normal, friction_packed,
             member_friction]
    all_rows_j = torch.cat([p[0] for p in parts], 0)
    all_rows_s = torch.cat([p[1] for p in parts], 0)
    m_lam_n0 = member_x["lam_n0"] if n_dyn else torch.zeros((0, b), device=dev)
    m_lam_t0 = (
        member_x["lam_t0"].reshape(n_dyn * 2, b)  # contact-major, dir-minor
        if n_dyn else torch.zeros((0, b), device=dev)
    )
    lam0 = torch.cat(
        [jl0, lam_n0.reshape(n_pair * k, b), m_lam_n0,
         lam_t0.reshape(n_pair * k * 2, b), m_lam_t0], 0,
    )
    assert all_rows_j.shape[0] == n_full == st.n_full, (all_rows_j.shape, n_full)
    all_rows_j, all_rows_s, lam0 = st.row_order.to_visit(all_rows_j, all_rows_s, lam0)
    vel_out, lam_all, push6 = sp.solver_sweep_envlast_slim(
        all_rows_j.contiguous(), all_rows_s.contiguous(),
        vel6.reshape(nb * 6, b).contiguous(), lam0.contiguous(),
        iinv_world.reshape(nb * 9, b).contiguous(), st.sweep_meta, model.n_iterations,
    )
    lam_all = st.row_order.to_canonical(lam_all)

    return _finish_step(model, st, dt, pos, quat, vel_out.reshape(nb, 6, b),
                        push6.reshape(nb, 6, b), lam_all, slider_lin_pos, gap_k, active,
                        vid_k, member_x, contact_lambda, contact_vid, dyn_lambda, dyn_vid)


def _finish_step(model: PhysicsModel, st: Statics, dt: float, pos, quat, vel6, push6,
                 lam_all, slider_lin_pos, gap_k, active, vid_k, member_x, contact_lambda,
                 contact_vid, dyn_lambda, dyn_vid):
    """Step tail shared by the batched and per-env steps: integrate the
    transforms (split-impulse push velocities move positions only), read the
    diagnostics and store the warm-start caches from the canonical-order
    impulses ``lam_all`` [NR, B]. vel6, push6: [NB, 6, B]."""
    b = pos.shape[-1]
    dev = pos.device
    k = MAX_CONTACTS_PER_PAIR
    n_pair, n_dyn = st.n_pair, st.n_dyn
    nb = model.n_bodies
    nrj = model.n_rows
    lam = lam_all[:nrj]
    # statics stay pinned: 0 * NaN from an exploded solve must not leak into
    # bodies no reset rewrites
    vel6_out = torch.where(st.dyn > 0, vel6, 0.0)
    lin_out = vel6_out[:, :3]
    ang_out = vel6_out[:, 3:]
    push66 = torch.where(st.dyn > 0, push6, 0.0)
    new_pos = pos + (lin_out + push66[:, :3]) * dt
    new_quat = _qintegrate(quat, ang_out + push66[:, 3:] * E.TURN_ERP, dt)

    ns = model.n_slider
    np2p = model.n_p2p
    if ns:
        slider_imp = lam[st.slider_rows[0]] + lam[st.slider_rows[1]]
    else:
        slider_imp = torch.zeros((0, b), device=dev)
    if np2p:
        r0, r1, r2 = st.p2p_rows
        p2p_imp = torch.sqrt(lam[r0] ** 2 + lam[r1] ** 2 + lam[r2] ** 2)
    else:
        p2p_imp = torch.zeros((0, b), device=dev)

    floor_contact = torch.zeros((nb, b), device=dev)
    if n_pair:
        lam_n = lam_all[nrj: nrj + n_pair * k].reshape(n_pair, k, b)
        base_f = nrj + n_pair * k + n_dyn
        lam_t = lam_all[base_f: base_f + n_pair * k * 2].reshape(n_pair, k, 2, b)
        touching = (active & (gap_k < 0)).any(dim=1).to(torch.float32)
        floor_contact = torch.clamp(floor_contact.index_add(0, st.fl_a, touching), 0.0, 1.0)
        new_cl = torch.stack([lam_n, lam_t[..., 0, :], lam_t[..., 1, :]], dim=2)
        new_vid = torch.where(active, vid_k, -1)
    else:
        new_cl = contact_lambda
        new_vid = contact_vid

    if n_dyn:
        base_mn = nrj + n_pair * k
        m_lam_n = lam_all[base_mn: base_mn + n_dyn]  # [NDC, B]
        base_mf = nrj + n_pair * k + n_dyn + n_pair * k * 2
        m_lam_t = lam_all[base_mf: base_mf + n_dyn * 2].reshape(n_dyn, 2, b)
        dactf = member_x["act"]
        new_dl = torch.cat([m_lam_n[:, None], m_lam_t], 1) * dactf[:, None]
        new_dv = torch.where(dactf > 0, member_x["vid"], -1)
    else:
        new_dl = dyn_lambda
        new_dv = dyn_vid

    return (
        new_pos, new_quat, lin_out, ang_out, new_cl, new_vid, lam, new_dl,
        new_dv, (slider_lin_pos, slider_imp, p2p_imp, floor_contact),
    )


class BatchedStep:
    """Batch-first physics step: the counterpart of the JAX custom_vmap rule
    (``vmapped_step``). Moves the env axis last, runs :func:`step_envlast`
    and moves it back. Unlike the JAX path it needs no padding to a kernel
    tile: the CUDA sweep takes any batch size. A ``solver="xla"`` model
    runs the per-env step with the colored-phase solves of :mod:`.phases`
    instead, as JAX's vmap batches that branch op by op (dense member
    narrowphase, no top-M cull).

    ``device`` defaults to ``cuda``; pass ``"cpu"`` to run on the CPU (the
    sweep then runs its plain version)."""

    def __init__(self, model: PhysicsModel, dt: float, device=None):
        if model.solver not in ("pallas", "xla"):
            raise ValueError(f"solver={model.solver!r}: 'pallas' or 'xla'")
        self.model = model
        self.dt = float(dt)
        self.device = resolve(device)
        self.statics = Statics(model, self.device)
        # solver="xla" has no batched rule in JAX: a vmapped call batches the
        # per-env code, so a batch runs the per-env step with the phase solves
        self.solve_push = self.solve_full = None
        if model.solver == "xla":
            from .phases import phase_solvers

            self.solve_push, self.solve_full = phase_solvers(model, self.statics, self.device)

    def __call__(self, state: E.PhysicsState, motor_target, motor_enabled):
        """state: PhysicsState with env axis first; motor_target [B, NS] f32,
        motor_enabled [B, NS] bool. Returns (PhysicsState, StepDiagnostics)."""
        def last(x):
            return x.movedim(0, -1)

        out = self._run(*(last(x) for x in state), last(motor_target), last(motor_enabled))
        pos, quat, lin, ang, cl, vid, jlam, dl, dv, diag = out

        def first(x):
            return x.movedim(-1, 0).contiguous()

        return (
            E.PhysicsState(first(pos), first(quat), first(lin), first(ang), first(cl),
                           first(vid), first(jlam), first(dl), first(dv)),
            E.StepDiagnostics(*(first(x) for x in diag)),
        )

    def _run(self, *state_envlast):
        if self.solve_full is not None:
            from .perenv import step_perenv

            return step_perenv(self.model, self.statics, self.solve_push, self.solve_full,
                               self.dt, *state_envlast)
        return step_envlast(self.model, self.statics, self.dt, *state_envlast)

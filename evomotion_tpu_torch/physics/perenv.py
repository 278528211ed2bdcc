"""The per-env physics step in PyTorch: the port of the ``solver="pallas"``
branch of ``_physics_step_impl`` and of ``_finish_step`` in
``evomotion_tpu/physics/engine.py`` (:1471-1878, :2030-2104).

This is the step the sequential tier runs: the CLI's ``run`` path steps one
world at a time. It differs from the batched step (:mod:`.batched`) where
the JAX per-env function differs from the JAX env-last one:

- fat rows: 28 f32 per row (J, Minv J^T of both bodies, rhs, lo, hi,
  1 / (J Minv J^T)), computed here and swept by the fat-row kernel
  (``kernels/sweep_fat.py``, TPU kernel ``solver_sweep``);
- two sweeps per step: the split-impulse push pass over the contact normal
  rows (when the model has contacts), then the velocity sweep over all rows;
- the member narrowphase runs over every member pair (no top-M cull);
- strict_bullet models leave the limit rows' correction velocity uncapped.

Every formula the two steps share comes from :mod:`.batched` (joint rows,
floor contacts, the member narrowphase, warm-start matching, the step tail),
run here on the env-last layout: ``[..., B]`` with B = 1 for one world, or B
worlds for the batched call shape of the JAX per-env solver (its vmap rule).
"""

from __future__ import annotations

import math

import torch

from ..kernels import sweep_fat as sf
from . import batched as bt
from . import engine as E
from .model import MAX_CONTACTS_PER_PAIR, PhysicsModel

_INF = math.inf


def _inv_eff(j, dva, dvb):
    """1 / (J Minv J^T) of rows j [N, 4, 3, B], dv [N, 2, 3, B]; 0 where the
    effective mass is degenerate (a row with zero J)."""
    eff = (
        (j[:, 0] * dva[:, 0]).sum(1) + (j[:, 1] * dva[:, 1]).sum(1)
        + (j[:, 2] * dvb[:, 0]).sum(1) + (j[:, 3] * dvb[:, 1]).sum(1)
    )
    return torch.where(eff > 1e-12, 1.0 / torch.clamp(eff, min=1e-12), 0.0)


def _pack_rows(j, dva, dvb, rhs, lo, hi, inv_eff):
    """Fat rows [N, 28, B]: j [N, 4, 3, B], dv [N, 2, 3, B], scalars [N, B]."""
    n, b = rhs.shape
    return torch.cat(
        [j.reshape(n, 12, b), dva.reshape(n, 6, b), dvb.reshape(n, 6, b),
         torch.stack([rhs, lo, hi, inv_eff], 1)], 1,
    )


class FatSolver:
    """One sweep of the per-env step: the port of ``_get_pallas_solver`` /
    ``_build_pallas_solver``. Its row metadata (a :class:`.engine.SolverMeta`
    of kind "full" or "push") is put on the device once; a call takes
    env-last rows in canonical order and runs the fat-row sweep on all B
    worlds at once, with no padding (the CUDA kernel takes any B). Under a
    row order other than canonical it gathers the rows and initial impulses
    into visit order and scatters the impulses back, as the JAX solver does
    with ``perm`` / ``inv_perm``."""

    def __init__(self, meta: E.SolverMeta, n_iters: int, device):
        self.n_iters = n_iters
        self.meta = sf.make_fat_meta(meta.idx6_a, meta.idx6_b, meta.parent, meta.mu, meta.kind,
                                     meta.skip_b, device, groups=meta.groups, chunk=meta.chunk)
        self.order = E.RowOrder(meta.perm, device)

    def __call__(self, rows, vel6, lam0):
        """rows [NR, 28, B], vel6 [NB, 6, B], lam0 [NR, B] -> (vel6', lam')."""
        rows, lam0 = self.order.to_visit(rows, lam0)
        v, lam = sf.solver_sweep(
            rows.permute(2, 0, 1).contiguous(), vel6.permute(2, 0, 1).contiguous(),
            lam0.t().contiguous(), self.meta, self.n_iters,
        )
        return v.permute(1, 2, 0), self.order.to_canonical(lam.t())


def _floor_contact_rows(model, st, pos, lin_vel, ang_vel, iinv_world, dt, contacts):
    """Floor contact fat rows (body vs static; the static body B is skipped).

    Returns (normal [NP*K, 28, B], push [NP*K, 28, B], friction
    [NP*K*2, 28, B] ordered (pair, slot, dir), dv of the normal and both
    friction directions [NP, K, 2, 3, B] for the warm start)."""
    pt_k, n_k, gap_k, active, _ = contacts
    n_pair, k, b = gap_k.shape
    body = st.fl_a
    r_a = pt_k - pos[body][:, None]  # [NP, K, 3, B]
    rel_vel = lin_vel[body][:, None] + bt._cross(ang_vel[body][:, None], r_a)  # B static
    t1, t2, t2_en = bt._friction_dirs(n_k, rel_vel, model.strict_bullet)
    act = active.to(torch.float32)
    inv_m = st.fl_inv_m  # [NP, 1, 1, 1]
    ii = iinv_world[body][:, None]  # [NP, 1, 3, 3, B]

    def rows_for(d):
        zeros = torch.zeros_like(d)
        j = torch.stack([d, bt._cross(r_a, d), zeros, zeros], 2)  # [NP, K, 4, 3, B]
        dv = torch.stack([inv_m * j[:, :, 0], (ii * j[:, :, 1][:, :, None]).sum(3)], 2)
        ie = _inv_eff(j.reshape(-1, 4, 3, b), dv.reshape(-1, 2, 3, b),
                      torch.zeros_like(dv).reshape(-1, 2, 3, b)).reshape(n_pair, k, b)
        return j, dv, ie

    jn, dv_n, ie_n = rows_for(n_k)
    jt1, dv_t1, ie_t1 = rows_for(t1)
    jt2, dv_t2, ie_t2 = rows_for(t2)
    ie_t2 = ie_t2 * t2_en
    npk = n_pair * k
    zeros = torch.zeros((npk, b), device=pos.device)
    inf_ = torch.full((npk, b), _INF, device=pos.device)
    jn_f, dvn_f = jn.reshape(npk, 4, 3, b), dv_n.reshape(npk, 2, 3, b)
    ie_nf = (ie_n * act).reshape(npk, b)
    rhs_n = torch.where(gap_k > 0, -gap_k / dt, 0.0).reshape(npk, b)
    rhs_push = torch.where(gap_k < 0, -gap_k * E.ERP2 / dt, 0.0).reshape(npk, b)
    normal = _pack_rows(jn_f, dvn_f, torch.zeros_like(dvn_f), rhs_n, zeros, inf_, ie_nf)
    push = _pack_rows(jn_f, dvn_f, torch.zeros_like(dvn_f), rhs_push, zeros, inf_, ie_nf)
    jt = torch.stack([jt1, jt2], 2).reshape(npk * 2, 4, 3, b)
    dv_t = torch.stack([dv_t1, dv_t2], 2).reshape(npk * 2, 2, 3, b)
    ie_t = torch.stack([ie_t1 * act, ie_t2 * act], 2).reshape(npk * 2, b)
    zeros2 = torch.zeros((npk * 2, b), device=pos.device)
    friction = _pack_rows(jt, dv_t, torch.zeros_like(dv_t), zeros2, zeros2, zeros2, ie_t)
    return normal, push, friction, torch.stack([dv_n, dv_t1, dv_t2], 2)


def _member_contact_rows(model, st, pos, quat, lin_vel, ang_vel, iinv_world, dt, dyn_vid,
                         dyn_lambda):
    """Member-member contact fat rows over EVERY member pair (dense SAT
    narrowphase; the top-M cull is the batched step's), K points per pair,
    pair-major, with the persistent-manifold warm start.

    Returns (normal [NDC, 28, B], friction [NDC*2, 28, B] ordered (point,
    dir), push [NDC, 28, B], extras) with extras holding act, vid, the
    warm-start impulse aggregate imp6 [NB, 6, B] and the solver's initial
    impulses lam_n0 [NDC, B], lam_t0 [NDC, 2, B]."""
    b = pos.shape[-1]
    dev = pos.device
    npair = len(model.dyn_pair_body)
    sel = torch.arange(npair, device=dev)[:, None].expand(npair, b)
    point, n, gap, vid = bt._dyn_narrowphase_sel(model, st, pos, quat, sel=sel)
    point = point.reshape(-1, 3, b)
    n = n.reshape(-1, 3, b)
    gap = gap.reshape(-1, b)
    vid = vid.reshape(-1, b)
    act = (gap < E.CONTACT_BREAKING).to(torch.float32)
    ndc = gap.shape[0]
    ia, ib = st.md_a, st.md_b
    rel_a = point - pos[ia]
    rel_b = point - pos[ib]
    ii_a, ii_b = iinv_world[ia], iinv_world[ib]  # [NDC, 3, 3, B]

    def rows_for(d):
        ja_ang = bt._cross(rel_a, d)
        jb_ang = -bt._cross(rel_b, d)
        j = torch.stack([d, ja_ang, -d, jb_ang], 1)  # [NDC, 4, 3, B]
        dva = torch.stack([st.md_inv_m_a * d, (ii_a * ja_ang[:, None]).sum(2)], 1)
        dvb = torch.stack([-st.md_inv_m_b * d, (ii_b * jb_ang[:, None]).sum(2)], 1)
        return j, dva, dvb, _inv_eff(j, dva, dvb)

    zeros = torch.zeros((ndc, b), device=dev)
    inf_ = torch.full((ndc, b), _INF, device=dev)
    jn, dva_n, dvb_n, ie_n = rows_for(n)
    rhs_n = torch.where(gap > 0, -gap / dt, 0.0)
    rhs_push = torch.where(gap < 0, -gap * E.ERP2 / dt, 0.0)
    normal = _pack_rows(jn, dva_n, dvb_n, rhs_n, zeros, inf_, ie_n * act)
    push = _pack_rows(jn, dva_n, dvb_n, rhs_push, zeros, inf_, ie_n * act)

    rel_vel = (
        lin_vel[ia] + bt._cross(ang_vel[ia], rel_a)
        - lin_vel[ib] - bt._cross(ang_vel[ib], rel_b)
    )
    t1, t2, t2_en = bt._friction_dirs(n, rel_vel, model.strict_bullet)
    fr, dvs = [], [(dva_n, dvb_n)]
    for ti, d in enumerate((t1, t2)):
        jt, dva_t, dvb_t, ie_t = rows_for(d)
        en = 1.0 if ti == 0 else t2_en
        fr.append(_pack_rows(jt, dva_t, dvb_t, zeros, zeros, zeros, ie_t * act * en))
        dvs.append((dva_t, dvb_t))
    friction = torch.stack(fr, 1).reshape(ndc * 2, sf.ROW_F, b)

    warm = bt._dyn_warm_match(model.member_manifold_k, vid, act, dyn_vid, dyn_lambda)
    lam_n0 = warm[:, 0] * act
    lam_t0 = warm[:, 1:] * act[:, None]
    imp_a = imp_b = 0.0
    for (dva, dvb), lam in zip(dvs, (lam_n0, lam_t0[:, 0], lam_t0[:, 1])):
        imp_a = imp_a + dva.reshape(ndc, 6, b) * lam[:, None]
        imp_b = imp_b + dvb.reshape(ndc, 6, b) * lam[:, None]
    imp6 = torch.zeros((model.n_bodies, 6, b), device=dev)
    imp6 = imp6.index_add(0, ia, imp_a).index_add(0, ib, imp_b)
    extras = {"act": act, "vid": vid, "imp6": imp6, "lam_n0": lam_n0, "lam_t0": lam_t0}
    return normal, friction, push, extras


def step_perenv(model: PhysicsModel, st: bt.Statics, solve_push: FatSolver | None,
                solve_full: FatSolver, dt: float, pos, quat, lin_vel, ang_vel,
                contact_lambda, contact_vid, joint_lambda, dyn_lambda, dyn_vid,
                motor_target, motor_enabled):
    """One substep of B independent worlds, each as the JAX per-env step
    computes it, env axis last everywhere (shapes as :func:`.batched.step_envlast`).
    Returns the same tuple as :func:`.batched.step_envlast`."""
    b = pos.shape[-1]
    dev = pos.device
    k = MAX_CONTACTS_PER_PAIR
    n_pair, n_dyn = st.n_pair, st.n_dyn
    nb, nrj = model.n_bodies, model.n_rows

    # 1. gravity; world inverse inertia
    lin_vel = lin_vel + st.gravity * dt
    iinv_world = bt._iinv_world(st, quat)

    # 2. floor contacts and their warm-start match
    contacts = bt.detect_contacts(model, st, pos, quat)
    _, _, gap_k, active, vid_k = contacts
    warm = bt._warm_start_match(vid_k, active, contact_vid, contact_lambda)

    # 3. joint rows (strict mode: uncapped limit bias, as Bullet)
    joint_j, joint_s, slider_lin_pos = bt.build_joint_rows(
        model, st, pos, quat, motor_target, motor_enabled, dt,
        bias_cap=_INF if model.strict_bullet else E.LIMIT_BIAS_CAP,
    )
    j = joint_j.reshape(nrj, 4, 3, b)
    dva_j, dvb_j = bt._finish_dv(st.ja, st.jb, st.j_inv_m_a, st.j_inv_m_b, j, iinv_world)
    joint_rows = _pack_rows(j, dva_j, dvb_j, joint_s[:, 0], joint_s[:, 1], joint_s[:, 2],
                            _inv_eff(j, dva_j, dvb_j))
    vel6 = torch.cat([lin_vel, ang_vel], 1)  # [NB, 6, B]

    # strict mode: joint rows warm-start from the cached impulses (x 0.85),
    # applied to the velocities during setup as Bullet does
    if model.strict_bullet and nrj:
        jl0 = joint_lambda * E.WARMSTART
        vel6 = vel6 + torch.zeros_like(vel6).index_add(
            0, st.ja, dva_j.reshape(nrj, 6, b) * jl0[:, None]
        ).index_add(0, st.jb, dvb_j.reshape(nrj, 6, b) * jl0[:, None])
    else:
        jl0 = torch.zeros((nrj, b), device=dev)

    # member-member contact rows
    empty = torch.zeros((0, sf.ROW_F, b), device=dev)
    member_x = None
    m_normal = m_friction = m_push = empty
    if n_dyn:
        m_normal, m_friction, m_push, member_x = _member_contact_rows(
            model, st, pos, quat, lin_vel, ang_vel, iinv_world, dt, dyn_vid, dyn_lambda
        )

    # floor contact rows
    f_normal = f_friction = f_push = empty
    if n_pair:
        f_normal, f_push, f_friction, dv_c = _floor_contact_rows(
            model, st, pos, lin_vel, ang_vel, iinv_world, dt, contacts
        )

    # 4. split-impulse position pass: contact normal rows, push velocities
    if solve_push is not None:
        push_rows = torch.cat([f_push, m_push], 0)
        push6, _ = solve_push(push_rows, torch.zeros_like(vel6),
                              torch.zeros((push_rows.shape[0], b), device=dev))
    else:
        push6 = torch.zeros_like(vel6)

    # warm-start contact impulses into the velocities
    lam_n0 = warm[:, :, 0]  # [NP, K, B]
    lam_t0 = warm[:, :, 1:]  # [NP, K, 2, B]
    if n_pair:
        lam3 = torch.stack([lam_n0, lam_t0[:, :, 0], lam_t0[:, :, 1]], 2)  # [NP, K, 3, B]
        imp = (dv_c * lam3[:, :, :, None, None]).sum((1, 2))  # [NP, 2, 3, B]
        vel6 = vel6 + torch.zeros_like(vel6).index_add(0, st.fl_a, imp.reshape(n_pair, 6, b))
    if n_dyn:
        vel6 = vel6 + member_x["imp6"]

    # 5. velocity sweep over all rows, Bullet's order
    all_rows = torch.cat([joint_rows, f_normal, m_normal, f_friction, m_friction], 0)
    zero_b = torch.zeros((0, b), device=dev)
    lam0 = torch.cat([
        jl0, lam_n0.reshape(n_pair * k, b),
        member_x["lam_n0"] if n_dyn else zero_b,
        lam_t0.reshape(n_pair * k * 2, b),
        member_x["lam_t0"].reshape(n_dyn * 2, b) if n_dyn else zero_b,
    ], 0)
    vel_out, lam_all = solve_full(all_rows, vel6, lam0)

    # 6. integrate, diagnostics, warm-start caches
    return bt._finish_step(model, st, dt, pos, quat, vel_out, push6, lam_all, slider_lin_pos,
                           gap_k, active, vid_k, member_x, contact_lambda, contact_vid,
                           dyn_lambda, dyn_vid)


class PerEnvStep(bt.BatchedStep):
    """The per-env step with the batch-first interface of
    :class:`.batched.BatchedStep`: ``step(state, motor_target,
    motor_enabled)`` on a leading env axis, each world stepped as the JAX
    per-env function steps it (B = 1 for the sequential tier).

    Kernel launches per call: one push-pass sweep when the model has floor
    or member contact pairs, and one velocity sweep. ``device`` defaults to
    ``cuda``; on ``"cpu"`` the sweeps run their plain version."""

    def __init__(self, model: PhysicsModel, dt: float, device=None):
        if model.solver != "pallas":
            raise NotImplementedError(
                f"solver={model.solver!r}: the colored-phase XLA solver branch of the "
                "per-env step is not ported (ROADMAP A11); use solver='pallas'"
            )
        super().__init__(model, dt, device)
        st = self.statics
        n_it = model.n_iterations
        self.solve_push = (
            FatSolver(E._solver_meta(model, "push", st.n_pair, st.n_dyn), n_it, self.device)
            if st.n_pair or st.n_dyn else None
        )
        self.solve_full = FatSolver(st.full_meta, n_it, self.device)

    def _run(self, *state_envlast):
        return step_perenv(self.model, self.statics, self.solve_push, self.solve_full,
                           self.dt, *state_envlast)

"""Physics scenes on the port's ``solver="xla"`` step (CPU).

The analytic and golden scenes of tests/test_engine_basic.py and
tests/test_physics_golden.py, run on the port's colored-phase step with
the same models, step counts and bounds: the hinge pendulum's period
against theory, the ballistic parabola, momentum conservation across a
motorized slider, a box resting on a dynamic member (the multi-point member
manifold), and two identical robot_walk runs giving bit-identical states.
"""

import dataclasses

import numpy as np
import torch

from evomotion_tpu_torch.physics import maths
from evomotion_tpu_torch.physics.engine import init_state
from evomotion_tpu_torch.physics.model import ModelBuilder
from evomotion_tpu_torch.physics.perenv import PerEnvStep
from evomotion_tpu_torch.physics.shapes import get_shape

DT = 1.0 / 60.0
CUBE = get_shape("cube").hull_verts


def _run(model, n, state=None, targets=None):
    """n xla steps of one world on the CPU; returns (last state, pos [n, NB, 3])."""
    model = dataclasses.replace(model, solver="xla")
    step = PerEnvStep(model, DT, device="cpu")
    ns = model.n_slider
    state = init_state(model, 1, "cpu") if state is None else state
    tgt = torch.zeros((1, ns)) if targets is None else torch.as_tensor(targets)[None]
    en = torch.ones((1, ns), dtype=torch.bool)
    traj = []
    for _ in range(n):
        state, _ = step(state, tgt, en)
        traj.append(state.pos[0])
    return state, torch.stack(traj).numpy()


def test_pendulum_period_matches_theory():
    """Hinge pendulum small-oscillation period T = 2*pi*sqrt(I/(m*g*d))."""
    b = ModelBuilder()
    anchor = b.add_body("anchor", CUBE, (0.05, 0.05, 0.05), 0.0, (0, 0, 0), (0, 0, 0, 1))
    theta0 = 0.1
    pos = (np.sin(theta0), -np.cos(theta0), 0.0)
    bob = b.add_body("bob", CUBE, (0.05, 0.05, 0.05), 1.0, pos, (0, 0, 0, 1))
    b.set_ignore_collision(anchor, bob)
    b.add_hinge(anchor, bob, (0, 0, 0), (-pos[0], -pos[1], 0), (0, 0, 1), (0, 0, 1))
    _, traj = _run(b.finalize(), 400)
    xc = traj[:, 1, 0] - traj[:, 1, 0].mean()
    crossings = np.nonzero(np.diff(np.sign(xc)) != 0)[0]
    assert len(crossings) >= 4
    period = 2.0 * np.diff(crossings).mean() * DT
    half = 0.05 + 2 * 0.04
    i_pivot = 1.0 + 1.0 / 12.0 * ((2 * half) ** 2 + (2 * half) ** 2)
    t_theory = 2 * np.pi * np.sqrt(i_pivot / 9.8)
    assert abs(period - t_theory) / t_theory < 0.05


def test_projectile_trajectory():
    b = ModelBuilder()
    b.add_body("ball", CUBE, (0.1, 0.1, 0.1), 1.0, (0, 0, 0), (0, 0, 0, 1))
    model = b.finalize()
    state = init_state(model, 1, "cpu")
    state = state._replace(lin_vel=torch.tensor([[[2.0, 5.0, 1.0]]]))
    n = 60
    state, _ = _run(model, n, state)
    t = n * DT
    expect_y = 5.0 * t - 9.8 * DT * DT * (n * (n + 1) / 2)
    np.testing.assert_allclose(float(state.pos[0, 0, 0]), 2.0 * t, rtol=1e-4)
    np.testing.assert_allclose(float(state.pos[0, 0, 1]), expect_y, rtol=1e-3)
    np.testing.assert_allclose(float(state.pos[0, 0, 2]), 1.0 * t, rtol=1e-4)


def test_momentum_conservation_free_space():
    b = ModelBuilder()
    b1 = b.add_body("m1", CUBE, (0.2, 0.2, 0.2), 1.0, (0, 100, 0), (0, 0, 0, 1))
    b2 = b.add_body("m2", CUBE, (0.2, 0.2, 0.2), 2.0, (1.0, 100, 0), (0, 0, 0, 1))
    b.set_ignore_collision(b1, b2)
    b.add_slider(b1, b2, (0, 0, 0), (0, 0, 0, 1), (-1, 0, 0), (0, 0, 0, 1),
                 lin_lo=-3.0, lin_hi=3.0, max_motor_force=50.0, motor_index=0)
    state, _ = _run(b.finalize(), 30, targets=np.array([2.0], np.float32))
    v = state.lin_vel[0]
    assert abs(float(1.0 * v[0, 0] + 2.0 * v[1, 0])) < 1e-3
    assert float(state.pos[0, 1, 0] - state.pos[0, 0, 0]) > 1.2


def test_box_rests_on_member_stack_xla():
    """tests/test_physics_golden.py ``test_box_rests_on_member_stack[xla]``:
    a box resting on a dynamic slab sits still for 300 steps."""
    b = ModelBuilder()
    ident = (0.0, 0.0, 0.0, 1.0)
    b.add_body("floor", CUBE, (100, 1, 100), 0.0, (0, -1, 0), ident, friction=0.7)
    b.add_body("slab", CUBE, (1.5, 0.125, 1.5), 4.0, (0, 0.205, 0), ident, friction=0.6)
    b.add_body("box", CUBE, (0.25, 0.25, 0.25), 1.0, (0.2, 0.785, 0.1), ident, friction=0.6)
    model = b.finalize()
    assert model.member_manifold_k >= 4
    state, _ = _run(model, 300)
    pos, quat = state.pos[0].numpy(), state.quat[0].numpy()
    lin, ang = state.lin_vel[0].numpy(), state.ang_vel[0].numpy()
    assert 0.60 < pos[2, 1] < 0.72, pos[2]
    assert abs(pos[2, 0] - 0.2) < 0.05 and abs(pos[2, 2] - 0.1) < 0.05, pos[2]
    assert abs(quat[2, 3]) > 0.995, quat[2]
    assert np.all(np.abs(lin[2]) < 0.05), lin[2]
    assert np.all(np.abs(ang[2]) < 0.2), ang[2]
    assert abs(pos[1, 0]) < 0.05 and abs(pos[1, 2]) < 0.05, pos[1]
    assert abs(quat[1, 3]) > 0.995, quat[1]


def test_hinge_keeps_axis_xla():
    b = ModelBuilder()
    base = b.add_body("base", CUBE, (0.1, 0.1, 0.1), 0.0, (0, 0, 0), (0, 0, 0, 1))
    arm = b.add_body("arm", CUBE, (0.5, 0.1, 0.1), 1.0, (1.0, 0, 0), (0, 0, 0, 1))
    b.set_ignore_collision(base, arm)
    b.add_hinge(base, arm, (0, 0, 0), (-1.0, 0, 0), (0, 0, 1), (0, 0, 1))
    state, _ = _run(b.finalize(), 180)
    pivot = state.pos[0, 1] + maths.quat_rotate(state.quat[0, 1], torch.tensor([-1.0, 0, 0]))
    assert float(pivot.norm()) < 0.05
    assert abs(float(state.pos[0, 1, 2])) < 0.01
    assert float(state.pos[0, 1, 1]) < -0.3


def test_determinism_same_seed_same_trajectory():
    """Two identical robot_walk runs on the xla step give bit-identical states."""
    from evomotion_tpu_torch.envs.robot import RobotWalk, RobotWalkParams

    def run():
        env = RobotWalk(RobotWalkParams(reset_frames=1), mt_seed=5, device="cpu",
                        per_env_step=True)
        env.model = dataclasses.replace(env.model, solver="xla")
        state, res = env.reset(1)
        a = torch.full((1, 12), 0.3)
        for _ in range(3):
            state, res = env.step(state, a)
        return state.physics.pos, res.obs

    (p1, o1), (p2, o2) = run(), run()
    assert torch.equal(p1, p2) and torch.equal(o1, o2)
    assert bool(torch.isfinite(p1).all())

"""Spider robot_jump env logic: the port's batched RobotJump against the JAX env.

As ``test_torch_robot_env.py`` does for robot_walk: states injected into
both envs (numpy-made from a seed, env axis first), resets from the
reference's mt19937 table, and ``step``'s control flow under one simple
stand-in for the physics step, so that only the env logic is under test
(the physics is compared in test_torch_step*.py), at 1e-5. The jump's own
rules: reward max(v_y, 0) + v_z; the time bank on it; fail strictly below
an empty bank (``remaining == -1``, not 0); one settle loop of
``int(reset_seconds / DT)`` = 10 frames; tilt +-(pi/3)/2; the factory's
keys. Then ``cli robot_jump random run`` on the sequential tier, shrunk.
"""

import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_robot_env import (_check_result, _check_state, _fake_physics_jax,
                                  _fake_physics_torch, _jax_state, _states)

from evomotion_tpu.envs.robot import RobotJump as JJump
from evomotion_tpu.envs.robot import RobotJumpFactory as JJumpFactory
from evomotion_tpu_torch import cli, convert
from evomotion_tpu_torch.envs.registry import get_environment_factory
from evomotion_tpu_torch.envs.robot import RobotJump as TJump
from evomotion_tpu_torch.envs.robot import RobotJumpFactory, RobotWalk

ATOL = 1e-5
B = 16


@pytest.fixture(scope="module")
def envs():
    return JJump(mt_seed=1234), TJump(mt_seed=1234, device="cpu")


def _jump_states(tenv, seed):
    """``_states`` with the root's velocity set to reach every branch of
    the reward and the time bank, and banks at 0 and 1."""
    st = _states(tenv, seed)
    root = tenv.meta.root_body
    vel = st["physics"]["lin_vel"]
    vel[:6, root, 1] = [-0.4, 0.0, 0.2, 0.6, -0.1, 0.3]  # v_y: clamped at 0 below
    vel[:6, root, 2] = [0.05, 0.05, 0.6, 0.0, 0.0, -0.2]
    st["remaining_steps"][:8] = [0, 1, 0, 1, 0, 1, 0, 1]
    st["curr_step"][:8] = 5
    return st


def test_jump_rules(envs):
    jenv, tenv = envs
    assert tenv.settle_total == jenv.settle_total == 10
    assert (tenv.max_steps, tenv.initial_remaining) == (jenv.max_steps,
                                                       jenv.initial_remaining) == (1800, 60)
    assert tenv.tilt_limit == pytest.approx(jenv.tilt_limit) == pytest.approx(math.pi / 3)


def test_obs_and_compute_step_match(envs):
    jenv, tenv = envs
    st = _jump_states(tenv, 0)
    st["physics"]["pos"][9, 3, 1] = np.nan  # one non-finite env: guarded fail
    js, ts = _jax_state(jenv, st), convert.robot_env_state(st, "cpu")
    j_state, j_res = jax.vmap(jenv._compute_step)(js)
    t_state, t_res = tenv._compute_step(ts)
    _check_result(t_res, j_res, "result")
    _check_state(t_state, j_state, "state")
    v = st["physics"]["lin_vel"][:, tenv.meta.root_body]
    want = np.maximum(v[:, 1], 0.0) + v[:, 2]
    ok = np.arange(B) != 9
    np.testing.assert_allclose(t_res.reward.numpy()[ok], want[ok], atol=ATOL, rtol=0)
    # a bank that drains to -1 fails, one that drains to 0 does not (robot_jump.cpp:79);
    # RobotWalk fails at 0
    rem = t_state.remaining_steps.numpy()
    fail = t_res.done.numpy() & ~t_res.win.numpy()
    for i in range(8):
        assert fail[i] == (rem[i] < 0), (i, rem[i])
    assert (rem[:8] == 0).any() and (rem[:8] == -1).any()
    walk_fail = RobotWalk._fail(None, t_state.remaining_steps)
    assert bool((walk_fail & ~torch.as_tensor(fail)).any())
    assert bool(t_res.done[9]) and float(t_res.reward[9]) == 0.0


def test_teleport_from_mt_table_matches(envs):
    jenv, tenv = envs
    st = _states(tenv, 1)
    js, ts = _jax_state(jenv, st), convert.robot_env_state(st, "cpu")
    j_phys = jax.vmap(lambda p, k, r: jenv._teleported(p, k, r))(
        js.physics, js.key, js.reset_idx)
    t_phys = tenv._teleported(ts.physics, tenv._draws(ts.reset_idx, None))
    _check_state(t_phys, j_phys, "teleported")


def test_step_control_flow_matches(envs, monkeypatch):
    """The settle countdown (10 frames), the finishing step, the auto-reset
    teleport from the mt table, the NaN-action guard and the held motor
    targets, over 12 steps."""
    jenv, tenv = envs
    monkeypatch.setattr(jenv, "_phys_step", _fake_physics_jax(jenv))
    monkeypatch.setattr(tenv, "_phys_step", _fake_physics_torch(tenv))
    st = _jump_states(tenv, 2)
    js, ts = _jax_state(jenv, st), convert.robot_env_state(st, "cpu")
    rng = np.random.default_rng(5)
    jstep = jax.jit(jax.vmap(jenv.step))
    saw_reset = saw_settle = False
    for i in range(12):
        act = rng.uniform(-1, 1, size=(B, 12)).astype(np.float32)
        act[i, 3] = np.nan
        js, jr = jstep(js, jnp.asarray(act))
        ts, tr = tenv.step(ts, torch.as_tensor(act))
        _check_result(tr, jr, f"step {i}")
        _check_state(ts, js, f"step {i}")
        saw_reset |= bool((ts.settle_left == 10).any())
        saw_settle |= bool((~tr.valid).any())
    assert saw_reset and saw_settle
    assert torch.isfinite(ts.motor_target).all()


def test_factory_keys_match():
    params = {"minimal_velocity": "0.2", "target_velocity": "0.7", "max_seconds": "2.5",
              "initial_seconds": "0.5", "reset_seconds": "0.05"}
    jenv = JJumpFactory(params).make(7)
    tenv = get_environment_factory("robot_jump", params).make(7, device="cpu")
    assert isinstance(tenv, TJump) and tenv.per_env_step
    for f in ("minimal_velocity", "target_velocity", "max_seconds", "initial_seconds",
              "reset_seconds"):
        assert getattr(tenv.params, f) == getattr(jenv.params, f), f
    # each package's own copy of the skeleton (held equal in test_torch_front_end.py)
    assert tenv.params.skeleton_json_path.endswith("resources/skeleton/spider.json")
    assert (tenv.settle_total, tenv.max_steps, tenv.initial_remaining) == (
        jenv.settle_total, jenv.max_steps, jenv.initial_remaining) == (3, 150, 30)
    np.testing.assert_array_equal(tenv._mt_table.numpy(), np.asarray(jenv._mt_table))
    batched = RobotJumpFactory({}).make(1, mt_parity=False, device="cpu", per_env_step=False)
    assert batched._mt_table is None and not batched.per_env_step
    with pytest.raises(ValueError):
        RobotJumpFactory({"max_seconds": "x"}).make(device="cpu")


def test_cli_robot_jump_random_run(tmp_path, capsys):
    """The sequential tier, shrunk: one solver iteration would still take
    seconds per spider step on the CPU, so a 0.05 s bank and 1-frame settle."""
    rc = cli.main(["cli", "robot_jump", "random", "--env_parameters", "reset_seconds=0.02",
                   "initial_seconds=0.05", "max_seconds=0.1", "run", str(tmp_path)],
                  device="cpu")
    assert rc == 0
    m = re.match(r"^episode 0: (\d+) steps, return (\S+)$",
                 capsys.readouterr().out.splitlines()[-1])
    assert m and 1 <= int(m.group(1)) <= 8 and math.isfinite(float(m.group(2)))

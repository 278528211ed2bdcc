"""Spider robot_walk, sequential tier: the port against the JAX package.

The JAX package's sequential env is one unbatched world; the port's is a
batch of one stepped by the per-env physics step (``per_env_step=True``,
what ``RobotWalkFactory.make`` builds for the CLI). One-world states are made
with numpy from a seed and injected into both (the JAX env's own functions,
no vmap); ``_obs`` / ``_compute_step`` / ``_teleported`` and ``step``'s
control flow (physics replaced by the same stand-in in both, as in
test_torch_robot_env.py) agree at 1e-5. A real sequential step of the spider
runs on the CPU at the end: two sweeps per physics step, finite results.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evomotion_tpu.envs.robot import RobotEnvState as JState
from evomotion_tpu.envs.robot import RobotWalk as JWalk
from evomotion_tpu.physics.engine import PhysicsState as JPhys
from evomotion_tpu_torch import convert
from evomotion_tpu_torch.envs.robot import RobotWalk, RobotWalkFactory
from evomotion_tpu_torch.kernels import sweep_fat
from evomotion_tpu_torch.physics.perenv import PerEnvStep
from test_torch_robot_env import (
    ATOL, _check_result, _check_state, _fake_physics_jax, _fake_physics_torch, _states,
)

N_WORLDS = 4  # one-world states checked one after another


@pytest.fixture(scope="module")
def envs():
    return JWalk(mt_seed=1234), RobotWalk(mt_seed=1234, device="cpu", per_env_step=True)


def _one_world(st, i):
    """World i of a dict tree of env-first numpy arrays."""
    return {k: _one_world(v, i) if isinstance(v, dict) else v[i] for k, v in st.items()}


def _jax_one(st):
    phys = JPhys(**{k: jnp.asarray(v) for k, v in st["physics"].items()})
    rest = {k: jnp.asarray(v) for k, v in st.items() if k != "physics"}
    return JState(physics=phys, key=jax.random.PRNGKey(0), **rest)


def _batch1(x):
    """A port state tree with a leading env axis of 1."""
    if isinstance(x, tuple):
        return type(x)(*(_batch1(y) for y in x))
    return x[None]


def _first(x):
    if isinstance(x, tuple):
        return type(x)(*(_first(y) for y in x))
    return x[0]


def test_sequential_obs_compute_step_teleport_match(envs):
    jenv, tenv = envs
    st = _states(tenv, 7)
    for i in range(N_WORLDS):
        one = _one_world(st, i)
        js, ts = _jax_one(one), _batch1(convert.robot_env_state(one, "cpu"))
        np.testing.assert_allclose(tenv._obs(ts)[0][0].numpy(), np.asarray(jenv._obs(js)[0]),
                                   atol=ATOL, rtol=0, err_msg=f"obs {i}")
        j_state, j_res = jenv._compute_step(js)
        t_state, t_res = tenv._compute_step(ts)
        _check_result(_first(t_res), j_res, f"result {i}")
        _check_state(_first(t_state), j_state, f"state {i}")
        j_phys = jenv._teleported(js.physics, js.key, js.reset_idx)
        t_phys = tenv._teleported(ts.physics, tenv._draws(ts.reset_idx, None))
        _check_state(_first(t_phys), j_phys, f"teleported {i}")


def test_sequential_step_control_flow_matches(envs, monkeypatch):
    """settle countdown, finishing step, auto-reset, NaN-action guard and held
    motor targets on one world, with the physics replaced by a stand-in."""
    jenv, tenv = envs
    monkeypatch.setattr(jenv, "_phys_step", _fake_physics_jax(jenv))  # one world
    monkeypatch.setattr(tenv, "_phys_step", _fake_physics_torch(tenv))  # a batch
    st = _states(tenv, 8)
    rng = np.random.default_rng(9)
    jstep = jax.jit(jenv.step)
    seen_settle = seen_done = False
    for i in (0, 2, 4):  # worlds starting running / settling / finishing
        one = _one_world(st, i)
        js, ts = _jax_one(one), _batch1(convert.robot_env_state(one, "cpu"))
        for k in range(4):
            act = rng.uniform(-1, 1, size=12).astype(np.float32)
            act[k] = np.nan if k == 1 else act[k]
            js, jr = jstep(js, jnp.asarray(act))
            ts, tr = tenv.step(ts, torch.as_tensor(act[None]))
            _check_result(_first(tr), jr, f"world {i} step {k}")
            _check_state(_first(ts), js, f"world {i} step {k}")
            seen_settle |= not bool(tr.valid[0])
            seen_done |= bool(tr.done[0])
    assert seen_settle and seen_done


def test_factory_builds_sequential_tier():
    env = RobotWalkFactory({"reset_frames": "1", "target_velocity": "0.7"}).make(
        7, device="cpu")
    assert isinstance(env.physics_step, PerEnvStep)
    assert env.params.reset_frames == 1 and env.params.target_velocity == 0.7
    assert env._mt_table is not None


def test_sequential_spider_steps_on_cpu(monkeypatch):
    """Reset (2 settle steps) and one step of the spider on the per-env path:
    push pass over 548 normal rows and velocity sweep over 1,896 rows per
    physics step, every member pair narrowphased, finite state."""
    env = RobotWalkFactory({"reset_frames": "1"}).make(7, device="cpu")
    rows = []
    plain = sweep_fat.sweep_fat_plain
    monkeypatch.setattr(sweep_fat, "sweep_fat_plain",
                        lambda rd, *a: rows.append(rd.shape[1]) or plain(rd, *a))
    state, res = env.reset(1)
    action = torch.full((1, 12), 0.5)
    state, res = env.step(state, action)
    assert rows == [548, 1896] * 3
    assert res.obs.shape == (1, 371)
    assert all(torch.isfinite(x.float()).all() for x in (*state.physics, res.obs, res.reward))

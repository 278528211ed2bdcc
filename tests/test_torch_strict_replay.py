"""The strict-Bullet trajectory artifact on the port (CPU).

``tests/goldens/strict_walk.npz`` is a 256-step ``robot_walk`` run of the
JAX package with ``strict_bullet=True, solver="xla"`` (30 reset frames, seed
1234, the mt19937 reset stream; ``tools/gen_strict_artifact.py``). The port
replays it with ``evomotion_tpu_torch/tools/strict_trajectory.py``, reading
the action stream from ``resources/strict_walk/actions.npy``.

The spider's settle is chaotic in f32: the same JAX step compiled as one
``jit(env.reset)`` (the artifact's program) and as 60 separate jitted calls
parts by ~0.4 in pos after the 60 settle steps, and the port's free run
parts from JAX's stepwise run by more than 1e-4 at settle step 18, when the
floor contacts engage (ROADMAP Queue C, trap 14). So the port is held to
JAX step by step: from each of JAX's own states along the settle and the
first 32 env steps with the artifact's actions, one port step must land on
JAX's next state within 2e-4 with feature ids exact; the free run is held
over the prefix that agrees, FREE_PREFIX physics steps, at 1e-4. The slow
test does the same over all 256 steps.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evomotion_tpu_torch import convert
from evomotion_tpu_torch.physics.engine import init_state as t_init
from evomotion_tpu_torch.tools import strict_trajectory as tool

ATOL = 2e-4  # one step from a shared state (tests/test_torch_perenv_step.py)
FREE_TOL = 1e-4  # the artifact's tolerance (tests/test_physics_golden.py)
FREE_PREFIX = 18  # settle steps over which the port's free run stays within FREE_TOL
SETTLE = 60  # 2 x reset_frames physics steps, motors off
FIELDS = ("pos", "quat", "lin_vel", "ang_vel", "contact_lambda", "joint_lambda", "dyn_lambda")


@contextlib.contextmanager
def _no_persistent_cache():
    from jax._src import compilation_cache

    cache_on = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    try:
        yield
    finally:
        jax.config.update("jax_enable_compilation_cache", cache_on)
        compilation_cache.reset_cache()


def _jax_env():
    from evomotion_tpu.envs.robot import RobotWalkFactory

    env = RobotWalkFactory({"reset_frames": "30"}).make(tool.SEED, mt_parity=True)
    env.model = dataclasses.replace(env.model, strict_bullet=True, solver="xla")
    return env


def jax_states(n_steps):
    """JAX's own physics states, stepped one jitted call at a time: the
    teleported spawn (mt19937 row 0), SETTLE motor-off steps, then n_steps
    with the artifact's actions as motor targets (action x muscle speed).
    Returns (states, targets, enabled) as numpy, states[i + 1] = step(states[i])."""
    from evomotion_tpu.physics.engine import init_state, physics_step

    env = _jax_env()
    m = env.model.n_slider
    actions = np.load(tool.ACTIONS)[:n_steps]
    speed = np.asarray(env._speed, np.float32)
    tgt = np.concatenate([np.zeros((SETTLE, m), np.float32), actions * speed])
    en = np.concatenate([np.zeros((SETTLE, m), bool), np.ones((n_steps, m), bool)])
    state = env._teleported(init_state(env.model), jax.random.PRNGKey(0), jnp.int32(0))
    step = jax.jit(lambda s, t, e: physics_step(env.model, s, t, e, 1.0 / 60.0)[0])
    states = [state]
    with _no_persistent_cache():
        for t, e in zip(tgt, en):
            states.append(step(states[-1], jnp.asarray(t), jnp.asarray(e)))
    states = [{f: np.asarray(v) for f, v in s._asdict().items()} for s in states]
    return states, tgt, en


def check_shared_state(states, tgt, en, start):
    """From each JAX state i >= start, one port step against JAX's i + 1."""
    env = tool.strict_env("cpu")
    for i in range(start, len(tgt)):
        sp = convert.physics_state({f: v[None] for f, v in states[i].items()}, "cpu")
        out, _ = env.physics_step(sp, torch.as_tensor(tgt[i])[None],
                                  torch.as_tensor(en[i])[None])
        ref = states[i + 1]
        for f in FIELDS:
            np.testing.assert_allclose(getattr(out, f)[0].numpy(), ref[f], atol=ATOL, rtol=0,
                                       err_msg=f"step {i} {f}")
        for f in ("contact_vid", "dyn_vid"):
            np.testing.assert_array_equal(getattr(out, f)[0].numpy(), ref[f],
                                          err_msg=f"step {i} {f}")


def free_run_gap(states, tgt, en, n):
    """The port's free run from the spawn: max |pos - JAX| after each of n steps."""
    env = tool.strict_env("cpu")
    sp = convert.physics_state({f: v[None] for f, v in states[0].items()}, "cpu")
    gaps = []
    for i in range(n):
        sp, _ = env.physics_step(sp, torch.as_tensor(tgt[i])[None], torch.as_tensor(en[i])[None])
        gaps.append(float(np.abs(sp.pos[0].numpy() - states[i + 1]["pos"]).max()))
    return gaps


@pytest.fixture(scope="module")
def first_32():
    return jax_states(32)


def test_actions_file_is_jax_draws():
    """resources/strict_walk/actions.npy holds the JAX tool's action stream
    exactly: split(PRNGKey(1235), 256), then uniform(-1, 1) per key, in a scan."""
    keys = jax.random.split(jax.random.PRNGKey(tool.SEED + 1), tool.STEPS)
    _, draws = jax.jit(lambda ks: jax.lax.scan(
        lambda c, k: (c, jax.random.uniform(k, (12,), minval=-1.0, maxval=1.0)), 0, ks))(keys)
    saved = np.load(tool.ACTIONS)
    assert saved.dtype == np.float32 and saved.shape == (tool.STEPS, 12)
    np.testing.assert_array_equal(saved, np.asarray(draws))


def test_reset_draws_come_from_the_mt19937_table():
    """The JAX reset with mt_parity takes its tilt from the mt19937 table,
    not from its key: two keys teleport alike, and the port's table and
    spawn are JAX's."""
    from evomotion_tpu.physics.engine import init_state

    env = _jax_env()
    a = env._teleported(init_state(env.model), jax.random.PRNGKey(0), jnp.int32(0))
    b = env._teleported(init_state(env.model), jax.random.PRNGKey(7), jnp.int32(0))
    np.testing.assert_array_equal(np.asarray(a.pos), np.asarray(b.pos))
    tenv = tool.strict_env("cpu")
    np.testing.assert_array_equal(tenv._mt_table.numpy(), np.asarray(env._mt_table))
    tp = tenv._teleported(t_init(tenv.model, 1, "cpu"),
                          tenv._draws(torch.zeros(1, dtype=torch.int32), None))
    np.testing.assert_array_equal(tp.pos[0].numpy(), np.asarray(a.pos))
    assert tenv.model.strict_bullet and tenv.model.solver == "xla"


def test_first_32_steps_from_shared_states(first_32):
    """The 32 env steps after the 30-frame reset: each port step from JAX's
    state lands on JAX's next state within 2e-4, feature ids exact."""
    states, tgt, en = first_32
    check_shared_state(states, tgt, en, SETTLE)


def test_free_run_agrees_over_the_prefix(first_32):
    """The port's free run from the spawn stays within 1e-4 of JAX's over
    the first FREE_PREFIX settle steps (the floor contacts engage at 18)."""
    states, tgt, en = first_32
    gaps = free_run_gap(states, tgt, en, FREE_PREFIX)
    assert max(gaps) <= FREE_TOL, gaps


def test_tool_compares_against_the_artifact():
    ref = np.load(tool.ARTIFACT)
    assert ref["pos"].shape == (tool.STEPS, 42, 3) and int(ref["seed"]) == tool.SEED
    assert tool.compare(ref["pos"][:5], ref["reward"][:5], ref) == (0.0, 0.0, None)
    pos = ref["pos"][:5].copy()
    pos[3, 7, 1] += 2 * FREE_TOL
    assert tool.compare(pos, ref["reward"][:5], ref)[2] == 3


@pytest.mark.slow
def test_all_256_steps_from_shared_states():
    """All 256 artifact steps and the settle, one port step from each JAX
    state; prints the free run's first step over 1e-4 and the gap of JAX's
    own two programs (jit(reset) against stepwise calls) after the settle."""
    states, tgt, en = jax_states(tool.STEPS)
    check_shared_state(states, tgt, en, 0)
    gaps = free_run_gap(states, tgt, en, SETTLE)
    first = next(i for i, g in enumerate(gaps) if g > FREE_TOL)
    env = _jax_env()
    with _no_persistent_cache():
        js, _ = jax.jit(env.reset)(jax.random.PRNGKey(tool.SEED))
    self_gap = float(np.abs(np.asarray(js.physics.pos) - states[SETTLE]["pos"]).max())
    print(f"free run: first physics step over {FREE_TOL:g}: {first} (gap {gaps[first]:.3e}); "
          f"after the settle {gaps[-1]:.3e}; JAX jit(reset) vs stepwise settle {self_gap:.3e}")
    assert first >= FREE_PREFIX

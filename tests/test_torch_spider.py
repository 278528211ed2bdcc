"""The port's spider step on the CPU: the batched step at the shipped
defaults (bf16 rows, canonical order, top-M member cull, 10 iterations).

The whole-step comparisons with the JAX package are marked ``slow``: their
references trace and compile the interpret-mode sweeps over 1,896 unrolled
rows (and 548 more for the per-env step's push pass), which take minutes on
a CPU test machine. The steps' modules are compared piece by piece in the
other test_torch_*.py files at small sizes.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from evomotion_tpu_torch import convert
from evomotion_tpu_torch.envs.robot import RobotWalk
from evomotion_tpu_torch.physics.engine import init_state

DT = 1.0 / 60.0


@pytest.fixture(scope="module")
def spider():
    return RobotWalk(mt_seed=7, device="cpu")


@contextlib.contextmanager
def _no_persistent_cache():
    """JAX's persistent compilation cache off for the compiles inside: writing
    the spider's interpret-mode executables to it crashes the process. JAX
    decides once per process whether it uses the cache, so the decision is
    reset on the way in and on the way out."""
    import jax
    from jax._src import compilation_cache

    cache_on = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    try:
        yield
    finally:
        jax.config.update("jax_enable_compilation_cache", cache_on)
        compilation_cache.reset_cache()


def _tilted_batch(env, n):
    """n envs teleported from the mt19937 reset table (different rows)."""
    phys = init_state(env.model, n, "cpu")
    return env._teleported(phys, env._draws(torch.arange(n, dtype=torch.int32), None))


def test_spider_step_on_cpu_is_finite_and_bounded(spider):
    env = spider
    assert env.physics_step.statics.n_full == 1896
    phys = _tilted_batch(env, 2)
    tgt = torch.tensor(np.random.default_rng(0).uniform(-1, 1, (2, 12)), dtype=torch.float32)
    on = torch.ones((2, 12), dtype=torch.bool)
    for _ in range(2):
        phys, diag = env.physics_step(phys, tgt * env._speed, on)
    for x in (*phys, *diag):
        assert torch.isfinite(x.float()).all()
    sk = env._skeleton
    assert phys.lin_vel[:, sk].abs().max() < 20.0 and phys.ang_vel[:, sk].abs().max() < 100.0
    # one step of 1/60 s moves nothing far from the spawn (1, 0.25, 2)
    root = phys.pos[:, env.meta.root_body]
    assert (root - torch.tensor([1.0, 0.25, 2.0])).abs().max() < 0.5
    # the floor body stays pinned
    fl = env.meta.floor_body
    np.testing.assert_array_equal(phys.pos[:, fl].numpy(), np.repeat(
        env.model.init_pos[fl][None].astype(np.float32), 2, 0))


@pytest.mark.slow
def test_spider_step_matches_jax():
    """Whole spider step, port vs JAX (f32 rows), 1 step at B=2."""
    import jax
    import jax.numpy as jnp

    from evomotion_tpu.envs.robot import RobotWalk as JWalk
    from evomotion_tpu.physics.engine import PhysicsState, physics_step

    jm = dataclasses.replace(JWalk(mt_seed=7).model, solver="pallas", row_dtype="f32")
    env = RobotWalk(mt_seed=7, device="cpu")
    env.model = convert.model_from_arrays(jm)
    phys = _tilted_batch(env, 2)
    tgt = np.random.default_rng(0).uniform(-1, 1, (2, 12)).astype(np.float32)
    en = np.ones((2, 12), bool)
    step_v = jax.jit(jax.vmap(lambda s, t, e: physics_step(jm, s, t, e, DT)))
    with _no_persistent_cache():
        js, _ = step_v(PhysicsState(*(jnp.asarray(x.numpy()) for x in phys)),
                       jnp.asarray(tgt), jnp.asarray(en))
    tp, _ = env.physics_step(phys, torch.as_tensor(tgt), torch.as_tensor(en))
    for name in ("pos", "quat", "lin_vel", "ang_vel", "contact_lambda", "dyn_lambda"):
        np.testing.assert_allclose(getattr(tp, name).numpy(), np.asarray(getattr(js, name)),
                                   atol=2e-4, rtol=0, err_msg=name)
    for name in ("contact_vid", "dyn_vid"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(), np.asarray(getattr(js, name)))


@pytest.mark.slow
def test_spider_perenv_step_matches_jax():
    """Whole per-env spider step (one world: dense member narrowphase, push
    pass and velocity sweep of the fat-row sweep), port vs JAX, 1 step. The
    JAX reference unrolls the interpret-mode sweep over 548 + 1,896 rows."""
    import jax
    import jax.numpy as jnp

    from evomotion_tpu.envs.robot import RobotWalk as JWalk
    from evomotion_tpu.physics.engine import PhysicsState, physics_step
    from evomotion_tpu_torch.physics import engine as tengine

    jm = dataclasses.replace(JWalk(mt_seed=7).model, solver="pallas")
    env = RobotWalk(mt_seed=7, device="cpu", per_env_step=True)
    env.model = convert.model_from_arrays(jm)
    phys = type(init_state(env.model, 1, "cpu"))(*(x[0] for x in _tilted_batch(env, 1)))
    tgt = np.random.default_rng(0).uniform(-1, 1, 12).astype(np.float32)
    en = np.ones(12, bool)
    step = jax.jit(lambda s, t, e: physics_step(jm, s, t, e, DT))
    with _no_persistent_cache():
        js, _ = step(PhysicsState(*(jnp.asarray(x.numpy()) for x in phys)), jnp.asarray(tgt),
                     jnp.asarray(en))
    tp, _ = tengine.physics_step(env.model, phys, torch.as_tensor(tgt), torch.as_tensor(en), DT)
    for name in ("pos", "quat", "lin_vel", "ang_vel", "contact_lambda", "joint_lambda",
                 "dyn_lambda"):
        np.testing.assert_allclose(getattr(tp, name).numpy(), np.asarray(getattr(js, name)),
                                   atol=2e-4, rtol=0, err_msg=name)
    for name in ("contact_vid", "dyn_vid"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(), np.asarray(getattr(js, name)))

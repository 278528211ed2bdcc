"""The cartpoles on the batched step, the tier of ``train --num_envs N``.

``cartpole`` and ``cartpole3d`` made with ``per_env_step=False`` step their
worlds with the batched physics step (slim env-last rows, the slim sweep's
plain version on the CPU), which the JAX package's ``vmap(env.step)``
reaches through its custom_vmap rule (built with solver="pallas"). Both with
f32 rows: on the CPU the JAX reference computes bf16 rows in f32 (ROADMAP
Queue C, trap 1). Three envs from one seeded reset, then 20 steps of fixed
numpy-made actions strong enough to end an episode, so the auto-reset and
the settle phase run too: obs, reward, done and valid agree at 1e-4 after
every step, as in ``test_torch_cartpole.py``. Then the CLI trains PPO-GAE on
the batched cartpole.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evomotion_tpu.envs.cartpole import CartPoleFactory as JCartPoleFactory
from evomotion_tpu.envs.cartpole3d import CartPole3dFactory as JCartPole3dFactory
from evomotion_tpu_torch import cli
from evomotion_tpu_torch.envs.cartpole import CartPoleFactory
from evomotion_tpu_torch.envs.cartpole3d import CartPole3dFactory
from evomotion_tpu_torch.physics.batched import BatchedStep

ATOL = 1e-4
B = 3


@pytest.mark.parametrize("factories", [(JCartPoleFactory, CartPoleFactory),
                                       (JCartPole3dFactory, CartPole3dFactory)],
                         ids=["cartpole", "cartpole3d"])
def test_batched_env_matches_jax_vmap(factories):
    jfac, tfac = factories
    jenv = jfac({}).make(1234)
    jenv.model = dataclasses.replace(jenv.model, solver="pallas", row_dtype="f32")
    tenv = tfac({}).make(1234, device="cpu", per_env_step=False)
    assert isinstance(tenv.physics_step, BatchedStep)
    tenv.model = dataclasses.replace(tenv.model, row_dtype="f32")
    tenv.physics_step = BatchedStep(tenv.model, tenv.physics_step.dt, "cpu")
    rng = np.random.default_rng(0)
    acts = (rng.uniform(0.6, 1.0, size=(20, B, tenv.action_size))
            * rng.choice([-1.0, 1.0], size=(1, B, tenv.action_size))).astype(np.float32)

    def check(t_res, j_res, what):
        for f in ("obs", "reward", "done", "valid"):
            np.testing.assert_allclose(getattr(t_res, f).numpy(), np.asarray(getattr(j_res, f)),
                                       atol=ATOL, rtol=0, err_msg=f"{what} {f}")

    js, jr = jax.jit(jax.vmap(jenv.reset))(jax.random.split(jax.random.PRNGKey(0), B))
    ts, tr = tenv.reset(B)
    check(tr, jr, "reset")
    jstep = jax.jit(jax.vmap(jenv.step))
    dones, invalid = 0, 0
    for i in range(20):
        js, jr = jstep(js, jnp.asarray(acts[i]))
        ts, tr = tenv.step(ts, torch.as_tensor(acts[i]))
        check(tr, jr, f"step {i}")
        dones += int(tr.done.sum())
        invalid += int((~tr.valid).sum())
    assert dones >= 1 and invalid >= 1  # an episode ended and the env settled


@pytest.mark.parametrize("env_name", ["cartpole", "cartpole3d"])
def test_cli_train_num_envs_on_cartpoles(env_name, tmp_path):
    rc = cli.main(["cli", env_name, "ppo_gae", "--num_envs", "4", "--agent_parameters",
                   "hidden_size=16", "horizon=8", "epoch=2", "train", str(tmp_path), "-e", "2",
                   "-n", "2"], device="cpu")
    assert rc == 0
    for s in ("save_0", "save_1"):
        assert sorted(os.listdir(tmp_path / s)) == [
            "actor.npz", "actor_optimizer.npz", "critic.npz", "critic_optimizer.npz"]
    with np.load(tmp_path / "save_1" / "actor_optimizer.npz") as f:
        assert int(f["1/0/count"]) == 2 * 2 * 2  # epochs x iterations x saves
        assert np.isfinite(f["1/0/mu/mu/w"]).all()

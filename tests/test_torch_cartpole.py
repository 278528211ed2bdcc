"""Sequential cartpole envs: the PyTorch port against the JAX package on the CPU.

``cartpole`` and ``cartpole3d`` are made by their factories at seed 1234
(the reference's mt19937 reset stream, the only random stream both packages
replay), the JAX env with solver="pallas" (its per-env step with the
fat-row sweep in interpret mode), the port's on the CPU (the per-env step,
the sweep's plain version, a batch of one). Reset, then 20 steps of a fixed
numpy-made action sequence strong enough to end an episode, so that the
auto-reset teleport and the settle phase run too: obs, reward, done and
valid agree at 1e-4 after every step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evomotion_tpu.envs.cartpole import CartPoleFactory as JCartPoleFactory
from evomotion_tpu.envs.cartpole3d import CartPole3dFactory as JCartPole3dFactory
from evomotion_tpu_torch.envs.cartpole import CartPoleFactory
from evomotion_tpu_torch.envs.cartpole3d import CartPole3dFactory
from evomotion_tpu_torch.kernels import sweep_fat

ATOL = 1e-4


def _check(t_res, j_res, what):
    for f in ("obs", "reward", "done", "valid"):
        a = getattr(t_res, f)[0].numpy()
        b = np.asarray(getattr(j_res, f))
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0, err_msg=f"{what} {f}")


@pytest.mark.parametrize("factories", [(JCartPoleFactory, CartPoleFactory),
                                       (JCartPole3dFactory, CartPole3dFactory)],
                         ids=["cartpole", "cartpole3d"])
def test_sequential_env_matches_jax(factories, monkeypatch):
    jfac, tfac = factories
    jenv = jfac({}).make(1234)
    jenv.model = dataclasses.replace(jenv.model, solver="pallas")
    tenv = tfac({}).make(1234, device="cpu")
    rng = np.random.default_rng(0)
    acts = (rng.uniform(0.6, 1.0, size=(20, tenv.action_size))
            * rng.choice([-1.0, 1.0], size=(1, tenv.action_size))).astype(np.float32)
    calls = []
    plain = sweep_fat.sweep_fat_plain
    monkeypatch.setattr(sweep_fat, "sweep_fat_plain",
                        lambda *a: calls.append(1) or plain(*a))

    js, jr = jax.jit(jenv.reset)(jax.random.PRNGKey(0))
    ts, tr = tenv.reset(1)
    _check(tr, jr, "reset")
    jstep = jax.jit(jenv.step)
    dones, invalid = 0, 0
    for i in range(20):
        js, jr = jstep(js, jnp.asarray(acts[i]))
        ts, tr = tenv.step(ts, torch.as_tensor(acts[i][None]))
        _check(tr, jr, f"step {i}")
        dones += int(tr.done[0])
        invalid += int(~tr.valid[0])
    assert dones >= 1 and invalid >= 1  # an episode ended and the env settled
    # contact-free scenes: one sweep per physics step (8 settle + 20 steps)
    assert len(calls) == tenv.params.reset_frame_nb + 20

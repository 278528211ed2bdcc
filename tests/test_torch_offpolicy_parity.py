"""One iteration of the port's batched SAC/CrossQ trainer against the JAX
package's ``BatchedOffPolicy.train_step_fn``, on cartpole with f32 rows.

Both envs are made with the mt19937 reset table (``make(1234)``), so their
resets agree without carrying env state; with f32 rows the port's batched
step and JAX's ``vmap(env.step)`` (solver="pallas", interpret mode on the
CPU) agree within the env tests' 1e-4 (``test_torch_cartpole_batched.py``;
ROADMAP Queue C, traps 1 and 9). The JAX agent's init carry goes to the
port (its ``carry_tree`` layout), and the port takes JAX's draws from
JAX's own key splits: ``key, k_roll, k_upd = split(key, 3)``; the
rollout's ``split(k_roll, T)``, one ``uniform(k, (N, A))`` per step; per
update ``ks, kt = split(k)`` over ``split(k_upd, U)``, the sample
``uniform(ks, (B,))`` and ``k_next, k_curr = split(kt)``.

Two runs of the port's iteration:

1. On the port's own cartpole. The ring's validity and dones, its cursor
   and fill, and the sampled ring indices agree exactly (the weights are
   0/1, so both cumulative sums are exact); the actions at 1e-5; the
   observations and rewards within the env's 1e-4. They do not agree at
   1e-5: after 8 steps the two physics steps differ by f32 rounding (2.2e-5
   in an angle observation, 8.6e-5 in a reward), and the critics' Adam
   moments inherit that.
2. On JAX's own transitions: the port env's ``step`` returns, step by step,
   the results of JAX's env under JAX's actions (a JAX rollout with the
   trainer's keys), so only the trainer's own arithmetic differs. The ring's
   contents, the agent's whole carry and the metrics agree at 1e-5 (as
   ``test_torch_offpolicy_agents.py``), the indices exactly.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from evomotion_tpu.envs.cartpole import CartPoleFactory as JCartPoleFactory
from evomotion_tpu.train import offpolicy_batched as JO
from evomotion_tpu.train.checkpoint import _flatten as jflatten
from evomotion_tpu_torch.envs.cartpole import CartPoleFactory
from evomotion_tpu_torch.physics.batched import BatchedStep
from evomotion_tpu_torch.train import offpolicy_batched as PO
from evomotion_tpu_torch.train.checkpoint import _flatten, _unflatten_like

TOL = 1e-5
ENV_TOL = 1e-4  # the cartpole env's own parity tolerance (test_torch_cartpole_batched.py)
N, T, B = 8, 8, 16
CFG = dict(actor_hidden_size=16, critic_hidden_size=16, batch_size=B, epoch=2, train_every=4,
           steps_per_iter=T, n_envs=N, buffer_capacity=N * T * 4)
ENV = {"reset_frame_nb": "2"}


def _envs():
    jenv = JCartPoleFactory(ENV).make(1234)
    jenv.model = dataclasses.replace(jenv.model, solver="pallas", row_dtype="f32")
    tenv = CartPoleFactory(ENV).make(1234, device="cpu", per_env_step=False)
    tenv.model = dataclasses.replace(tenv.model, row_dtype="f32")
    tenv.physics_step = BatchedStep(tenv.model, tenv.physics_step.dt, "cpu")
    return jenv, tenv


def _jax_draws(key, n_updates, a):
    _, k_roll, k_upd = jax.random.split(key, 3)
    u = lambda k, shape: np.asarray(jax.random.uniform(k, shape))  # noqa: E731
    rollout = np.stack([u(k, (N, a)) for k in jax.random.split(k_roll, T)])
    sample, nxt, cur = [], [], []
    for k in jax.random.split(k_upd, n_updates):
        ks, kt = jax.random.split(k)
        k_next, k_curr = jax.random.split(kt)
        sample.append(u(ks, (B,)))
        nxt.append(u(k_next, (B, a)))
        cur.append(u(k_curr, (B, a)))
    return PO.Draws(*(torch.tensor(np.stack(x) if isinstance(x, list) else x)
                      for x in (rollout, sample, nxt, cur)))


def _close(got, ref, what):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.reshape(ref.shape), ref, rtol=TOL, atol=TOL, err_msg=what)


def _jax_transitions(jenv, js0):
    """JAX's env results of the trainer's first rollout from ``js0`` (the
    trainer's keys, its actor), as the port's StepResults."""
    from evomotion_tpu.networks import distributions as JD
    from evomotion_tpu.networks.modules import actor_apply
    from evomotion_tpu_torch.envs.base import StepResult

    @jax.jit
    def step(env_state, obs, k):
        mu, sigma = actor_apply(js0.carry[0], obs)
        return jax.vmap(jenv.step)(env_state, JD.truncated_normal_sample(k, mu, sigma))

    _, k_roll, _ = jax.random.split(js0.key, 3)
    env_state, obs, out = js0.env_state, js0.obs, []
    for k in jax.random.split(k_roll, T):
        env_state, res = step(env_state, obs, k)
        obs = res.obs
        out.append(StepResult(*(torch.tensor(np.asarray(getattr(res, f)))
                                for f in StepResult._fields)))
    return out


def _run(ptrainer, js0, draws):
    """The port's iteration from JAX's init carry; returns (state,
    metrics, the sampled indices of each update)."""
    ps = ptrainer.init()
    _close(ps.obs, js0.obs, "first obs")
    ps.agent.load_carry_tree(_unflatten_like(jflatten(js0.carry), ps.agent.carry_tree()))
    picked = []

    def sample(ring, cdf, total, u):
        idx, batch = PO.BatchedOffPolicy.sample(ring, cdf, total, u)
        picked.append(idx)
        return idx, batch

    ptrainer.sample = sample
    ps, pm = ptrainer.train_step_fn()(ps, draws)
    return ps, pm, picked


@pytest.mark.parametrize("algo", ["soft_actor_critic", "cross_q"])
def test_one_iteration_matches_jax(algo):
    jenv, tenv = _envs()
    jtrainer = JO.BatchedOffPolicy(jenv, algo, JO.OffPolicyConfig(**CFG), seed=0)
    ptrainer = PO.BatchedOffPolicy(tenv, algo, PO.OffPolicyConfig(**CFG), seed=0)
    assert ptrainer.capacity == jtrainer.capacity
    assert ptrainer.updates_per_iter == jtrainer.updates_per_iter == 2
    n_updates = ptrainer.updates_per_iter * CFG["epoch"]
    js0 = jtrainer.init()
    js1, jm = jax.jit(jtrainer.train_step_fn())(js0)
    jring = js1.ring
    draws = _jax_draws(js0.key, n_updates, tenv.action_size)

    # JAX's sampled indices, from its ring and its draws
    weights = jring.valid.at[(jring.cursor - 1) % jtrainer.capacity].set(0.0)
    cdf = jax.numpy.cumsum(weights)
    jidx = [np.asarray(jax.numpy.searchsorted(cdf, u.numpy() * cdf[-1], side="left"))
            for u in draws.sample]

    # 1. the port's own cartpole
    ps, _, picked = _run(ptrainer, js0, draws)
    assert (ps.ring.cursor, ps.ring.filled) == (int(jring.cursor), int(jring.filled)) == (
        N * T, N * T)
    for f in ("done", "valid"):
        np.testing.assert_array_equal(getattr(ps.ring, f).numpy(), np.asarray(getattr(jring, f)))
    _close(ps.ring.action, jring.action, "ring action")
    for f in ("obs", "reward", "next_obs"):
        np.testing.assert_allclose(getattr(ps.ring, f).numpy(), np.asarray(getattr(jring, f)),
                                   rtol=0, atol=ENV_TOL, err_msg=f)
    assert len(picked) == n_updates
    for got, ref in zip(picked, jidx):
        np.testing.assert_array_equal(got.numpy(), ref)

    # 2. JAX's transitions
    results = iter(_jax_transitions(jenv, js0))
    tenv.step = lambda state, action, generator=None: (state, next(results))
    ps, pm, picked = _run(ptrainer, js0, draws)
    for f in ("obs", "action", "reward", "done", "next_obs", "valid"):
        _close(getattr(ps.ring, f), getattr(jring, f), f"ring {f}")
    assert (ps.ring.cursor, ps.ring.filled) == (N * T, N * T)
    for got, ref in zip(picked, jidx):
        np.testing.assert_array_equal(got.numpy(), ref)
    ref, got = jflatten(js1.carry), _flatten(ps.agent.carry_tree())
    assert ref.keys() == got.keys()
    for k in ref:
        _close(got[k], ref[k], k)
    for f in PO.OffPolicyMetrics._fields:
        _close(getattr(pm, f), getattr(jm, f), f)
    _close(ps.obs, js1.obs, "obs")
    np.testing.assert_array_equal(ps.prev_valid.numpy(), np.asarray(js1.prev_valid))
    np.testing.assert_array_equal(ps.ep_steps.numpy(), np.asarray(js1.ep_steps))

"""The port's batched A2C and PPO-vanilla trainer (``onpolicy_step_batched``).

The mirrors of ``tests/test_step_trainer.py`` (runs and updates, learns
cartpole, the entropy schedule), then one iteration of each algo against
the JAX package's ``BatchedStepTrainer.train_step_fn`` on cartpole with f32
rows, as ``test_torch_offpolicy_parity.py`` holds the off-policy trainer:
JAX's init carry carried across, JAX's draws fed to the port
(``key, k_roll, k_upd = split(key, 3)``; the rollout's ``split(k_roll,
T)``, one ``uniform(k, (N, A))`` per step; A2C's events
``uniform(k, (B,))`` over ``split(k_upd, U)``), and the port's env
returning, step by step, JAX's own env results under JAX's actions: each
package's cartpole differs from the other's by f32 rounding (2.2e-5 in an
observation after 8 steps, ``test_torch_offpolicy_parity.py``), so only
the trainer's arithmetic is compared. A2C: the ring, the sampled indices (exactly), the metrics and
the carry at 1e-5 but for the actor's parameters, held within 2 lr per
update: the reference's [B,B,A] broadcast scales the whole policy gradient
by the batch mean of the advantage, which on cartpole's transitions is a
cancellation (~1e-3 of its terms, read with ~7e-4 relative error in f32 by
either package), and where an element's policy and entropy parts nearly
cancel in turn, Adam's normalized step moves it by a different share of lr
in each package (2.5e-5 at most here; ROADMAP Queue C trap 12; the agent's
update on N(0, 1) batches is held at 1e-5 in
``test_torch_onpolicy_agents.py``). PPO-vanilla: the actor's carry and the
metrics at 1e-5, the critic within 2 lr per epoch (its first epoch's
gradient is zero in exact arithmetic for the output bias and the last
LayerNorm bias, ROADMAP Queue C trap 11; ``test_torch_onpolicy_agents.py``
holds its last epoch alone at 1e-6).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evomotion_tpu.envs.cartpole import CartPoleFactory as JCartPoleFactory
from evomotion_tpu.train import onpolicy_step_batched as JS
from evomotion_tpu.train.checkpoint import _flatten as jflatten
from evomotion_tpu_torch.envs.cartpole import CartPoleFactory
from evomotion_tpu_torch.physics.batched import BatchedStep
from evomotion_tpu_torch.train import onpolicy_step_batched as PS
from evomotion_tpu_torch.train.checkpoint import _flatten, _unflatten_like

TOL = 1e-5
ALGOS = ["actor_critic", "ppo_vanilla"]


def _trainer(algo, **kw):
    env = CartPoleFactory({"reset_frame_nb": "2"}).make(0, mt_parity=False, device="cpu",
                                                         per_env_step=False)
    defaults = dict(hidden_size=32, batch_size=64, steps_per_iter=16, n_envs=32,
                    buffer_capacity=2048, epoch=2, train_every=1)
    defaults.update(kw)
    return PS.BatchedStepTrainer(env, algo, PS.StepTrainerConfig(**defaults), seed=0)


@pytest.mark.parametrize("algo", ALGOS)
def test_step_trainer_runs_and_updates(algo):
    trainer = _trainer(algo)
    step = trainer.train_step_fn()
    state = trainer.init()
    p0 = next(state.agent.actor.parameters()).detach().clone()
    for _ in range(3):
        state, metrics = step(state)
    assert state.iteration == 3 and state.global_step == 48
    assert int(metrics.updates_done) > 0
    assert np.isfinite(float(metrics.actor_loss))
    assert not torch.allclose(p0, next(state.agent.actor.parameters()))


def test_a2c_entropy_schedule_decays():
    trainer = _trainer("actor_critic", entropy_steps=1000)
    e0 = float(trainer.entropy_factor(0))
    e_mid = float(trainer.entropy_factor(500))
    e_end = float(trainer.entropy_factor(2000))
    assert e0 == pytest.approx(0.01)
    assert e0 > e_mid > e_end
    assert e_end == pytest.approx(1e-4)
    jtrainer = JS.BatchedStepTrainer(CartPoleFactory({}).make(0, device="cpu"), "actor_critic",
                                     JS.StepTrainerConfig(hidden_size=4, entropy_steps=1000))
    for t in (0, 64, 500, 999, 2000):
        assert float(trainer.entropy_factor(t)) == pytest.approx(
            float(jtrainer._entropy_factor(jnp.int32(t))), rel=1e-6)


@pytest.mark.slow
@pytest.mark.parametrize("algo", ALGOS)
def test_step_trainer_learns_cartpole(algo):
    trainer = _trainer(algo)
    step = trainer.train_step_fn()
    state = trainer.init()
    eps = []
    for _ in range(160):
        state, metrics = step(state)
        eps.append(float(metrics.episodes_done))
    # the best 15-iteration window shows many fewer terminations than the
    # early window (the tiny config over-trains and oscillates afterwards)
    early = np.mean(eps[2:17])
    best = np.convolve(eps, np.ones(15) / 15, mode="valid").min()
    assert best < 0.7 * early, (early, best)


# -- one iteration against JAX --------------------------------------------------

N, T, B = 8, 8, 16
LR = 1e-3
CFG = dict(hidden_size=16, batch_size=B, epoch=2, train_every=4, steps_per_iter=T,
           n_envs=N, buffer_capacity=N * T * 4, learning_rate=LR, entropy_steps=40)
ENV = {"reset_frame_nb": "2"}


def _envs():
    jenv = JCartPoleFactory(ENV).make(1234)
    jenv.model = dataclasses.replace(jenv.model, solver="pallas", row_dtype="f32")
    tenv = CartPoleFactory(ENV).make(1234, device="cpu", per_env_step=False)
    tenv.model = dataclasses.replace(tenv.model, row_dtype="f32")
    tenv.physics_step = BatchedStep(tenv.model, tenv.physics_step.dt, "cpu")
    return jenv, tenv


def _jax_draws(key, n_events, a):
    _, k_roll, k_upd = jax.random.split(key, 3)
    rollout = np.stack([np.asarray(jax.random.uniform(k, (N, a)))
                        for k in jax.random.split(k_roll, T)])
    sample = np.stack([np.asarray(jax.random.uniform(k, (B,)))
                       for k in jax.random.split(k_upd, n_events)])
    return PS.StepDraws(torch.tensor(rollout), torch.tensor(sample))


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


def _close(got, ref, what, tol=TOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.reshape(ref.shape), ref, rtol=tol, atol=tol, err_msg=what)


@pytest.mark.parametrize("algo", ALGOS)
def test_one_iteration_matches_jax(algo):
    jenv, tenv = _envs()
    jtrainer = JS.BatchedStepTrainer(jenv, algo, JS.StepTrainerConfig(**CFG), seed=0)
    ptrainer = PS.BatchedStepTrainer(tenv, algo, PS.StepTrainerConfig(**CFG), seed=0)
    assert ptrainer.capacity == (jtrainer.capacity if algo == "actor_critic" else N * T)
    assert ptrainer.updates_per_iter == jtrainer.updates_per_iter == 2
    js0 = jtrainer.init()
    # one iteration on, so that A2C's entropy factor is off its start
    js0 = js0._replace(global_step=jnp.int32(8))
    js1, jm = jax.jit(jtrainer.train_step_fn())(js0)
    draws = _jax_draws(js0.key, ptrainer.updates_per_iter, tenv.action_size)

    ps = ptrainer.init()
    _close(ps.obs, js0.obs, "first obs", 1e-4)  # the port's own reset, f32 physics
    ps.obs = torch.tensor(np.asarray(js0.obs))
    ps.global_step = 8
    ps.agent.load_carry_tree(_unflatten_like(jflatten(js0.carry), ps.agent.carry_tree()))
    results = iter(_jax_transitions(jenv, js0))
    tenv.step = lambda state, action, generator=None: (state, next(results))
    picked = []

    def sample(ring, cdf, total, u):
        idx, batch = PS.BatchedStepTrainer.sample(ring, cdf, total, u)
        picked.append(idx)
        return idx, batch

    ptrainer.sample = sample
    ps, pm = ptrainer.train_step_fn()(ps, draws)

    ref, got = jflatten(js1.carry), _flatten(ps.agent.carry_tree())
    assert ref.keys() == got.keys()
    loose = "2/" if algo == "ppo_vanilla" else "0/"  # the critic's / the actor's params
    n_steps = CFG["epoch"] if algo == "ppo_vanilla" else ptrainer.updates_per_iter
    for k in ref:
        if k.startswith(loose):
            np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=2 * LR * n_steps, err_msg=k)
        else:
            _close(got[k], ref[k], k)
    for f in PS.StepTrainMetrics._fields:
        _close(getattr(pm, f), getattr(jm, f), f)
    _close(ps.obs, js1.obs, "obs")
    np.testing.assert_array_equal(ps.prev_valid.numpy(), np.asarray(js1.prev_valid))
    assert (ps.iteration, ps.global_step) == (int(js1.iteration), int(js1.global_step)) == (
        1, 8 + T)
    if algo == "ppo_vanilla":
        assert ps.ring is None and not picked
        return
    jring = js1.ring
    for f in ("obs", "action", "reward", "done", "next_obs", "valid"):
        _close(getattr(ps.ring, f), getattr(jring, f), f"ring {f}")
    assert (ps.ring.cursor, ps.ring.filled) == (int(jring.cursor), int(jring.filled)) == (
        N * T, N * T)
    weights = jring.valid.at[(jring.cursor - 1) % jtrainer.capacity].set(0.0)
    cdf = jnp.cumsum(weights)
    assert len(picked) == 2 and int(jm.updates_done) == 2
    for got_idx, u in zip(picked, draws.sample):
        ref_idx = np.asarray(jnp.searchsorted(cdf, u.numpy() * cdf[-1], side="left"))
        np.testing.assert_array_equal(got_idx.numpy(), ref_idx)

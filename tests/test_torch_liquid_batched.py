"""The port's batched liquid trainers (``train/ppo_liquid_batched.py``
``BatchedPpoLiquid``, ``train/offpolicy_batched.py``
``BatchedOffPolicyLiquid``) against the JAX package's, on cartpole.

One train step of each from JAX's init state (its weights, Adam states and
first observations carried across) on JAX's own transitions: the port env's
``step`` runs JAX's cartpole (``vmap(env.step)``, solver="pallas" in
interpret mode, f32 rows) from JAX's env state under the port's actions,
so only the trainers' arithmetic differs (the port's own cartpole differs
from JAX's by f32 rounding, 2.2e-5 in an observation after 8 steps: ROADMAP
Queue C, trap 9's lesson in ``test_torch_offpolicy_parity.py``). The port
takes JAX's draws from JAX's own key splits (rollout: ``uniform(k, (N,
A))`` per step; SAC's updates as ``test_torch_offpolicy_parity.py``). 16
neurons, 3 unfoldings, N = 8 envs, T = 8 steps, as the JAX tests' sizes
(``tests/test_liquid_trainer.py``).

Tolerances: the trajectory (its stored hidden states too), the ring, the
metrics and the losses at 1e-5 (f32 summation order). Liquid SAC's whole
carry at 1e-5. Liquid PPO-GAE's actor and its Adam state at 1e-5; its
critic within 2 lr per epoch: at the first epoch v - returns sums to zero
over the valid steps, so the output bias's gradient is f32 noise that
Adam's first step turns into up to lr either way (trap 11; the last epoch
alone is held at 1e-6 in ``test_torch_liquid_agents.py``).

Then the hidden-state rules of the JAX tests
(``test_hidden_state_advances_and_resets``,
``test_liquid_sac_hidden_states_consistent``) on the port's own rollouts,
and checkpoints between the packages' trainers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evomotion_tpu.envs.cartpole import CartPoleFactory as JCartPoleFactory
from evomotion_tpu.train import offpolicy_batched as JO
from evomotion_tpu.train import ppo_liquid_batched as JP
from evomotion_tpu.train.checkpoint import _flatten as jflatten
from evomotion_tpu_torch import convert
from evomotion_tpu_torch.envs.base import StepResult
from evomotion_tpu_torch.envs.cartpole import CartPoleFactory
from evomotion_tpu_torch.physics.batched import BatchedStep
from evomotion_tpu_torch.train import offpolicy_batched as PO
from evomotion_tpu_torch.train import ppo_liquid_batched as PP
from evomotion_tpu_torch.train.checkpoint import _flatten, _unflatten_like

TOL = 1e-5
N, T, NEURONS, STEPS = 8, 8, 16, 3
LR = 1e-3
ENV = {"reset_frame_nb": "2"}
PPO_CFG = dict(neurons=NEURONS, unfolding_steps=STEPS, horizon=T, epoch=2, n_envs=N,
               learning_rate=LR)
B = 16
SAC_CFG = dict(neurons=NEURONS, unfolding_steps=STEPS, batch_size=B, epoch=2, train_every=4,
               steps_per_iter=T, n_envs=N, buffer_capacity=N * T * 4, learning_rate=LR)
NETS = PO.BatchedOffPolicyLiquid.NETS


def _envs():
    jenv = JCartPoleFactory(ENV).make(1234)
    jenv.model = dataclasses.replace(jenv.model, solver="pallas", row_dtype="f32")
    tenv = CartPoleFactory(ENV).make(1234, device="cpu", per_env_step=False)
    tenv.model = dataclasses.replace(tenv.model, row_dtype="f32")
    tenv.physics_step = BatchedStep(tenv.model, tenv.physics_step.dt, "cpu")
    return jenv, tenv


def _on_jax_env(tenv, jenv, env_state):
    """Makes ``tenv.step`` step JAX's env from ``env_state`` (kept in a
    closure; the port's env state passes through untouched) under the
    port's actions, returning JAX's results as the port's StepResults."""
    step = jax.jit(jax.vmap(jenv.step))
    box = [env_state]

    def run(state, action, generator=None):
        box[0], res = step(box[0], jnp.asarray(action.numpy()))
        return state, StepResult(*(torch.tensor(np.asarray(getattr(res, f)))
                                   for f in StepResult._fields))

    tenv.step = run


def _close(got, ref, what, tol=TOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.reshape(ref.shape), ref, rtol=tol, atol=tol, err_msg=what)


# -- liquid PPO-GAE ---------------------------------------------------------------


def _jax_ppo_step(jtrainer, js0):
    """JAX's jitted train step from ``js0``, with the trajectory its rollout
    made (caught inside the same trace)."""
    rollout, caught = jtrainer.rollout_fn(), {}

    def catching():
        def run(state):
            state, traj = rollout(state)
            caught["traj"] = traj
            return state, traj
        return run

    jtrainer.rollout_fn = catching
    train_step = jtrainer.train_step_fn()

    @jax.jit
    def step(state):
        state, metrics = train_step(state)
        return state, metrics, caught["traj"]

    return step(js0)


def test_ppo_liquid_train_step_matches_jax():
    jenv, tenv = _envs()
    jtrainer = JP.BatchedPpoLiquid(jenv, JP.PpoLiquidConfig(**PPO_CFG), seed=0)
    ptrainer = PP.BatchedPpoLiquid(tenv, PP.PpoLiquidConfig(**PPO_CFG), seed=0)
    js0 = jtrainer.init()
    js1, jm, jtraj = _jax_ppo_step(jtrainer, js0)

    ps = ptrainer.init()
    _close(ps.obs, js0.obs, "first obs")
    ps.obs = torch.tensor(np.asarray(js0.obs))
    for name in ("actor", "critic"):
        convert.load_params(getattr(ps, name), jax.tree.map(np.asarray,
                                                            getattr(js0, f"{name}_params")))
        convert.load_adam(getattr(ps, f"{name}_opt"), getattr(ps, name),
                          jax.tree.map(np.asarray, getattr(js0, f"{name}_opt_state")))
    _on_jax_env(tenv, jenv, js0.env_state)
    keys = jax.random.split(js0.key, T + 1)[1:]
    uniforms = torch.tensor(np.stack([np.asarray(jax.random.uniform(k, (N, 1))) for k in keys]))
    own, caught = ptrainer.rollout_fn, {}

    def catching():
        rollout = own()

        def run(state, u=None):
            state, caught["traj"] = rollout(state, u)
            return state, caught["traj"]
        return run

    ptrainer.rollout_fn = catching
    ps, pm = ptrainer.train_step_fn()(ps, uniforms)

    # the rollout, its stored pre-step hidden states among it
    names = ("obs", "action", "log_prob", "value", "reward", "done", "valid", "actor_x",
             "critic_x", "done_len", "win")
    assert tuple(caught["traj"].actor_x.shape) == (T, N, NEURONS)
    for f, ref in zip(names, jtraj, strict=True):
        _close(getattr(caught["traj"], f), ref, f"trajectory {f}")
    for f in PP.PpoMetrics._fields:
        _close(getattr(pm, f), getattr(jm, f), f)
    _close(ps.actor_x, js1.actor_x, "actor_x")
    _close(ps.critic_x, js1.critic_x, "critic_x")
    _close(ps.obs, js1.obs, "obs")
    np.testing.assert_array_equal(ps.ep_steps.numpy(), np.asarray(js1.ep_steps))
    assert ps.iteration == int(js1.iteration) == 1

    actor = convert.params_tree(ps.actor)
    for k, v in _flatten(jax.tree.map(np.asarray, js1.actor_params)).items():
        _close(_flatten(actor)[k], v, f"actor {k}")
    for k, v in _flatten(jax.tree.map(np.asarray, js1.actor_opt_state)).items():
        _close(_flatten(convert.adam_tree(ps.actor_opt, ps.actor))[k], v, f"actor Adam {k}")
    critic = _flatten(convert.params_tree(ps.critic))
    for k, v in _flatten(jax.tree.map(np.asarray, js1.critic_params)).items():
        np.testing.assert_allclose(critic[k], v, rtol=0, atol=2 * LR * PPO_CFG["epoch"],
                                   err_msg=f"critic {k}")


@pytest.fixture
def ppo_rollout():
    """A port rollout of 48 steps on 8 envs (settle frames of 2 steps after
    each done), with the state it started from."""
    env = CartPoleFactory(ENV).make(0, mt_parity=False, device="cpu", per_env_step=False)
    trainer = PP.BatchedPpoLiquid(env, PP.PpoLiquidConfig(**{**PPO_CFG, "horizon": 48}), seed=0)
    state = trainer.init()
    return trainer.rollout_fn()(state)


def test_ppo_hidden_state_advances_and_resets(ppo_rollout):
    """The rules of the JAX test ``test_hidden_state_advances_and_resets``:
    the stored pre-step state moves across valid transitions, is the first
    state (zeros) after a done, and freezes across invalid settle frames."""
    _, traj = ppo_rollout
    ax, dones, valids = traj.actor_x.numpy(), traj.done.numpy(), traj.valid.numpy()
    assert ax.shape == (48, N, NEURONS) and traj.critic_x.shape == ax.shape
    moved = np.abs(ax[1:] - ax[:-1]).max(axis=-1)
    for t, n in zip(*np.nonzero(valids[:-1] & ~dones[:-1])):
        assert moved[t, n] > 0.0, (t, n)
    assert dones.any() and (~valids).any()
    for t, n in zip(*np.nonzero(dones[:-1])):
        np.testing.assert_array_equal(ax[t + 1, n], 0.0)
        np.testing.assert_array_equal(traj.critic_x[t + 1, n].numpy(), 0.0)
    for t, n in zip(*np.nonzero(~valids[:-1] & ~dones[:-1])):
        np.testing.assert_array_equal(ax[t + 1, n], ax[t, n])


def test_ppo_liquid_save_loads_in_jax(ppo_rollout, tmp_path):
    """The driver's ``save_<i>/`` of a liquid PPO state (``ppo_batched.
    save_agent``) loads into the JAX package's agent and back, exactly."""
    from evomotion_tpu.agents.liquid_agents import PpoGaeLiquidAgent as JGae
    from evomotion_tpu_torch.train.ppo_batched import save_agent

    state, _ = ppo_rollout
    state.actor_opt.zero_grad()
    sum(p.sum() for p in state.actor.parameters()).backward()
    state.actor_opt.step()  # a count and moments to carry
    save_agent(str(tmp_path), state)
    j = JGae(3, 7, 1, NEURONS, STEPS, 0.99, 0.95, 0.2, 0.01, 0.5, 2, 2, 1, 4, LR, 0.5)
    j.load(str(tmp_path))
    ref = _flatten(convert.adam_tree(state.actor_opt, state.actor))
    got = jflatten(j.actor_opt_state)
    assert got.keys() == ref.keys() and int(got["1/0/count"]) == 1
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    for k, v in _flatten(convert.params_tree(state.critic)).items():
        np.testing.assert_array_equal(jflatten(j.critic_params)[k], v, err_msg=k)


# -- liquid SAC ----------------------------------------------------------------------


def _sac_draws(key, n_updates):
    _, k_roll, k_upd = jax.random.split(key, 3)
    u = lambda k, shape: np.asarray(jax.random.uniform(k, shape))  # noqa: E731
    rollout = np.stack([u(k, (N, 1)) for k in jax.random.split(k_roll, T)])
    sample, nxt, cur = [], [], []
    for k in jax.random.split(k_upd, n_updates):
        ks, kt = jax.random.split(k)
        k_next, k_curr = jax.random.split(kt)
        sample.append(u(ks, (B,)))
        nxt.append(u(k_next, (B, 1)))
        cur.append(u(k_curr, (B, 1)))
    return PO.Draws(*(torch.tensor(np.stack(x) if isinstance(x, list) else x)
                      for x in (rollout, sample, nxt, cur)))


def test_sac_liquid_train_step_matches_jax():
    jenv, tenv = _envs()
    jtrainer = JO.BatchedOffPolicyLiquid(jenv, JO.OffPolicyLiquidConfig(**SAC_CFG), seed=0)
    ptrainer = PO.BatchedOffPolicyLiquid(tenv, PO.OffPolicyLiquidConfig(**SAC_CFG), seed=0)
    assert ptrainer.capacity == jtrainer.capacity
    assert ptrainer.updates_per_iter == jtrainer.updates_per_iter == 2
    n_updates = ptrainer.updates_per_iter * SAC_CFG["epoch"]
    js0 = jtrainer.init()
    js1, jm = jax.jit(jtrainer.train_step_fn())(js0)
    jring = js1.ring

    ps = ptrainer.init()
    _close(ps.obs, js0.obs, "first obs")
    ps.obs = torch.tensor(np.asarray(js0.obs))
    ps.prev_valid = torch.tensor(np.asarray(js0.prev_valid))
    ps.agent.load_carry_tree(_unflatten_like(jflatten(js0.carry), ps.agent.carry_tree()))
    _on_jax_env(tenv, jenv, js0.env_state)
    picked = []

    def sample(ring, cdf, total, u):
        idx, batch = ring.sample(cdf, total, u)
        picked.append(idx)
        return idx, batch

    ptrainer.sample = sample
    ps, pm = ptrainer.train_step_fn()(ps, _sac_draws(js0.key, n_updates))

    weights = jring.valid.at[(jring.cursor - 1) % jtrainer.capacity].set(0.0)
    cdf = jnp.cumsum(weights)
    assert len(picked) == n_updates
    for got, u in zip(picked, _sac_draws(js0.key, n_updates).sample):
        ref = np.asarray(jnp.searchsorted(cdf, u.numpy() * cdf[-1], side="left"))
        np.testing.assert_array_equal(got.numpy(), ref)
    assert (ps.ring.cursor, ps.ring.filled) == (int(jring.cursor), int(jring.filled)) == (
        N * T, N * T)
    for f in ("obs", "action", "reward", "done", "next_obs", "valid"):
        _close(getattr(ps.ring, f), getattr(jring, f), f"ring {f}")
    for f in ("x", "next_x"):
        for n in NETS:
            _close(getattr(ps.ring, f)[n], getattr(jring, f)[n], f"ring {f} {n}")
    for n in NETS:
        _close(ps.xs[n], js1.xs[n], f"live x {n}")
    ref, got = jflatten(js1.carry), _flatten(ps.agent.carry_tree())
    assert ref.keys() == got.keys()
    for k in ref:
        _close(got[k], ref[k], k)
    for f in PO.OffPolicyMetrics._fields:
        _close(getattr(pm, f), getattr(jm, f), f)
    np.testing.assert_array_equal(ps.ep_steps.numpy(), np.asarray(js1.ep_steps))
    assert int(pm.updates_done) == n_updates


def _port_sac(n_envs=4, steps=12, **kw):
    env = CartPoleFactory(ENV).make(0, mt_parity=False, device="cpu", per_env_step=False)
    cfg = {**SAC_CFG, "n_envs": n_envs, "steps_per_iter": steps, "batch_size": 32,
           "buffer_capacity": 512, "train_every": 1, "epoch": 1, **kw}
    return PO.BatchedOffPolicyLiquid(env, PO.OffPolicyLiquidConfig(**cfg), seed=0)


def test_sac_liquid_hidden_states_consistent():
    """The rules of the JAX test ``test_liquid_sac_hidden_states_consistent``
    over 48 steps of 4 envs (episodes end inside): the stored next_x of a
    transition is the hidden state the next stored transition of the same
    env consumed, for all five nets, except at episode boundaries (the
    first state there); and every stored next_x, a done transition's too,
    is the net's forward from the stored x on (obs, action). No update runs
    (``learn=False``), so the nets are the rollout's."""
    trainer = _port_sac(steps=48)
    state, _ = trainer.train_step_fn(learn=False)(trainer.init())
    t_n = 48 * 4
    x = {n: state.ring.x[n][:t_n] for n in NETS}
    nx = {n: state.ring.next_x[n][:t_n] for n in NETS}
    obs, act = state.ring.obs[:t_n], state.ring.action[:t_n]
    dones = state.ring.done[:t_n].reshape(48, 4).numpy()
    valid = state.ring.valid[:t_n].reshape(48, 4).numpy()
    assert dones.any()
    agent = state.agent
    with torch.no_grad():
        for n in NETS:
            net = getattr(agent, n)
            want = net(x[n], obs)[-1] if n == "actor" else net(x[n], obs, act)[1]
            torch.testing.assert_close(nx[n], want, rtol=0, atol=1e-6)
    x = {n: v.reshape(48, 4, NEURONS).numpy() for n, v in x.items()}
    nx = {n: v.reshape(48, 4, NEURONS).numpy() for n, v in nx.items()}
    chained = 0
    for t in range(47):
        for n in range(4):
            if valid[t, n] and valid[t + 1, n] and not dones[t, n]:
                chained += 1
                for net in NETS:
                    np.testing.assert_allclose(nx[net][t, n], x[net][t + 1, n], atol=1e-6)
            if dones[t, n]:
                for net in NETS:
                    np.testing.assert_array_equal(x[net][t + 1, n], 0.0)
                    assert np.abs(nx[net][t, n]).max() > 0.0
    assert chained > 0


def test_sac_liquid_step_runs_and_updates():
    """The JAX test ``test_liquid_sac_step_runs_and_updates``: after the
    ring holds a batch the actor moves, and the ring stores in and out
    states for all five nets."""
    trainer = _port_sac(n_envs=16, steps=8)
    step = trainer.train_step_fn()
    state = trainer.init()
    p0 = state.agent.actor.cell.w.detach().clone()
    for _ in range(3):
        state, metrics = step(state)
    assert state.iteration == 3 and int(metrics.updates_done) > 0
    assert np.isfinite(float(metrics.actor_loss))
    assert not torch.equal(p0, state.agent.actor.cell.w)
    for n in NETS:
        assert tuple(state.ring.x[n].shape) == (trainer.capacity, NEURONS)
        assert float(state.ring.next_x[n].abs().max()) > 0.0
    with pytest.raises(NotImplementedError, match="full-state"):
        trainer.save_full("unused", state)


def test_sac_liquid_save_and_load_carry_both_ways(tmp_path):
    """``save`` writes the JAX agent's ten components, which the JAX
    trainer's ``load_carry`` reads back equal; a JAX save loads through the
    port's ``load_carry``."""
    trainer = _port_sac()
    state, _ = trainer.train_step_fn()(trainer.init())
    trainer.save(str(tmp_path / "port"), state)
    jenv, _ = _envs()
    jtrainer = JO.BatchedOffPolicyLiquid(jenv, JO.OffPolicyLiquidConfig(
        **{**SAC_CFG, "batch_size": 32, "buffer_capacity": 512, "n_envs": 4,
           "steps_per_iter": 12}), seed=5)
    jcarry = jtrainer.load_carry(str(tmp_path / "port"))
    ref = _flatten(state.agent.carry_tree())
    got = jflatten(jcarry)
    assert ref.keys() == got.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    jtrainer.save(str(tmp_path / "jax"), jtrainer.init()._replace(carry=jcarry))
    agent = trainer.load_carry(str(tmp_path / "jax"))
    for k, v in _flatten(agent.carry_tree()).items():
        np.testing.assert_array_equal(v, ref[k], err_msg=k)

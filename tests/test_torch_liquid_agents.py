"""The port's liquid agents (``agents/liquid_agents.py``: liquid A2C,
PPO-GAE and SAC) against the JAX package's.

Updates from the same carry (JAX's init weights and Adam states carried to
the port through ``carry_tree``) on the same numpy-made inputs, stored
hidden states among them, at the JAX tests' widths (16 neurons, 3
unfoldings; ``tests/test_liquid_trainer.py``), batch 16:

- SAC: three updates in a row with JAX's own draws fed to the port
  (``k_next, k_curr = split(key)``, ``uniform(k, (B, A))`` each); the
  losses and the whole carry at 1e-5 (f32 summation order; no gradient is
  zero in exact arithmetic, as for the MLP SAC);
- A2C: three updates on N(0, 1) batches, the losses and the whole carry at
  1e-5: the mean advantage of its [B,1,1] broadcast is no cancellation
  there (ROADMAP Queue C trap 12); the critic's target keeps its gradient
  (the reference's quirk), which a detached target would change by far
  more than that;
- PPO-GAE: three updates on 16 trajectories of 3 to 40 steps, padded with
  done = 1 to a multiple of 32 as the JAX agent pads them; the actor and
  every actor loss at 1e-5, the first critic loss at 1e-5, the critic
  within 2 lr per epoch and its last epoch alone at 1e-6 (trap 11: at the
  first epoch v - returns sums to zero, so the output bias's gradient is
  f32 noise that Adam's first step amplifies to up to lr).

Then the sequential tier on real cartpole transitions (the port's env,
one world): the same ``act``/``done`` sequence through both agents, JAX's
``_act_fn`` (and PPO-GAE's ``_value_fn``) patched to return the port's
draws and hidden states, so that each batch JAX trains on must equal the
port's; the hidden states follow their rules (advance at each act, the
next act's "in" is the last "out", the first state after ``done``); A2C's
update on those transitions holds within 2 lr (trap 12). Checkpoints load
both ways at atol 0, and the committed liquid-SAC cartpole checkpoint
(the port's byte-equal copy of ``runs/.../save_final``) gives the same
policy and hidden states in both packages at 1e-6.
"""

import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evomotion_tpu.agents import liquid_agents as JLA
from evomotion_tpu.networks import distributions as JD
from evomotion_tpu.networks import liquid as JL
from evomotion_tpu.train.checkpoint import _flatten as jflatten
from evomotion_tpu_torch.agents import liquid_agents as PLA
from evomotion_tpu_torch.agents.factory import get_agent_factory
from evomotion_tpu_torch.envs.cartpole import CartPoleFactory
from evomotion_tpu_torch.train.checkpoint import _flatten, _unflatten_like

S, A, N_X, STEPS, B = 7, 3, 16, 3, 16
LR = 1e-3
EPOCH = 3
TOL = 1e-5
LAST_EPOCH_TOL = 1e-6
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALGOS = ["actor_critic_liquid", "ppo_gae_liquid", "soft_actor_critic_liquid"]
JAX_CLASS = {"actor_critic_liquid": JLA.ActorCriticLiquidAgent,
             "ppo_gae_liquid": JLA.PpoGaeLiquidAgent,
             "soft_actor_critic_liquid": JLA.SoftActorCriticLiquidAgent}
PORT_CLASS = {"actor_critic_liquid": PLA.ActorCriticLiquidAgent,
              "ppo_gae_liquid": PLA.PpoGaeLiquidAgent,
              "soft_actor_critic_liquid": PLA.SoftActorCriticLiquidAgent}
SAC_NETS = PLA.SoftActorCriticLiquidAgent.NETS


def _args(algo, seed=0, batch=B, epoch=EPOCH, buffer=100, train_every=1, state=S, action=A,
          neurons=N_X, steps=STEPS):
    if algo == "actor_critic_liquid":
        return (seed, state, action, neurons, batch, LR, 0.99, 0.01, 1e-3, 50, steps, buffer,
                train_every)
    if algo == "ppo_gae_liquid":
        return (seed, state, action, neurons, steps, 0.99, 0.95, 0.2, 0.01, 0.5, epoch, batch,
                train_every, buffer, LR, 0.5)
    return (seed, state, action, neurons, batch, 1, LR, 0.99, 0.005, steps, buffer, train_every)


def _carry(j):
    if isinstance(j, JLA.SoftActorCriticLiquidAgent):
        return j._carry()
    return (j.actor_params, j.actor_opt_state, j.critic_params, j.critic_opt_state)


def _pair(algo, **kw):
    """(JAX agent, port agent on the CPU), the port holding JAX's carry."""
    j = JAX_CLASS[algo](*_args(algo, **kw))
    p = PORT_CLASS[algo](*_args(algo, **kw), device="cpu")
    p.load_carry_tree(_unflatten_like(jflatten(_carry(j)), p.carry_tree()))
    return j, p


def _close(got, ref, what, tol=TOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=tol, atol=tol, err_msg=what)


def _compare(p, jcarry, parts=None, tol=TOL):
    ref, got = jflatten(jcarry), _flatten(p.carry_tree())
    assert ref.keys() == got.keys()
    for k in ref:
        if parts is None or int(k.split("/")[0]) in parts:
            assert got[k].dtype == ref[k].dtype, k
            _close(got[k], ref[k], k, tol)


def _f32(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _step_batch(rng, nets):
    """(states, actions, rewards, dones, next_states, x, next_x) with x and
    next_x {net: [B, n]} N(0, 1)."""
    return [_f32(rng, B, S), rng.uniform(-1, 1, (B, A)).astype(np.float32), _f32(rng, B, 1),
            (rng.uniform(size=(B, 1)) < 0.2).astype(np.float32), _f32(rng, B, S),
            {n: _f32(rng, B, N_X) for n in nets}, {n: _f32(rng, B, N_X) for n in nets}]


def _trajectories(rng, actor_params):
    """16 padded trajectories of 3 to 40 steps, each ending done, laid out as
    the JAX agent packs them (the stored hidden states zero past each end);
    log-probs near the actor's own."""
    lens = rng.integers(3, 41, B)
    lens[0] = 40
    pad = 64
    steps = np.arange(pad)[None, :, None] < lens[:, None, None]
    out = [np.where(steps, _f32(rng, B, pad, w), 0.0).astype(np.float32)
           for w in (S, A, 1, A, 1, 1, N_X, N_X)]
    states, actions, rewards, log_probs, values, next_values, ax, cx = out
    actions = np.clip(actions, -1, 1)
    dones = np.where(np.arange(pad)[None, :, None] >= lens[:, None, None] - 1, 1.0, 0.0)
    mu, sigma, _ = JL.liquid_actor_apply(actor_params, jnp.asarray(ax), jnp.asarray(states),
                                         STEPS)
    lp = np.asarray(JD.truncated_normal_log_pdf(jnp.asarray(actions), mu, sigma))
    log_probs = np.where(steps, 0.05 * log_probs + lp, 0.0).astype(np.float32)
    return [states, actions, rewards, dones.astype(np.float32), log_probs,
            0.3 * values, 0.3 * next_values, ax, cx]


_TRAIN = {}


def _jax_update(algo, carry, batch, epoch=EPOCH, key=None, ef=0.01):
    """JAX's train function (jitted once per algo and epoch count) from
    ``carry`` on ``batch``; returns (carry, losses)."""
    if (algo, epoch) not in _TRAIN:
        _TRAIN[algo, epoch] = jax.jit(JAX_CLASS[algo](*_args(algo, epoch=epoch))._make_train_fn())
    train = _TRAIN[algo, epoch]
    if algo == "soft_actor_critic_liquid":
        return train(carry, key, *batch)
    if algo == "actor_critic_liquid":
        *head, x, nx = batch
        out = train(*carry, *head, x["actor"], x["critic"], nx["critic"], jnp.float32(ef))
    else:
        out = train(*carry, *batch)
    return out[:4], out[4]


def _tensors(batch):
    return [{k: torch.as_tensor(v) for k, v in x.items()} if isinstance(x, dict)
            else torch.as_tensor(x) for x in batch]


def _sac_draws(key):
    k_next, k_curr = jax.random.split(key)
    return [torch.tensor(np.asarray(jax.random.uniform(k, (B, A)))) for k in (k_next, k_curr)]


def test_sac_updates_match_jax():
    algo = "soft_actor_critic_liquid"
    j, p = _pair(algo)
    carry = _carry(j)
    rng = np.random.default_rng(1)
    key = jax.random.PRNGKey(5)
    for i in range(3):
        batch = _step_batch(rng, SAC_NETS)
        key, sub = jax.random.split(key)
        carry, jl = _jax_update(algo, carry, batch, key=sub)
        pl = p.update(_tensors(batch), *_sac_draws(sub))
        _close(pl, np.stack([np.asarray(x) for x in jl]), f"update {i} losses")
        _compare(p, carry)
    assert int(jflatten(carry)["1/0/count"]) == 3  # the actor's plain Adam


def test_a2c_updates_match_jax():
    algo = "actor_critic_liquid"
    j, p = _pair(algo)
    carry = _carry(j)
    rng = np.random.default_rng(2)
    for i in range(3):
        batch = _step_batch(rng, ("actor", "critic"))
        ef = p.entropy_factor()
        carry, jl = _jax_update(algo, carry, batch, ef=ef)
        pl = p.update(_tensors(batch), ef)
        _close(pl, np.stack([np.asarray(x) for x in jl]), f"update {i} losses")
        _compare(p, carry)
        p.curr_train_step += 1
    assert int(jflatten(carry)["1/0/count"]) == 3


def test_a2c_keeps_the_undetached_target():
    """The reference's critic target keeps its gradient through the next
    value: a detached target moves the critic by far more than the
    tolerance, so the parity above would catch a "fix"."""
    _, p = _pair("actor_critic_liquid")
    _, q = _pair("actor_critic_liquid")
    batch = _tensors(_step_batch(np.random.default_rng(3), ("actor", "critic")))
    p.update(batch, 0.01)
    states, _, rewards, dones, next_states, x, nx = batch
    with torch.no_grad():
        target = (rewards - rewards.mean()) / (rewards.std() + 1e-8) + (
            1.0 - dones) * 0.99 * q.critic(nx["critic"], next_states)[0]
    q._step("critic", ((q.critic(x["critic"], states)[0] - target) ** 2).mean())
    diff = max(float((a - b).detach().abs().max()) for a, b in zip(p.critic.parameters(),
                                                                   q.critic.parameters()))
    assert diff > 100 * TOL


def _compare_critic_last_epoch(p, start, batch, jend):
    """The last critic epoch alone: the port's update from ``start``, its
    critic overwritten with JAX's after epoch - 1 epochs once it has taken
    as many steps, must land on JAX's critic after all epochs at 1e-6."""
    algo = "ppo_gae_liquid"
    jprev, _ = _jax_update(algo, start, batch, epoch=EPOCH - 1)
    p.load_carry_tree(_unflatten_like(jflatten(start), p.carry_tree()))
    own, steps = p._step, []

    def step(name, loss):
        out = own(name, loss)
        if name == "critic":
            steps.append(out)
            if len(steps) == EPOCH - 1:
                tree = _unflatten_like(jflatten(jprev), p.carry_tree())
                p.load_tree("critic", tree[2])
                p.load_tree("critic_optimizer", tree[3])
        return out

    p._step = step
    p.update(_tensors(batch))
    del p._step
    assert len(steps) == EPOCH
    _compare(p, jend, parts=(2, 3), tol=LAST_EPOCH_TOL)


def test_ppo_gae_updates_match_jax():
    algo = "ppo_gae_liquid"
    j, p = _pair(algo)
    carry = _carry(j)
    rng = np.random.default_rng(4)
    for i in range(3):
        batch = _trajectories(rng, carry[0])
        start = carry
        carry, jl = _jax_update(algo, carry, batch)
        pl = p.update(_tensors(batch))
        jl = np.stack([np.asarray(x) for x in jl], -1)  # [epoch, 2]
        _close(pl[:, 0], jl[:, 0], f"update {i} actor losses")
        _close(pl[0, 1], jl[0, 1], f"update {i} first critic loss")
        _compare(p, carry, parts=(0, 1))
        ref, got = jflatten(carry), _flatten(p.carry_tree())
        for k in ref:
            if k.startswith("2/"):
                np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=2 * LR * EPOCH,
                                           err_msg=k)
        actor = p.carry_tree()[:2]
        _compare_critic_last_epoch(p, start, batch, carry)
        # the next update starts from JAX's critic; the actor stays the port's
        p.load_carry_tree(_unflatten_like(jflatten(carry), p.carry_tree()))
        p.load_tree("actor", actor[0])
        p.load_tree("actor_optimizer", actor[1])
    assert int(jflatten(carry)["1/1/0/count"]) == 3 * EPOCH


def _cartpole_episodes(n_steps, seed=0):
    """Real transitions of the port's cartpole (one world, settle frames
    stepped through with zero actions), as (observation [1, 7], reward,
    done) per agent step, under uniform random actions: ``(first obs,
    [(action, obs, reward, done), ...])``."""
    env = CartPoleFactory({"reset_frame_nb": "2", "mas_steps": "12"}).make(seed, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    zeros = torch.zeros((1, 1))
    state, res = env.reset(1, gen)
    first, out = res.obs, []
    for _ in range(n_steps):
        action = torch.rand((1, 1), generator=gen) * 2 - 1
        state, res = env.step(state, action, gen)
        while not bool(res.valid[0]):
            state, res = env.step(state, zeros, gen)
        out.append((res.obs, float(res.reward[0]), bool(res.done[0])))
    return first, out


@pytest.mark.parametrize("algo", ALGOS)
def test_sequential_bookkeeping_matches_jax(algo):
    """The same act/done sequence through both agents on real cartpole
    transitions, an episode ending when the env says done (the win horizon
    at 12 steps). A2C: batch 4, train every 3 steps, buffer 10 (FIFO
    eviction runs); PPO-GAE: 2 trajectories, train after every episode,
    buffer 3; SAC: batch 4, an update per step, buffer 10. Each batch JAX
    trains on must be the port's (atol 1e-6); after each update the port
    takes JAX's carry (the updates are held above), A2C's first within 2 lr
    (trap 12). Both agents are at the first state after each ``done``."""
    kw = dict(state=7, action=1)
    kw.update(dict(batch=2, buffer=3, train_every=1) if algo == "ppo_gae_liquid"
              else dict(batch=4, buffer=10, train_every=3 if algo == "actor_critic_liquid" else 1))
    j, p = _pair(algo, **kw)
    sac, gae = algo == "soft_actor_critic_liquid", algo == "ppo_gae_liquid"
    nets = SAC_NETS if sac else ("actor", "critic")
    seen = {"port": [], "jax": []}
    own_update, jax_train, own_policy = p.update, j._train_fn, p._policy

    def update(batch, *rest):
        if gae:
            got = list(batch)
        elif sac:
            got = [*batch[:5], *(batch[5][n] for n in nets), *(batch[6][n] for n in nets)]
        else:
            got = [*batch[:5], batch[5]["actor"], batch[5]["critic"], batch[6]["critic"]]
        seen["port"].append([x.numpy().copy() for x in got])
        return own_update(batch, *rest)

    def train(*args):
        if gae:
            ref = args[4:13]
        elif sac:
            ref = [*args[2:7], *(args[7][n] for n in nets), *(args[8][n] for n in nets)]
        else:
            ref = args[4:12]
        seen["jax"].append([np.asarray(x) for x in ref])
        return jax_train(*args)

    drawn = []

    def policy(state):
        drawn.append(own_policy(state))
        return drawn[-1]

    p.update, j._train_fn, p._policy = update, train, policy
    first, steps = _cartpole_episodes(40)
    obs, reward = first, 0.0
    a2c_errs, n_done = [], 0
    for next_obs, r, done in steps:
        n_before = j.curr_train_step
        p.act(obs, reward)
        action = drawn[-1][0][0].numpy()
        new = {n: jnp.asarray(p.x[n].numpy()) for n in nets}
        if gae:
            _, lp, v, _ = drawn[-1]
            j._act_fn = lambda *_, a=action, lp=lp[0].numpy(), v=v.numpy(), x=new: (
                jnp.asarray(a), jnp.asarray(lp), jnp.asarray(v), x["actor"], x["critic"])
        elif sac:
            j._act_fn = lambda *_, a=action, x=new: (jnp.asarray(a), x)
        else:
            j._act_fn = lambda *_, a=action, x=new: (jnp.asarray(a), x["actor"], x["critic"])
        j.act(jnp.asarray(obs[0].numpy()), reward)
        if done:
            n_done += 1
            if gae:
                with torch.no_grad():
                    v, cx = p.critic(p.x["critic"], next_obs)
                j._value_fn = lambda *_, v=v[0].numpy(), cx=cx.numpy(): (jnp.asarray(v),
                                                                           jnp.asarray(cx))
            p.done(next_obs, r)
            j.done(jnp.asarray(next_obs[0].numpy()), r)
            jx = j.x if sac else {"actor": j.actor_x, "critic": j.critic_x}
            for n in nets:
                assert not p.x[n].any() and not np.asarray(jx[n]).any()
        # as the sequential train loop: the next act sees the last result
        obs, reward = next_obs, r
        if j.curr_train_step > n_before:
            if algo == "actor_critic_liquid" and not a2c_errs:
                ref, got = jflatten(_carry(j)), _flatten(p.carry_tree())
                a2c_errs.append(max(float(np.abs(got[k] - ref[k]).max()) for k in ref
                                    if k.split("/")[0] in ("0", "2")))
            p.load_carry_tree(_unflatten_like(jflatten(_carry(j)), p.carry_tree()))
    assert n_done >= 2
    assert p.curr_train_step == j.curr_train_step == len(seen["jax"]) == len(seen["port"]) > 0
    for got, ref in zip(seen["port"], seen["jax"]):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-6)
    if algo == "actor_critic_liquid":
        assert a2c_errs and a2c_errs[0] <= 2 * LR
    assert (p.global_curr_step, p.curr_episode_step) == (j.global_curr_step, j.curr_episode_step)
    for pm, jm in zip(p.get_metrics(), j.get_metrics(), strict=True):
        assert pm.name == jm.name and pm.curr_step == jm.curr_step


@pytest.mark.parametrize("algo", ["actor_critic_liquid", "soft_actor_critic_liquid"])
def test_stored_hidden_states_chain_and_reset(algo):
    """A step buffer's items: each act's "in" states are the last act's
    "out" states within an episode, the first state after ``done``, and
    "out" is the nets' forward from "in" (all five SAC chains with the
    act's (obs, action))."""
    p = PORT_CLASS[algo](*_args(algo, batch=64, buffer=100), device="cpu")
    rng = np.random.default_rng(5)
    for t in range(12):
        p.act(torch.as_tensor(_f32(rng, 1, S)), 0.1)
        if t % 5 == 4:
            p.done(torch.as_tensor(_f32(rng, 1, S)), 0.2)
    items = p.replay_buffer.memory
    for t, item in enumerate(items):
        x_in, x_out = item.x_t["in"], item.x_t["out"]
        if t % 5 == 0:
            assert all(not x.any() for x in x_in.values())
        else:
            for n in p.NETS:
                assert torch.equal(x_in[n], items[t - 1].x_t["out"][n])
        s, a = item.step.state[None], item.step.action[None]
        with torch.no_grad():
            for n in p.NETS:
                net = getattr(p, n)
                want = net(x_in[n], s)[-1] if n in ("actor", "critic") else net(x_in[n], s, a)[1]
                torch.testing.assert_close(x_out[n], want, rtol=0, atol=0)
                assert bool((x_out[n] != x_in[n]).any())


def _equal_trees(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("algo", ALGOS)
def test_checkpoints_load_both_ways(algo, tmp_path):
    j, p = _pair(algo)
    rng = np.random.default_rng(6)
    sac = algo == "soft_actor_critic_liquid"

    def batch():
        if algo == "ppo_gae_liquid":
            return _trajectories(rng, _carry(j)[0])
        return _step_batch(rng, SAC_NETS if sac else ("actor", "critic"))

    p.update(_tensors(batch()), *(() if sac or algo == "ppo_gae_liquid" else (0.01,)))
    p.save(str(tmp_path / "port"))
    j2, _ = _pair(algo, seed=9)
    j2.load(str(tmp_path / "port"))
    _equal_trees(jflatten(_carry(j2)), _flatten(p.carry_tree()))

    carry, _ = _jax_update(algo, _carry(j), batch(), key=jax.random.PRNGKey(1))
    if sac:
        j._uncarry(carry)
    else:
        j.actor_params, j.actor_opt_state, j.critic_params, j.critic_opt_state = carry
    j.save(str(tmp_path / "jax"))
    _, p2 = _pair(algo, seed=9)
    p2.load(str(tmp_path / "jax"))
    _equal_trees(_flatten(p2.carry_tree()), jflatten(_carry(j)))
    assert p2.count_parameters() == j.count_parameters()


COMMITTED = os.path.join(ROOT, "runs", "cartpole_soft_actor_critic_liquid", "save_final")
COPY = os.path.join(ROOT, "evomotion_tpu_torch", "resources", "cartpole_sac_liquid")


def test_committed_liquid_sac_copy_is_byte_equal():
    names = sorted(os.listdir(COMMITTED))
    assert sorted(os.listdir(COPY)) == names and len(names) == 10
    match, mismatch, errors = filecmp.cmpfiles(COMMITTED, COPY, names, shallow=False)
    assert match == names and not mismatch and not errors


def test_committed_liquid_sac_loads_in_both_packages():
    """The copy (written by the JAX package's
    ``tools/train_offpolicy_cartpole.py``: 32 neurons, 6 unfoldings) loads
    into both agents: every array equal, and on the same cartpole
    observations and hidden states the same mu, sigma and new states of
    every net at 1e-6."""
    args = _args("soft_actor_critic_liquid", state=7, action=1, neurons=32, steps=6)
    j = JLA.SoftActorCriticLiquidAgent(*args)
    p = PLA.SoftActorCriticLiquidAgent(*args, device="cpu")
    j.load(COPY)
    p.load(COPY)
    for c in p.SAVE:
        with np.load(os.path.join(COPY, f"{c}.npz")) as f:
            _equal_trees(_flatten(p.tree(c)), dict(f.items()))
    _equal_trees(_flatten(p.carry_tree()), jflatten(j._carry()))
    rng = np.random.default_rng(7)
    obs = _f32(rng, 8, 7, scale=0.3)
    x = {n: _f32(rng, 8, 32, scale=0.3) for n in SAC_NETS}
    u = rng.uniform(size=(8, 1)).astype(np.float32)
    jmu, jsigma, jax_ = JL.liquid_actor_apply(j.actor_params, x["actor"], obs, 6)
    action, new = p.advance({n: torch.as_tensor(v) for n, v in x.items()},
                            torch.as_tensor(obs), u=torch.as_tensor(u))
    with torch.no_grad():
        mu, sigma, _ = p.actor(torch.as_tensor(x["actor"]), torch.as_tensor(obs))
    _close(mu, jmu, "mu", LAST_EPOCH_TOL)
    _close(sigma, jsigma, "sigma", LAST_EPOCH_TOL)
    _close(new["actor"], jax_, "actor x", LAST_EPOCH_TOL)
    params = {"critic_1": j.critic_1_params, "critic_2": j.critic_2_params,
              "target_critic_1": j.target_critic_1_params,
              "target_critic_2": j.target_critic_2_params}
    for n, jp in params.items():
        _, jx = JL.liquid_q_net_apply(jp, x[n], obs, action.numpy(), 6)
        _close(new[n], jx, f"{n} x", LAST_EPOCH_TOL)
    assert bool(torch.isfinite(mu).all() and (sigma > 0).all())


# the mirrors of tests/test_agents.py, through the factory's strict keys
STATE, ACTION, BATCH = 3, 2, 2
COMMON = {"seed": "42", "neuron_number": "4", "unfolding_steps": "2", "batch_size": str(BATCH),
          "lr": "1e-3", "learning_rate": "1e-3", "gamma": "0.99", "lambda": "0.95",
          "epsilon": "0.2", "entropy_factor": "0.01", "entropy_start_factor": "0.01",
          "entropy_end_factor": "0.001", "entropy_steps": "1000", "critic_loss_factor": "0.5",
          "epoch": "2", "train_every": "2", "replay_buffer_size": "64", "clip_grad_norm": "0.5",
          "tau": "0.005"}


@pytest.mark.parametrize("name", ALGOS)
def test_agent_acts_and_trains(name):
    agent = get_agent_factory(name, dict(COMMON)).create_agent(STATE, ACTION, device="cpu")
    rng = np.random.default_rng(0)
    for _episode in range(3):
        for _step in range(2 * BATCH):
            action = agent.act(torch.as_tensor(_f32(rng, 1, STATE)), float(rng.normal()))
            assert tuple(action.shape) == (1, ACTION)
            assert bool(((action >= -1.0) & (action <= 1.0)).all())
        agent.done(torch.as_tensor(_f32(rng, 1, STATE)), float(rng.normal()))
    for meter in agent.get_metrics():
        assert not np.isnan(meter.loss())
    assert agent.count_parameters() > 0
    assert agent.curr_train_step == {"actor_critic_liquid": 5, "ppo_gae_liquid": 1,
                                     "soft_actor_critic_liquid": 10}[name]


@pytest.mark.parametrize("name", ALGOS)
def test_missing_agent_param_raises(name):
    params = dict(COMMON)
    del params["unfolding_steps"]
    with pytest.raises(ValueError, match="unfolding_steps"):
        get_agent_factory(name, params).create_agent(STATE, ACTION, device="cpu")

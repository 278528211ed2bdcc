"""The port's on-policy agents (A2C, PPO-vanilla, the sequential PPO-GAE)
against the JAX package's.

One update, and three in a row, from the same carry (JAX's init weights
and Adam states carried across to the port through ``carry_tree``) on the
same numpy-made batches: hidden 16, batch 16; PPO-GAE on 16 trajectories
of unequal lengths (3 to 40 steps), padded with done = 1 to a multiple of
32 as the JAX agent pads them. None of these updates draws a random number.

Tolerances: 1e-5 on the losses and the carry, as
``test_torch_offpolicy_agents.py`` (the two differ by f32 summation order).
A2C's whole carry is held there: its critic target is not centred on the
critic's values, so no gradient is zero in exact arithmetic, and the
actor's [B,B,A] broadcast of the reference is kept (a squeezed advantage
moves the actor by far more than 1e-5: ``test_a2c_keeps_the_broadcast``).
The PPO critics are not: at their first epoch v - target is minus the
normalized advantages, which sum to zero over the batch (PPO-GAE: over the
valid steps), so the gradients of the output bias and of the last
LayerNorm's bias are f32 noise that Adam's first step turns into up to lr
either way in each package (ROADMAP Queue C trap 11). So a PPO critic is
held to 2 lr per epoch over the whole update, its first epoch's loss at
1e-5, and its last epoch alone at 1e-6: the port's update runs from the
start, but once its critic has taken epoch - 1 steps, that critic and its
Adam state are overwritten with JAX's after as many epochs (JAX's train
function with epoch - 1 epochs on the same batch), and the port's last step
must land on JAX's state (``_compare_critic_last_epoch``, as
``test_torch_ppo.py``). Between updates the port's critic takes JAX's, so
the next update starts from one critic; the actor is never synced.

Then the sequential ``act``/``done`` bookkeeping against the JAX agents
(JAX's ``_act_fn`` patched to return the port's draws), checkpoints both
ways at atol 0, and the mirrors of ``tests/test_agents.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evomotion_tpu.agents.actor_critic import ActorCriticAgent as JA2c
from evomotion_tpu.agents.ppo_gae import PpoGaeAgent as JGae
from evomotion_tpu.agents.ppo_vanilla import PpoVanillaAgent as JVanilla
from evomotion_tpu.networks import distributions as JD
from evomotion_tpu.networks.modules import actor_apply
from evomotion_tpu.train.checkpoint import _flatten as jflatten
from evomotion_tpu_torch.agents.actor_critic import ActorCriticAgent
from evomotion_tpu_torch.agents.factory import get_agent_factory
from evomotion_tpu_torch.agents.ppo_gae import PpoGaeAgent
from evomotion_tpu_torch.agents.ppo_vanilla import PpoVanillaAgent
from evomotion_tpu_torch.networks import distributions as PD
from evomotion_tpu_torch.train.checkpoint import _flatten, _unflatten_like

S, A, H, B = 7, 3, 16, 16
LR = 1e-3
EPOCH = 3
TOL = 1e-5
LAST_EPOCH_TOL = 1e-6
ALGOS = ["actor_critic", "ppo_vanilla", "ppo_gae"]


def _args(algo, seed=0, batch=B, epoch=EPOCH, buffer=100, train_every=1, hidden=H):
    if algo == "actor_critic":
        return (seed, S, A, hidden, batch, LR, 0.99, 0.01, 1e-3, 50, buffer, train_every)
    if algo == "ppo_vanilla":
        return (seed, S, A, hidden, 0.99, 0.2, 0.01, 0.5, epoch, batch, LR)
    return (seed, S, A, hidden, 0.99, 0.95, 0.2, 0.01, 0.5, epoch, batch, train_every, buffer,
            LR, 0.5)


JAX_CLASS = {"actor_critic": JA2c, "ppo_vanilla": JVanilla, "ppo_gae": JGae}
PORT_CLASS = {"actor_critic": ActorCriticAgent, "ppo_vanilla": PpoVanillaAgent,
              "ppo_gae": PpoGaeAgent}


def _carry(j):
    return (j.actor_params, j.actor_opt_state, j.critic_params, j.critic_opt_state)


def _uncarry(j, carry):
    j.actor_params, j.actor_opt_state, j.critic_params, j.critic_opt_state = carry


def _pair(algo, **kw):
    """(JAX agent, port agent on the CPU), the port holding JAX's carry."""
    j = JAX_CLASS[algo](*_args(algo, **kw))
    p = PORT_CLASS[algo](*_args(algo, **kw), device="cpu")
    p.load_carry_tree(_unflatten_like(jflatten(_carry(j)), p.carry_tree()))
    return j, p


def _close(got, ref, what, tol=TOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=tol, atol=tol, err_msg=what)


def _compare(p, jcarry, parts=(0, 1, 2, 3), tol=TOL):
    ref, got = jflatten(jcarry), _flatten(p.carry_tree())
    assert ref.keys() == got.keys()
    for k in ref:
        if int(k.split("/")[0]) in parts:
            assert got[k].dtype == ref[k].dtype, k
            _close(got[k], ref[k], k, tol)


def _step_batch(rng):
    return [rng.standard_normal((B, S)).astype(np.float32),
            rng.uniform(-1, 1, (B, A)).astype(np.float32),
            rng.standard_normal((B, 1)).astype(np.float32),
            (rng.uniform(size=(B, 1)) < 0.2).astype(np.float32),
            rng.standard_normal((B, S)).astype(np.float32)]


def _trajectories(rng, actor_params):
    """16 padded trajectories of 3 to 40 steps, each ending done, laid out
    as the JAX agent packs them; log-probs near the actor's own."""
    lens = rng.integers(3, 41, B)
    lens[0] = 40
    pad = 64
    states = np.zeros((B, pad, S), np.float32)
    actions = np.zeros((B, pad, A), np.float32)
    rewards = np.zeros((B, pad, 1), np.float32)
    dones = np.ones((B, pad, 1), np.float32)
    log_probs = np.zeros((B, pad, A), np.float32)
    values = np.zeros((B, pad, 1), np.float32)
    next_values = np.zeros((B, pad, 1), np.float32)
    for i, n in enumerate(lens):
        states[i, :n] = rng.standard_normal((n, S))
        actions[i, :n] = rng.uniform(-1, 1, (n, A))
        rewards[i, :n, 0] = rng.standard_normal(n)
        dones[i, :n - 1] = 0.0
        log_probs[i, :n] = 0.05 * rng.standard_normal((n, A))
        v = 0.3 * rng.standard_normal(n + 1)
        values[i, :n, 0], next_values[i, :n, 0] = v[:-1], v[1:]
    mu, sigma = actor_apply(actor_params, jnp.asarray(states))
    lp = np.asarray(JD.truncated_normal_log_pdf(jnp.asarray(actions), mu, sigma))
    steps = np.arange(pad)[None, :, None] < lens[:, None, None]
    log_probs = np.where(steps, log_probs + lp, 0.0).astype(np.float32)  # padding stays 0
    return [states, actions, rewards, dones, log_probs, values, next_values]


def _batch(algo, rng, j):
    return _trajectories(rng, j.actor_params) if algo == "ppo_gae" else _step_batch(rng)


_TRAIN = {}


def _jax_update(j, algo, carry, batch, epoch=EPOCH):
    """JAX's train function (of an agent with ``epoch`` epochs, jitted once
    per algo and epoch count) from ``carry`` on ``batch``; returns (carry,
    losses)."""
    if (algo, epoch) not in _TRAIN:
        _TRAIN[algo, epoch] = jax.jit(
            JAX_CLASS[algo](*_args(algo, epoch=epoch))._make_train_fn())
    out = _TRAIN[algo, epoch](*carry, *batch, *(
        [jnp.float32(_a2c_factor(j))] if algo == "actor_critic" else []))
    return out[:4], out[4]


def _a2c_factor(j):
    return float(JD.exponential_decrease(j.curr_train_step, j.entropy_steps,
                                         j.entropy_start_factor, j.entropy_end_factor))


def _port_update(p, algo, batch):
    t = [torch.as_tensor(x) for x in batch]
    if algo == "actor_critic":
        return p.update(t, p.entropy_factor())
    return p.update(t)


def _compare_critic_last_epoch(j, p, algo, start, batch, jend):
    """The last critic epoch alone: the port's update from ``start``, its
    critic overwritten with JAX's after epoch - 1 epochs once it has taken
    as many steps, must land on JAX's critic after all epochs at 1e-6."""
    jprev, _ = _jax_update(j, algo, start, batch, epoch=EPOCH - 1)
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
    _port_update(p, algo, batch)
    del p._step
    assert len(steps) == EPOCH
    _compare(p, jend, parts=(2, 3), tol=LAST_EPOCH_TOL)


@pytest.mark.parametrize("algo", ALGOS)
def test_updates_match_jax(algo):
    """One update, then two more, each from where the one before left off."""
    j, p = _pair(algo)
    carry = _carry(j)
    rng = np.random.default_rng(1)
    for i in range(3):
        batch = _batch(algo, rng, j)
        start = carry
        carry, jl = _jax_update(j, algo, carry, batch)
        pl = _port_update(p, algo, batch)
        if algo == "actor_critic":
            _close(pl, jl, f"update {i} losses")
            _compare(p, carry)
            j.curr_train_step += 1
            p.curr_train_step += 1
            continue
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
        _compare_critic_last_epoch(j, p, algo, start, batch, carry)
        # the next update starts from JAX's critic; the actor stays the port's
        p.load_carry_tree(_unflatten_like(jflatten(carry), p.carry_tree()))
        p.load_tree("actor", actor[0])
        p.load_tree("actor_optimizer", actor[1])
    count = "1/1/0/count" if algo == "ppo_gae" else "1/0/count"
    assert int(jflatten(carry)[count]) == (3 if algo == "actor_critic" else 3 * EPOCH)


def test_a2c_keeps_the_broadcast():
    """The reference's [B,1,1] x [B,A] advantage broadcast: the actor's
    update differs from a squeezed [B,1] advantage's by far more than the
    tolerance, so the parity above would catch a "fix"."""
    _, p = _pair("actor_critic")
    _, q = _pair("actor_critic")
    batch = [torch.as_tensor(x) for x in _step_batch(np.random.default_rng(2))]
    p.update(batch, 0.01)
    with torch.no_grad():
        target = (batch[2] - batch[2].mean()) / (batch[2].std() + 1e-8) + (
            1.0 - batch[3]) * 0.99 * q.critic(batch[4])
        adv = target - q.critic(batch[0])
    mu, sigma = q.actor(batch[0])
    q._step("actor", -(PD.truncated_normal_log_pdf(batch[1], mu, sigma) * adv).sum(-1).mean())
    diff = max(float((a - b).detach().abs().max()) for a, b in zip(p.actor.parameters(),
                                                                   q.actor.parameters()))
    assert diff > 100 * TOL


@pytest.mark.parametrize("algo", ALGOS)
def test_sequential_bookkeeping_matches_jax(algo):
    """The same act/done sequence through both agents: a done every 5 acts.
    A2C: batch 4, train every 3 steps, buffer 10 (FIFO eviction runs).
    PPO-vanilla: batch 4, so the buffer holds 4 steps and sampling needs 5:
    neither package ever trains. PPO-GAE: 2 trajectories, train after every
    episode, buffer 3 trajectories. JAX's ``_act_fn`` (and PPO-GAE's
    ``_value_fn``) return the port's draws; each batch JAX trains on must
    be the one the port trained on, and after each update the port takes
    JAX's carry (the update itself is held above)."""
    kw = (dict(batch=2, buffer=3, train_every=1) if algo == "ppo_gae"
          else dict(batch=4, buffer=10, train_every=3))
    j, p = _pair(algo, **kw)
    seen = {"port": [], "jax": []}
    own_update, jax_train = p.update, j._train_fn

    def update(batch, *rest):
        seen["port"].append([x.numpy().copy() for x in batch])
        return own_update(batch, *rest)

    def train(*args):
        seen["jax"].append([np.asarray(x) for x in args[4:11 if algo == "ppo_gae" else 9]])
        return jax_train(*args)

    p.update, j._train_fn = update, train
    rng = np.random.default_rng(3)
    for t in range(40):
        s = rng.standard_normal(S).astype(np.float32)
        r = float(rng.standard_normal())
        action = p.act(torch.as_tensor(s)[None], r)
        assert tuple(action.shape) == (1, A)
        if algo == "ppo_gae":  # the port's draw with its log-prob and value
            with torch.no_grad():
                mu, sigma = p.actor(torch.as_tensor(s)[None])
                lp = PD.truncated_normal_log_pdf(action, mu, sigma)
                v = p.critic(torch.as_tensor(s)[None])
            j._act_fn = lambda *_, a=action[0].numpy(), lp=lp[0].numpy(), v=v[0].numpy(): (
                jnp.asarray(a), jnp.asarray(lp), jnp.asarray(v))
        else:
            j._act_fn = lambda *_, a=action[0].numpy(): jnp.asarray(a)
        n_before = j.curr_train_step
        j.act(jnp.asarray(s), r)
        if t % 5 == 4:
            s, r = rng.standard_normal(S).astype(np.float32), float(rng.standard_normal())
            with torch.no_grad():
                v = p.critic(torch.as_tensor(s)[None])[0].numpy()
            j._value_fn = lambda *_, v=v: jnp.asarray(v)
            p.done(torch.as_tensor(s)[None], r)
            j.done(jnp.asarray(s), r)
        if j.curr_train_step > n_before:
            p.load_carry_tree(_unflatten_like(jflatten(_carry(j)), p.carry_tree()))
    assert p.curr_train_step == j.curr_train_step == len(seen["jax"]) == len(seen["port"])
    assert p.curr_train_step == {"actor_critic": 12, "ppo_vanilla": 0, "ppo_gae": 7}[algo]
    for got, ref in zip(seen["port"], seen["jax"]):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-6)
    assert (p.global_curr_step, p.curr_episode_step) == (j.global_curr_step, j.curr_episode_step)
    assert len(p.replay_buffer.memory) == len(j.replay_buffer.memory)
    for pm, jm in zip(p.get_metrics(), j.get_metrics()):
        assert pm.name == jm.name and pm.curr_step == jm.curr_step
    _compare(p, _carry(j), parts=(0, 1, 2, 3) if algo == "actor_critic" else ())


def _equal_trees(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("algo", ALGOS)
def test_checkpoints_load_both_ways(algo, tmp_path):
    j, p = _pair(algo)
    rng = np.random.default_rng(4)
    _port_update(p, algo, _batch(algo, rng, j))  # moments and counts move
    p.save(str(tmp_path / "port"))
    j2 = JAX_CLASS[algo](*_args(algo, seed=9))
    j2.load(str(tmp_path / "port"))
    _equal_trees(jflatten(_carry(j2)), _flatten(p.carry_tree()))

    carry, _ = _jax_update(j, algo, _carry(j), _batch(algo, rng, j))
    _uncarry(j, carry)
    j.save(str(tmp_path / "jax"))
    p2 = PORT_CLASS[algo](*_args(algo, seed=9), device="cpu")
    p2.load(str(tmp_path / "jax"))
    _equal_trees(_flatten(p2.carry_tree()), jflatten(_carry(j)))
    assert p2.count_parameters() == j.count_parameters()


# the mirrors of tests/test_agents.py
STATE, ACTION, HIDDEN, BATCH = 3, 2, 3, 2
COMMON = {"seed": "42", "hidden_size": str(HIDDEN), "batch_size": str(BATCH), "lr": "1e-3",
          "learning_rate": "1e-3", "gamma": "0.99", "lambda": "0.95", "epsilon": "0.2",
          "entropy_factor": "0.01", "entropy_start_factor": "0.01",
          "entropy_end_factor": "0.001", "entropy_steps": "1000", "critic_loss_factor": "0.5",
          "epoch": "2", "train_every": "2", "replay_buffer_size": "64",
          "clip_grad_norm": "0.5"}


@pytest.mark.parametrize("name", ALGOS)
def test_agent_acts_and_trains(name):
    agent = get_agent_factory(name, dict(COMMON)).create_agent(STATE, ACTION, device="cpu")
    rng = np.random.default_rng(0)
    for _episode in range(3):
        for _step in range(2 * BATCH):
            state = torch.as_tensor(rng.normal(size=(1, STATE)).astype(np.float32))
            action = agent.act(state, float(rng.normal()))
            assert tuple(action.shape) == (1, ACTION)
            assert not bool(torch.isnan(action).any())
            assert bool(((action >= -1.0) & (action <= 1.0)).all())
        agent.done(torch.as_tensor(rng.normal(size=(1, STATE)).astype(np.float32)),
                   float(rng.normal()))
    for meter in agent.get_metrics():
        assert not np.isnan(meter.loss())
    assert agent.count_parameters() > 0
    assert agent.curr_train_step == {"actor_critic": 5, "ppo_vanilla": 0, "ppo_gae": 1}[name]


@pytest.mark.parametrize("name", ALGOS)
def test_agent_save_load_roundtrip(name, tmp_path):
    agent = get_agent_factory(name, dict(COMMON)).create_agent(STATE, ACTION, device="cpu")
    rng = np.random.default_rng(1)
    for _ in range(2 * BATCH):
        agent.act(torch.as_tensor(rng.normal(size=(1, STATE)).astype(np.float32)), 0.1)
    agent.done(torch.as_tensor(rng.normal(size=(1, STATE)).astype(np.float32)), 0.1)
    agent.save(str(tmp_path))
    agent2 = get_agent_factory(name, dict(COMMON)).create_agent(STATE, ACTION, device="cpu")
    agent2.load(str(tmp_path))
    for a, b in zip(agent.actor.parameters(), agent2.actor.parameters()):
        assert torch.equal(a, b)
    _equal_trees(_flatten(agent.carry_tree()), _flatten(agent2.carry_tree()))


def test_missing_agent_param_raises():
    with pytest.raises(ValueError):
        get_agent_factory("ppo_gae", {"seed": "1"}).create_agent(STATE, ACTION, device="cpu")

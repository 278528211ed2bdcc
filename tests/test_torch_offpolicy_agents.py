"""The port's SAC and CrossQ agents against the JAX package's.

One update, and three in a row, from the same carry (JAX's init weights
carried across to the port) on the same numpy-made batches, with JAX's own
draws fed to the port: the JAX train function splits its key as ``k_next,
k_curr = split(key)`` and draws ``uniform(k_next, (B, A))`` and
``uniform(k_curr, (B, A))``, which the port's ``update`` takes. Hidden
16, batch 16, with and without ``grad_norm_clip=0.5``. The four losses and
every tensor of the carry (params, target critics, Adam count/mu/nu,
BatchRenorm running_mean/running_std/step, log_alpha) agree at 1e-5, as
``tests/test_networks.py``: the two differ by f32 summation order only.

No tensor here has a gradient that is zero in exact arithmetic at the first
update (the trap of the PPO critic, ``test_torch_ppo.py``): the entropy
loss is 0 at log_alpha = 0 but its gradient, -mean(log pi + H), is not;
BatchRenorm's first step (r = 1, d = 0) is plain batch norm, whose
gradients reach every parameter through the Mish after each Linear. So the
whole carry is held at 1e-5.

Then: the nan guard leaves the agent bit-equal on a NaN-reward batch and
reads 0 losses; the sequential ``act``/``done`` bookkeeping matches JAX's
(the JAX agent's ``_act_fn`` patched to return the port's actions, the
port's updates fed JAX's key stream); checkpoints load both ways at atol
0, the committed ``runs/cartpole_*/save_final`` directories among them.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evomotion_tpu.agents.cross_q import CrossQAgent as JCrossQ
from evomotion_tpu.agents.soft_actor_critic import SoftActorCriticAgent as JSac
from evomotion_tpu.train.checkpoint import _flatten as jflatten
from evomotion_tpu_torch.agents.cross_q import CrossQAgent
from evomotion_tpu_torch.agents.soft_actor_critic import SoftActorCriticAgent
from evomotion_tpu_torch.train.checkpoint import _flatten, _unflatten_like
from evomotion_tpu_torch.train.offpolicy_batched import guarded_update

S, A, H, B = 7, 3, 16, 16
TOL = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALGOS = ["soft_actor_critic", "cross_q"]


def _pair(algo, clip=None, batch=B, epoch=1, buffer=100, train_every=1, seed=0, hidden=H,
          state=S, action=A):
    """(JAX agent, port agent on the CPU), the port holding JAX's carry."""
    args = (seed, state, action, hidden, hidden, batch, epoch, 3e-4, 0.99)
    tail = (buffer, train_every)
    if algo == "soft_actor_critic":
        j = JSac(*args, 0.005, *tail, grad_norm_clip=clip)
        p = SoftActorCriticAgent(*args, 0.005, *tail, grad_norm_clip=clip, device="cpu")
    else:
        j = JCrossQ(*args, *tail, grad_norm_clip=clip)
        p = CrossQAgent(*args, *tail, grad_norm_clip=clip, device="cpu")
    p.load_carry_tree(_unflatten_like(jflatten(j._carry()), p.carry_tree()))
    return j, p


def _compare_carry(p, jcarry, tol=TOL):
    ref, got = jflatten(jcarry), _flatten(p.carry_tree())
    assert ref.keys() == got.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_allclose(got[k], ref[k], rtol=tol, atol=tol, err_msg=k)


def _batch(rng, nan_reward=False):
    rewards = rng.standard_normal((B, 1)).astype(np.float32)
    if nan_reward:
        rewards[3, 0] = np.nan
    return [rng.standard_normal((B, S)).astype(np.float32),
            rng.uniform(-1, 1, (B, A)).astype(np.float32), rewards,
            (rng.uniform(size=(B, 1)) < 0.2).astype(np.float32),
            rng.standard_normal((B, S)).astype(np.float32)]


def _draws(key, b=B):
    k_next, k_curr = jax.random.split(key)
    return [torch.tensor(np.asarray(jax.random.uniform(k, (b, A)))) for k in (k_next, k_curr)]


@pytest.mark.parametrize("clip", [None, 0.5], ids=["noclip", "clip"])
@pytest.mark.parametrize("algo", ALGOS)
def test_updates_match_jax(algo, clip):
    j, p = _pair(algo, clip)
    train = jax.jit(j._make_train_fn())
    carry = j._carry()
    rng = np.random.default_rng(1)
    key = jax.random.PRNGKey(5)
    for i in range(3):
        batch = _batch(rng)
        key, sub = jax.random.split(key)
        carry, jl = train(carry, sub, *batch)
        pl = p.update([torch.as_tensor(x) for x in batch], *_draws(sub))
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
        _compare_carry(p, carry)
    assert int(jflatten(carry)["1/1/0/count" if clip else "1/0/count"]) == 3  # actor Adam


@pytest.mark.parametrize("algo", ALGOS)
def test_nan_guard_keeps_the_agent(algo):
    _, p = _pair(algo)
    rng = np.random.default_rng(2)
    p.update([torch.as_tensor(x) for x in _batch(rng)])  # Adam past its first step
    before = [t.clone() for t in p.tensors()]
    losses = guarded_update(p, [torch.as_tensor(x) for x in _batch(rng, nan_reward=True)],
                            *_draws(jax.random.PRNGKey(0)))
    assert torch.equal(losses, torch.zeros(4))
    after = p.tensors()
    assert len(after) == len(before) and all(torch.equal(a, b) for a, b in zip(after, before))
    # a finite batch still updates
    losses = guarded_update(p, [torch.as_tensor(x) for x in _batch(rng)],
                            *_draws(jax.random.PRNGKey(1)))
    assert bool(torch.isfinite(losses).all()) and not torch.equal(losses, torch.zeros(4))


@pytest.mark.parametrize("algo", ALGOS)
def test_sequential_bookkeeping_matches_jax(algo):
    """The same act/done sequence through both agents: batch 4, train every
    3 steps, buffer 10 (so FIFO eviction runs), a done every 5 acts. The
    port's updates draw from a copy of the JAX agent's key stream (one split
    per act, one per update)."""
    j, p = _pair(algo, batch=4, epoch=1, buffer=10, train_every=3)
    shadow = {"key": j._key}
    own_act, own_update = p.act, p.update

    def act(state, reward):
        shadow["key"], _ = jax.random.split(shadow["key"])
        return own_act(state, reward)

    def update(batch, u_next=None, u_curr=None):
        shadow["key"], sub = jax.random.split(shadow["key"])
        return own_update(batch, *_draws(sub, batch[0].shape[0]))

    p.act, p.update = act, update
    rng = np.random.default_rng(3)
    for t in range(16):
        s = rng.standard_normal(S).astype(np.float32)
        r = float(rng.standard_normal())
        action = p.act(torch.as_tensor(s)[None], r)
        assert tuple(action.shape) == (1, A)
        j._act_fn = lambda *_, a=action[0].numpy(): jnp.asarray(a)
        j.act(jnp.asarray(s), r)
        if t % 5 == 4:
            s, r = rng.standard_normal(S).astype(np.float32), float(rng.standard_normal())
            p.done(torch.as_tensor(s)[None], r)
            j.done(jnp.asarray(s), r)
    assert p.curr_train_step == j.curr_train_step >= 3
    assert (p.global_curr_step, p.curr_episode_step) == (j.global_curr_step, j.curr_episode_step)
    assert len(p.replay_buffer.memory) == len(j.replay_buffer.memory) == 10
    for ps, js in zip(p.replay_buffer.memory, j.replay_buffer.memory):
        for f in ("state", "action", "next_state"):
            np.testing.assert_array_equal(getattr(ps, f).numpy(), np.asarray(getattr(js, f)))
        assert (ps.reward, ps.done) == (js.reward, js.done)
    for pm, jm in zip(p.get_metrics(), j.get_metrics()):
        assert pm.name == jm.name and pm.curr_step == jm.curr_step
        np.testing.assert_allclose(pm.loss(), jm.loss(), rtol=TOL, atol=TOL)
    _compare_carry(p, j._carry())


def _equal_trees(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("clip", [None, 0.5], ids=["noclip", "clip"])
@pytest.mark.parametrize("algo", ALGOS)
def test_checkpoints_load_both_ways(algo, clip, tmp_path):
    j, p = _pair(algo, clip)
    rng = np.random.default_rng(4)
    p.update([torch.as_tensor(x) for x in _batch(rng)])  # moments, counts, BN stats move
    p.save(str(tmp_path / "port"))
    j2, _ = _pair(algo, clip, seed=9)
    j2.load(str(tmp_path / "port"))
    _equal_trees(jflatten(j2._carry()), _flatten(p.carry_tree()))

    train = jax.jit(j._make_train_fn())
    carry, _ = train(j._carry(), jax.random.PRNGKey(1), *_batch(rng))
    j._uncarry(carry)
    j.save(str(tmp_path / "jax"))
    _, p2 = _pair(algo, clip, seed=9)
    p2.load(str(tmp_path / "jax"))
    _equal_trees(_flatten(p2.carry_tree()), jflatten(j._carry()))
    assert p2.count_parameters() == j.count_parameters()


@pytest.mark.parametrize("algo", ALGOS)
def test_committed_cartpole_saves_load(algo):
    """``runs/cartpole_<algo>/save_final`` (written by the JAX package's
    ``tools/train_offpolicy_cartpole.py``: hidden 64, no clip) loads into
    the port's agent: every array of every component file equal."""
    folder = os.path.join(ROOT, "runs", f"cartpole_{algo}", "save_final")
    _, p = _pair(algo, hidden=64, state=7, action=1)
    p.load(folder)
    for c in p.SAVE:
        with np.load(os.path.join(folder, f"{c}.npz")) as f:
            _equal_trees(_flatten(p.tree(c)), dict(f.items()))
    with torch.no_grad():
        mu, sigma = p.actor(torch.zeros(1, 7))
    assert bool(torch.isfinite(mu).all() and (sigma > 0).all())

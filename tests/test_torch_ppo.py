"""The port's batched PPO-GAE trainer against the JAX package's.

Both trainers run on one tiny deterministic env, written twice below (jnp
and torch): 4 observations, 2 actions, episodes that end by a win after 5
steps or by a fail, then one settle step (``valid`` False). N=16 envs, T=8,
hidden 16, 2 epochs, with obs normalization, the sigma scale, the entropy
decay and the survival bonus on. The JAX trainer's state goes to the port
through the checkpoint files (``save_train_state`` -> the port's
``load_train_state``), and the JAX rollout's uniforms (one draw of
``mu.shape`` per step from ``split(state.key, T + 1)[1:]``) are fed to the
port's rollout.

Tolerances. The trajectory, the losses and the metrics at 1e-5, as
``tests/test_networks.py``. The actor's params after the update at 1e-6 and
its Adam moments at 1e-4 of each tensor's largest magnitude: the gradients
differ only by f32 summation order (relative ~1e-6), and Adam's step,
lr * m / (sqrt(v) + eps), moves by at most a quarter of that relative error
times lr. The critic is different: the reference's returns are the
normalized advantages plus the rollout's values, so at the first epoch
v - returns = -advantages, which sum to zero over the valid steps; the
gradient of the output bias ``out.b`` and of the last LayerNorm's bias
``h2.ln.b`` is zero in exact arithmetic and computed as f32 noise (~1e-8),
which Adam's first step, noise / (|noise| + 1e-8), turns into an update of
up to lr either way in each package. With one epoch the rest of the critic
agrees as tightly as the actor and those two stay within lr of their start.
From the second epoch on every critic param inherits the difference, so
the whole train step's critic is held only to 2 * lr per epoch; its last
epoch is then held alone, as tightly as the actor: the port's train step
takes that one critic step from JAX's critic and Adam state after the
epochs before it, on the same rollout, and must land on JAX's state after
the step (``_compare_critic_last_epoch``). There the two bias gradients are real,
since the critic has moved, and the first epoch's noise sits in Adam's
state, which the port takes from JAX.
"""

import types
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evomotion_tpu.train import ppo_batched as JP
from evomotion_tpu_torch.convert import adam_tree, load_adam
from evomotion_tpu_torch.train import ppo_batched as PP
from evomotion_tpu_torch.train.checkpoint import load_component

S, A, N, T, H = 4, 2, 16, 8, 16
_rng = np.random.default_rng(42)
W = (_rng.standard_normal((S, S)) * 0.6).astype(np.float32)
U = (_rng.standard_normal((S, A)) * 0.8).astype(np.float32)
C = (_rng.standard_normal(S) * 0.1).astype(np.float32)
X0 = np.array([0.1, -0.2, 0.3, 0.05], np.float32)
WIN_AT, FAIL_BELOW = 5, -0.3
CFG = dict(hidden_size=H, horizon=T, n_envs=N, epoch=2, obs_norm=True, sigma_scale_end=0.5,
           sigma_scale_steps=4, entropy_steps=4, entropy_end=1e-3, survival_bonus=0.05)


class Res(NamedTuple):
    obs: object
    reward: object
    done: object
    valid: object
    win: object


class JaxToyEnv:
    """One env (the trainer vmaps it): state (x, t, settle)."""

    observation_size, action_size = S, A

    def reset(self, key):
        del key
        st = (jnp.asarray(X0), jnp.int32(0), jnp.int32(0))
        return st, Res(st[0], jnp.float32(0), False, True, False)

    def step(self, state, a):
        x, t, settle = state
        settling = settle > 0
        xn = jnp.tanh(W @ x + U @ a + C)
        r = xn[0] - 0.1 * jnp.sum(a * a)
        tn = t + 1
        win = tn >= WIN_AT
        done = win | (xn[1] < FAIL_BELOW)
        run = (jnp.where(done, X0, xn), jnp.where(done, 0, tn), jnp.where(done, 1, 0))
        new = jax.tree.map(lambda s, r_: jnp.where(settling, s, r_), (x, t, settle - 1), run)
        res = Res(jnp.where(settling, x, xn), jnp.where(settling, 0.0, r), ~settling & done,
                  ~settling, ~settling & win)
        return new, res


class TorchToyEnv:
    """The same env, batch first, on the CPU."""

    observation_size, action_size = S, A
    device = torch.device("cpu")

    def reset(self, n_envs, generator=None):
        x = torch.as_tensor(X0).expand(n_envs, S).clone()
        z = torch.zeros(n_envs, dtype=torch.int32)
        true = torch.ones(n_envs, dtype=torch.bool)
        return (x, z, z.clone()), Res(x, torch.zeros(n_envs), ~true, true, ~true)

    def step(self, state, a, generator=None):
        x, t, settle = state
        settling = settle > 0
        xn = torch.tanh(x @ torch.as_tensor(W).T + a @ torch.as_tensor(U).T + torch.as_tensor(C))
        r = xn[:, 0] - 0.1 * (a * a).sum(-1)
        tn = t + 1
        win = tn >= WIN_AT
        done = win | (xn[:, 1] < FAIL_BELOW)
        x0 = torch.as_tensor(X0).expand_as(x)
        run = (torch.where(done[:, None], x0, xn), torch.where(done, 0, tn),
               torch.where(done, 1, 0).to(torch.int32))
        sets = (x, t, settle - 1)
        new = (torch.where(settling[:, None], sets[0], run[0]),
               *(torch.where(settling, s, r_) for s, r_ in zip(sets[1:], run[1:])))
        res = Res(torch.where(settling[:, None], x, xn), torch.where(settling, 0.0, r),
                  ~settling & done, ~settling, ~settling & win)
        return new, res


def _uniforms(jstate):
    keys = jax.random.split(jstate.key, T + 1)[1:]
    return torch.as_tensor(np.stack([np.asarray(jax.random.uniform(k, (N, A))) for k in keys]))


def _port_state(jstate, tmp_path, name):
    """The JAX train state, saved by the JAX package and loaded by the port."""
    d = str(tmp_path / name)
    JP.save_train_state(d, jstate)
    like = PP.BatchedPpo(TorchToyEnv(), PP.PpoConfig(**CFG), seed=0).init()
    return PP.load_train_state(d, like)


def _close(port, ref, tol=1e-5):
    ref = np.asarray(ref)
    got = port.detach().numpy() if torch.is_tensor(port) else np.asarray(port)
    np.testing.assert_allclose(got.reshape(ref.shape), ref, rtol=tol, atol=tol)


# critic params whose first-epoch gradient is zero in exact arithmetic
ZERO_GRAD = ("out.b", "h2.ln.b")


def _at(tree, name):
    for k in name.split("."):
        tree = tree[k]
    return np.asarray(tree)


def _compare_net(module, opt, jparams, jopt, skip=()):
    """Params at 1e-6 and Adam moments at 1e-4 of each tensor's largest
    magnitude, but for the params in ``skip``; Adam's step count for all."""
    adam = jopt[1][0]
    for name, p in module.named_parameters():
        st = opt.state[p]
        assert float(st["step"]) == int(adam.count)
        if name in skip:
            continue
        _close(p, _at(jparams, name), 1e-6)
        for got, mom in ((st["exp_avg"], _at(adam.mu, name)),
                         (st["exp_avg_sq"], _at(adam.nu, name))):
            scale = float(np.abs(mom).max())
            np.testing.assert_allclose(got.numpy(), mom, rtol=0, atol=1e-4 * scale + 1e-30)


def _compare_after_update(pstate, jstate, jstart, epoch):
    """The port's state after a train step against JAX's; ``jstart`` is the
    JAX state the step started from (see the module docstring)."""
    lr = pstate.actor_opt.param_groups[0]["lr"]
    _compare_net(pstate.actor, pstate.actor_opt, jstate.actor_params, jstate.actor_opt_state)
    loose = [n for n, _ in pstate.critic.named_parameters() if epoch > 1 or n in ZERO_GRAD]
    _compare_net(pstate.critic, pstate.critic_opt, jstate.critic_params,
                 jstate.critic_opt_state, skip=loose)
    for name, p in pstate.critic.named_parameters():
        if name in loose:
            _close(p, _at(jstate.critic_params, name), 2 * lr * epoch)
        if name in ZERO_GRAD:
            start = _at(jstart.critic_params, name)
            assert np.abs(p.detach().numpy() - start).max() <= lr * epoch * 1.001
    assert pstate.iteration == int(jstate.iteration)
    for f in ("obs_mean", "obs_var", "obs_count"):
        _close(getattr(pstate, f), getattr(jstate, f))


def _compare_critic_last_epoch(jstart, jend, tmp_path, epoch):
    """The critic's last epoch of a train step from ``jstart``, held as
    tightly as the actor: the port's train step runs as in the tests, but
    once its critic has taken ``epoch - 1`` steps, the critic and its Adam
    state are overwritten with JAX's after as many epochs (JAX's train step
    with ``epoch - 1`` epochs from ``jstart``: the same rollout, the same
    first epochs). The port's last epoch must then land on ``jend``, JAX's
    state after all ``epoch`` epochs."""
    jtrainer = JP.BatchedPpo(JaxToyEnv(), JP.PpoConfig(**dict(CFG, epoch=epoch - 1)), seed=3)
    jprev, _ = jax.jit(jtrainer.train_step_fn())(jstart)
    prev = str(tmp_path / "prev")
    JP.save_train_state(prev, jprev)
    trainer = PP.BatchedPpo(TorchToyEnv(), PP.PpoConfig(**dict(CFG, epoch=epoch)))
    own_step, steps = trainer.critic_step, []

    def critic_step(state, *a):
        loss = own_step(state, *a)
        steps.append(loss)
        if len(steps) == epoch - 1:
            load_component(prev, "train_critic_params", state.critic)
            load_adam(state.critic_opt, state.critic, load_component(
                prev, "train_critic_opt_state", adam_tree(state.critic_opt, state.critic)))
            _compare_net(state.critic, state.critic_opt, jprev.critic_params,
                         jprev.critic_opt_state)
        return loss

    trainer.critic_step = critic_step
    pstate = _port_state(jstart, tmp_path, "start")
    pstate, _ = trainer.train_step_fn()(pstate, _uniforms(jstart))
    assert len(steps) == epoch
    _compare_net(pstate.critic, pstate.critic_opt, jend.critic_params, jend.critic_opt_state)


def _compare_metrics(pm, jm):
    for f in JP.PpoMetrics._fields:
        _close(getattr(pm, f), getattr(jm, f))


def _jax_run(epoch):
    """JAX: init, one rollout (its trajectory), and two train steps."""
    trainer = JP.BatchedPpo(JaxToyEnv(), JP.PpoConfig(**dict(CFG, epoch=epoch)), seed=3)
    s0 = trainer.init()
    _, traj = jax.jit(trainer.rollout_fn())(s0)
    step = jax.jit(trainer.train_step_fn())
    s1, m1 = step(s0)
    s2, m2 = step(s1)
    return s0, traj, (s1, m1), (s2, m2)


@pytest.fixture(scope="module")
def jax_run():
    return _jax_run(CFG["epoch"])


def test_rollout_matches_jax(jax_run, tmp_path):
    s0, jtraj, _, _ = jax_run
    pstate = _port_state(s0, tmp_path, "s0")
    pstate, ptraj = PP.BatchedPpo(TorchToyEnv(), PP.PpoConfig(**CFG)).rollout_fn()(
        pstate, _uniforms(s0))
    for i, f in enumerate(PP.Trajectory._fields):
        ref = np.asarray(jtraj[i])
        got = getattr(ptraj, f)
        if ref.dtype == bool or ref.dtype.kind == "i":
            np.testing.assert_array_equal(got.numpy(), ref, err_msg=f)
        else:
            _close(got, ref)
    # the toy env exercised every branch: settle frames, fails and wins
    valid, done, win = (np.asarray(jtraj[i]) for i in (6, 5, 8))
    assert (~valid).any() and (done & ~win).any() and win.any()


@pytest.mark.parametrize("epoch", [1, 2])
def test_train_step_matches_jax(jax_run, epoch, tmp_path):
    s0, _, (s1, m1), _ = jax_run if epoch == CFG["epoch"] else _jax_run(epoch)
    cfg = dict(CFG, epoch=epoch)
    pstate = _port_state(s0, tmp_path, "s0")
    pstate, pm = PP.BatchedPpo(TorchToyEnv(), PP.PpoConfig(**cfg)).train_step_fn()(
        pstate, _uniforms(s0))
    _compare_metrics(pm, m1)
    _compare_after_update(pstate, s1, s0, epoch)
    if epoch > 1:
        _compare_critic_last_epoch(s0, s1, tmp_path, epoch)
    assert pstate.iteration == 1
    assert float(pstate.obs_count) > 0.5  # the stats were folded in after the update


def test_jax_saved_state_resumes_in_port(jax_run, tmp_path):
    """A second step from the JAX state after the first, saved by JAX: the
    obs stats are now in use, the sigma scale and the entropy factor have
    moved on, and Adam takes its third and fourth steps."""
    _, _, (s1, _), (s2, m2) = jax_run
    pstate = _port_state(s1, tmp_path, "s1")
    assert pstate.iteration == 1 and float(pstate.obs_count) > 0.5
    pstate, pm = PP.BatchedPpo(TorchToyEnv(), PP.PpoConfig(**CFG)).train_step_fn()(
        pstate, _uniforms(s1))
    _compare_metrics(pm, m2)
    _compare_after_update(pstate, s2, s1, CFG["epoch"])
    _compare_critic_last_epoch(s1, s2, tmp_path, CFG["epoch"])


def test_port_state_saves_and_resumes(tmp_path):
    """The port's own checkpoint round trip: a state saved after one step
    and loaded into a fresh one takes the same second step, generator
    draws included."""
    cfg = PP.PpoConfig(**CFG)
    trainer = PP.BatchedPpo(TorchToyEnv(), cfg, seed=5)
    step = trainer.train_step_fn()
    a, _ = step(trainer.init())
    PP.save_train_state(str(tmp_path), a)
    b = PP.load_train_state(str(tmp_path), PP.BatchedPpo(TorchToyEnv(), cfg, seed=6).init())
    a, ma = step(a)
    b, mb = step(b)
    assert all(torch.equal(x, y) for x, y in zip(ma, mb))
    assert all(torch.equal(p, q) for p, q in zip(a.actor.parameters(), b.actor.parameters()))


def test_gae_and_normalize_matches_jax():
    rng = np.random.default_rng(1)
    t, n = 9, 5
    values = rng.standard_normal((t, n, 1)).astype(np.float32)
    rewards = rng.standard_normal((t, n)).astype(np.float32)
    dones = rng.uniform(size=(t, n)) < 0.2
    valids = rng.uniform(size=(t, n)) > 0.25
    boot = rng.standard_normal((n, 1)).astype(np.float32)
    cfg = dict(gamma=0.97, lam=0.9)
    ref = JP.gae_and_normalize(JP.PpoConfig(**cfg), values, rewards, dones, valids, boot)
    got = PP.gae_and_normalize(PP.PpoConfig(**cfg), *map(torch.as_tensor, (
        values, rewards, dones, valids, boot)))
    for g, r in zip(got, ref):
        _close(g, r)
    assert dones.any() and (~valids).any()


def test_obs_stats_merge_matches_jax():
    rng = np.random.default_rng(2)
    obs = rng.standard_normal((6, 5, S)).astype(np.float32) * 3 + 1
    maskf = (rng.uniform(size=(6, 5, 1)) > 0.3).astype(np.float32)
    mean = rng.standard_normal(S).astype(np.float32)
    var = rng.uniform(0.5, 2, S).astype(np.float32)
    js = JP.PpoTrainState(*([None] * 9), obs_mean=jnp.asarray(mean), obs_var=jnp.asarray(var),
                          obs_count=jnp.float32(40.0))
    ref = JP._update_obs_stats(js, obs, maskf)
    ps = types.SimpleNamespace(obs_mean=torch.as_tensor(mean), obs_var=torch.as_tensor(var),
                               obs_count=torch.tensor(40.0))
    PP._update_obs_stats(ps, torch.as_tensor(obs), torch.as_tensor(maskf))
    for f in ("obs_mean", "obs_var", "obs_count"):
        _close(getattr(ps, f), getattr(ref, f))
    # the normalizer: identity until frames are folded in
    fresh = types.SimpleNamespace(obs_mean=torch.zeros(S), obs_var=torch.ones(S),
                                  obs_count=torch.tensor(0.0))
    x = torch.as_tensor(obs[0])
    assert torch.equal(PP.normalize_obs(fresh, x), x)
    _close(PP.normalize_obs(ps, x), JP.normalize_obs(ref, obs[0]))


def test_clip_by_global_norm_is_optax_rule():
    import optax

    rng = np.random.default_rng(3)
    for scale in (0.01, 10.0):  # below and above the max norm
        g = [rng.standard_normal(s).astype(np.float32) * scale for s in ((3, 4), (4,))]
        params = [torch.nn.Parameter(torch.zeros(x.shape)) for x in g]
        for p, x in zip(params, g):
            p.grad = torch.as_tensor(x).clone()
        PP.clip_by_global_norm_(params, 0.5)
        ref, _ = optax.clip_by_global_norm(0.5).update(g, optax.EmptyState())
        for p, r in zip(params, ref):
            _close(p.grad, r, 1e-6)


def test_step_timer_and_trace_around_a_train_step(tmp_path):
    """The driver's EVOMOTION_PROFILE timers (the trainer's rollout and
    update phases inside a timed iteration) and its EVOMOTION_TRACE_DIR
    trace, on the CPU."""
    import json

    from evomotion_tpu_torch.train.profiling import StepTimer, span, trace

    timer = StepTimer()
    trainer = PP.BatchedPpo(TorchToyEnv(), PP.PpoConfig(**CFG), seed=1)
    step = trainer.train_step_fn(timer)
    state = trainer.init()
    for _ in range(2):
        with timer.phase("train_iter", block_on=torch.device("cpu")):
            state, _ = step(state)
    assert dict(timer.counts) == {"rollout": 2, "update": 2, "train_iter": 2}
    assert timer.totals["train_iter"] >= timer.totals["rollout"] + timer.totals["update"]
    assert timer.rate("train_iter", T * N) > 0 and timer.rate("missing", 1) == 0.0
    assert timer.summary().startswith("rollout: ")
    with trace(str(tmp_path)):
        with span("one step"):
            step(state)
    with open(tmp_path / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "one step" in names

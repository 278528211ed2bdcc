"""Checkpoints across the two packages, and the committed walker in the port.

A directory written by either package loads in the other (the JAX key
scheme: ``h1/lin/w``, ``1/0/count``, ``''`` for a single leaf) with arrays
equal at atol 0; the committed walker's actor gives the same (mu, sigma) in
both at 1e-5; the port's own copy of the walker's files is byte-equal to
``runs/walk_r5e_s42/save_final/``; the committed full train state loads
into the port's ``PpoTrainState``.
"""

import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from evomotion_tpu.networks import modules as JM
from evomotion_tpu.train import checkpoint as JC
from evomotion_tpu_torch import convert
from evomotion_tpu_torch.envs.robot import RobotEnvState, RobotWalk, RobotWalkParams
from evomotion_tpu_torch.networks.modules import Actor, Critic
from evomotion_tpu_torch.physics.engine import init_state
from evomotion_tpu_torch.tools.eval_walk import WALKER_DIR
from evomotion_tpu_torch.train import checkpoint as PC
from evomotion_tpu_torch.train.ppo_batched import PpoTrainState, load_train_state

ROOT = os.path.join(os.path.dirname(__file__), "..")
SAVE_FINAL = os.path.join(ROOT, "runs", "walk_r5e_s42", "save_final")
WALKER_FILES = ["train_actor_params.npz", "train_obs_mean.npz", "train_obs_var.npz",
                "train_obs_count.npz", "meta.json"]
S, A, H = 371, 12, 256


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    np.testing.assert_array_equal(a, b)


def _jax_opt():
    return optax.chain(optax.clip_by_global_norm(0.5), optax.adam(1e-3))


def _torch_adam_steps(actor, n):
    """``n`` Adam steps of the port's actor on a fixed loss."""
    opt = torch.optim.Adam(actor.parameters(), lr=1e-3)
    x = torch.as_tensor(np.random.default_rng(0).standard_normal((5, 6)).astype(np.float32))
    for _ in range(n):
        opt.zero_grad()
        mu, sigma = actor(x)
        (mu.square().sum() + sigma.sum()).backward()
        opt.step()
    return opt


def test_jax_save_loads_in_port(tmp_path):
    """JAX params, an optax chain state after two updates and scalar leaves
    (int32, float32), saved by the JAX package, load into the port."""
    jp = JM.actor_init(jax.random.PRNGKey(0), 6, 2, 16)
    opt = _jax_opt()
    st = opt.init(jp)
    for i in range(2):
        grads = jax.tree.map(lambda x: jnp.full_like(x, 0.1 * (i + 1)) * jnp.sign(x), jp)
        upd, st = opt.update(grads, st, jp)
        jp = optax.apply_updates(jp, upd)
    d = str(tmp_path)
    JC.save_component(d, "actor", jp)
    JC.save_component(d, "actor_optimizer", st)
    JC.save_component(d, "iteration", jnp.int32(7))
    JC.save_component(d, "obs_count", jnp.float32(2.5))

    actor = PC.load_component(d, "actor", Actor(6, 2, 16))
    jax.tree.map(_equal, convert.params_tree(actor), jax.tree.map(np.asarray, jp))
    adam = torch.optim.Adam(actor.parameters(), lr=1e-3)
    convert.load_adam(adam, actor, PC.load_component(d, "actor_optimizer",
                                                     convert.adam_tree(adam, actor)))
    for name, p in actor.named_parameters():
        jmu, jnu = st[1][0].mu, st[1][0].nu
        for k in name.split("."):
            jmu, jnu = jmu[k], jnu[k]
        _equal(adam.state[p]["exp_avg"].numpy(), jmu)
        _equal(adam.state[p]["exp_avg_sq"].numpy(), jnu)
        assert float(adam.state[p]["step"]) == 2.0
    assert PC.load_component(d, "iteration", 0) == 7
    c = PC.load_component(d, "obs_count", torch.zeros(()))
    assert c.dtype == torch.float32 and float(c) == 2.5
    # the same keys on disk: the JAX file's, read raw
    with np.load(os.path.join(d, "actor_optimizer.npz")) as f:
        assert "1/0/count" in f and "1/0/mu/h1/lin/w" in f and "1/0/nu/sigma/b" in f


def test_port_save_loads_in_jax(tmp_path):
    actor = Actor(6, 2, 16, torch.Generator().manual_seed(1))
    adam = _torch_adam_steps(actor, 3)
    d = str(tmp_path)
    PC.save_component(d, "actor", actor)
    PC.save_component(d, "actor_optimizer", convert.adam_tree(adam, actor))
    PC.save_component(d, "iteration", np.int32(3))
    PC.save_component(d, "obs_count", torch.tensor(4.0))
    PC.save_component(d, "fresh_optimizer", convert.adam_tree(
        torch.optim.Adam(actor.parameters()), actor))

    like = JM.actor_init(jax.random.PRNGKey(9), 6, 2, 16)
    jp = JC.load_component(d, "actor", like)
    jax.tree.map(_equal, jax.tree.map(np.asarray, jp), convert.params_tree(actor))
    st = JC.load_component(d, "actor_optimizer", _jax_opt().init(like))
    assert int(st[1][0].count) == 3 and st[1][0].count.dtype == jnp.int32
    for name, p in actor.named_parameters():
        jmu, jnu = st[1][0].mu, st[1][0].nu
        for k in name.split("."):
            jmu, jnu = jmu[k], jnu[k]
        _equal(jmu, adam.state[p]["exp_avg"].numpy())
        _equal(jnu, adam.state[p]["exp_avg_sq"].numpy())
    # before any step: count 0 and zero moments, as optax's init
    fresh = JC.load_component(d, "fresh_optimizer", _jax_opt().init(like))
    jax.tree.map(_equal, jax.tree.map(np.asarray, fresh),
                 jax.tree.map(np.asarray, _jax_opt().init(like)))
    assert int(JC.load_component(d, "iteration", jnp.int32(0))) == 3
    assert float(JC.load_component(d, "obs_count", jnp.float32(0))) == 4.0


def test_walker_copy_is_byte_equal():
    for name in WALKER_FILES:
        assert filecmp.cmp(os.path.join(WALKER_DIR, name), os.path.join(SAVE_FINAL, name),
                           shallow=False), name


def test_committed_walker_actor_matches_jax():
    template = JM.actor_init(jax.random.PRNGKey(0), S, A, H)
    jp = JC.load_component(SAVE_FINAL, "train_actor_params", template)
    actor = PC.load_component(WALKER_DIR, "train_actor_params", Actor(S, A, H))
    obs = np.random.default_rng(64).standard_normal((64, S)).astype(np.float32)
    jmu, jsigma = JM.actor_apply(jp, obs)
    with torch.no_grad():
        mu, sigma = actor(torch.as_tensor(obs))
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(sigma.numpy(), np.asarray(jsigma), rtol=1e-5, atol=1e-5)


def _like_state(n_envs):
    """A port train state of the committed run's shapes (2048 envs, hidden
    256), zeros where the reset would go: only shapes and dtypes matter."""
    env = RobotWalk(RobotWalkParams(), device="cpu")
    m, nm = env.model.n_slider, len(env.meta.member_bodies)
    z = torch.zeros
    env_state = RobotEnvState(
        physics=init_state(env.model, n_envs, "cpu"),
        reset_idx=z(n_envs, dtype=torch.int32), curr_step=z(n_envs, dtype=torch.int32),
        remaining_steps=z(n_envs, dtype=torch.int32), last_lin_vel=z(n_envs, nm, 3),
        last_ang_vel=z(n_envs, nm, 3), touch_taken=z(n_envs, dtype=torch.bool),
        motor_target=z(n_envs, m), motors_on=z(n_envs, dtype=torch.bool),
        settle_left=z(n_envs, dtype=torch.int32), diag_slider_pos=z(n_envs, m),
        diag_slider_imp=z(n_envs, m), diag_p2p_imp=z(n_envs, 2 * m))
    actor, critic = Actor(S, A, H), Critic(S, H)
    return PpoTrainState(
        actor=actor, critic=critic,
        actor_opt=torch.optim.Adam(actor.parameters(), lr=1e-3),
        critic_opt=torch.optim.Adam(critic.parameters(), lr=1e-3),
        env_state=env_state, obs=z(n_envs, S), generator=torch.Generator(),
        iteration=0, ep_steps=z(n_envs, dtype=torch.int32), obs_mean=z(S), obs_var=z(S),
        obs_count=z(()))


def test_committed_train_state_loads_into_port():
    st = load_train_state(SAVE_FINAL, _like_state(2048))

    def raw(name, key=""):
        with np.load(os.path.join(SAVE_FINAL, f"train_{name}.npz")) as f:
            return f[key]

    assert st.iteration == int(raw("iteration")) == 300
    for name, module in (("actor", st.actor), ("critic", st.critic)):
        for pname, p in module.named_parameters():
            _equal(p.detach().numpy(), raw(f"{name}_params", pname.replace(".", "/")))
        opt = st.actor_opt if name == "actor" else st.critic_opt
        for pname, p in module.named_parameters():
            key = pname.replace(".", "/")
            assert float(opt.state[p]["step"]) == int(raw(f"{name}_opt_state", "1/0/count"))
            _equal(opt.state[p]["exp_avg"].numpy(), raw(f"{name}_opt_state", f"1/0/mu/{key}"))
            _equal(opt.state[p]["exp_avg_sq"].numpy(),
                   raw(f"{name}_opt_state", f"1/0/nu/{key}"))
    for name in ("obs_mean", "obs_var", "obs_count", "obs", "ep_steps"):
        _equal(getattr(st, name).numpy(), raw(name))
    assert float(st.obs_count) > 0.5
    _equal(st.env_state.physics.pos.numpy(), raw("env_state", "physics/pos"))
    _equal(st.env_state.settle_left.numpy(), raw("env_state", "settle_left"))
    # the JAX PRNG key seeds the generator: (key[0] << 32) | key[1]
    k = raw("key")
    want = torch.Generator().manual_seed((int(k[0]) << 32) | int(k[1]))
    assert torch.equal(torch.rand(4, generator=st.generator), torch.rand(4, generator=want))

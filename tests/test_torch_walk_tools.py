"""The walker's tools and the CLI's batched ``train`` on the CPU, small.

``tools.eval_walk`` (the ``ppo`` tier on the port's copy of the committed
walker, the ``crossq`` tier on a tiny actor saved by the JAX package),
``tools.train_walk`` for two iterations (its outputs laid out as the JAX
tool's) and ``cli robot_walk ppo_gae --num_envs 2 ... train``, whose
``save_0`` loads in both packages. In the manner of ``test_torch_tools.py``
they run at B=2 with one solver iteration and ``reset_frames=1``, and
with a 3-step eval horizon in place of the 1800-step win horizon
(``tools.rehearsal.small_walker``); on the card ``chip_smoke.py`` runs
them at full size. The greedy policies agree with the JAX tool's at 1e-5.
"""

import csv
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from evomotion_tpu.networks import modules as JM
from evomotion_tpu.train import checkpoint as JC
from evomotion_tpu_torch import cli
from evomotion_tpu_torch.networks.modules import Actor
from evomotion_tpu_torch.tools import eval_walk, train_walk
from evomotion_tpu_torch.tools.rehearsal import small_walker
from evomotion_tpu_torch.train.checkpoint import load_component

ROOT = os.path.join(os.path.dirname(__file__), "..")
S, A = 371, 12
HORIZON = 3


@pytest.fixture
def small():
    """Every robot_walk env the tools make: reset_frames 1, one solver
    iteration; eval horizons of 3 steps."""
    with small_walker(HORIZON):
        yield


def _eval_json(capsys):
    out = capsys.readouterr().out.splitlines()
    res = json.loads(out[-1])
    assert out[-7] == f"greedy eval over {res['envs']} envs (win horizon {HORIZON} steps):"
    assert 0 <= res["mean_len"] <= HORIZON and res["max_len"] <= HORIZON
    assert res["wins"] == 0 and res["win_rate"] == 0.0  # no episode reaches the win horizon
    assert np.isfinite(res["mean_return"]) and res["ms_per_step"] > 0
    assert res["device"] == "cpu"
    return out, res


def _jax_greedy(params, obs, mean=None, var=None):
    x = obs if mean is None else (obs - mean) * jax.lax.rsqrt(var + 1e-8)
    return np.asarray(jnp.clip(JM.actor_apply(params, x)[0], -1.0, 1.0))


def test_eval_walk_ppo_on_the_walker_copy(small, capsys):
    assert eval_walk.main(["ppo", eval_walk.WALKER_DIR, "--episodes", "2"], device="cpu") == 0
    out, res = _eval_json(capsys)
    assert out[0] == "row_order: canonical -> scheduled (checkpoint meta.json)"
    assert res["row_order"] == "scheduled" and res["envs"] == 2 and res["tier"] == "ppo"
    # the tool's policy is the JAX tool's: normalized obs, clipped mu
    policy = eval_walk.load_policy("ppo", eval_walk.WALKER_DIR, S, A, 256, "cpu")
    assert policy.use_norm
    template = JM.actor_init(jax.random.PRNGKey(0), S, A, 256)
    jp = JC.load_component(eval_walk.WALKER_DIR, "train_actor_params", template)
    mean, var = (JC.load_component(eval_walk.WALKER_DIR, f"train_obs_{k}", jnp.zeros(S))
                 for k in ("mean", "var"))
    obs = np.random.default_rng(0).standard_normal((16, S)).astype(np.float32)
    np.testing.assert_allclose(policy(torch.as_tensor(obs)).numpy(),
                               _jax_greedy(jp, obs, mean, var), rtol=1e-5, atol=1e-5)


def test_greedy_policy_default_stats_follow_the_actor():
    """A policy made from an actor alone (the smoke eval of a freshly
    trained actor) keeps its identity stats on the actor's device."""
    policy = eval_walk.GreedyPolicy(Actor(S, A, 16).to("meta"))
    assert {b.device.type for b in policy.buffers()} == {"meta"}


def test_eval_walk_crossq_on_a_jax_saved_actor(small, capsys, tmp_path):
    jp = JM.actor_init(jax.random.PRNGKey(1), S, A, 16)
    JC.save_component(str(tmp_path), "actor", jp)
    assert eval_walk.main(["crossq", str(tmp_path), "--hidden", "16", "--episodes", "2",
                           "--row-order", "canonical"], device="cpu") == 0
    _, res = _eval_json(capsys)
    assert res["tier"] == "crossq" and res["row_order"] == "canonical"
    policy = eval_walk.load_policy("crossq", str(tmp_path), S, A, 16, "cpu")
    assert not policy.use_norm
    obs = np.random.default_rng(1).standard_normal((8, S)).astype(np.float32)
    np.testing.assert_allclose(policy(torch.as_tensor(obs)).numpy(), _jax_greedy(jp, obs),
                               rtol=1e-5, atol=1e-5)
    # --out: the best episode re-run on one world (the per-env step), recorded
    best = str(tmp_path / "best")
    assert eval_walk.main(["crossq", str(tmp_path), "--hidden", "16", "--episodes", "2",
                           "--row-order", "canonical", "--out", best], device="cpu") == 0
    m = re.search(r"recorded (\d+) frames \(done=(\w+), win=(\w+)\) -> ",
                  capsys.readouterr().out)
    assert m and 1 <= int(m.group(1)) <= eval_walk.WIN
    with np.load(best + ".npz") as rec:
        assert rec["pos"].shape == (int(m.group(1)), 42, 3)
        assert rec["quat"].shape == (int(m.group(1)), 42, 4)
    assert open(best + ".html").read().startswith("<!DOCTYPE html>")


def _jax_tool_source():
    with open(os.path.join(ROOT, "tools", "train_walk.py")) as f:
        return f.read()


def test_train_walk_two_iterations_then_resume(small, capsys, tmp_path):
    out = str(tmp_path / "run")
    base = ["--n-envs", "2", "--horizon", "2", "--epoch", "1", "--hidden", "16",
            "--eval-every", "1", "--save-every", "1", "--eval-envs", "2", "--obs-norm", "1",
            "--survival-bonus", "0.02"]
    assert train_walk.main([out, "--iters", "2", "--order-cycle", "scheduled,canonical",
                            *base], device="cpu") == 0
    printed = capsys.readouterr().out.splitlines()
    assert printed[-1] == "DONE" and printed[0].startswith("it 1 steps 4.00e+00 r/step ")
    src = _jax_tool_source()
    # the JAX tool's arguments, curve columns and meta.json keys
    args = {a.lstrip("-").replace("-", "_") for a in re.findall(r'add_argument\("([^"]+)"', src)}
    with open(os.path.join(out, "config.json")) as f:
        config = json.load(f)
    assert set(config) == args | {"win_steps", "env", "row_orders", "eval_order",
                                  "eval_order_alt", "row_dtype", "tier"}
    assert config["row_orders"] == ["scheduled", "canonical"] and config["win_steps"] == 3
    header = re.search(r'w\.writerow\(\[\s*("iter".*?)\]\)', src, re.S).group(1)
    with open(os.path.join(out, "curve.csv")) as f:
        rows = list(csv.reader(f))
    assert rows[0] == re.findall(r'"(\w+)"', header) == train_walk.CURVE_COLUMNS
    assert len(rows) == 2 and rows[1][0] == "1" and rows[1][1] == "4"
    assert all(np.isfinite(float(x)) for x in rows[1][3:])
    with open(os.path.join(out, "save_final", "meta.json")) as f:
        meta = json.load(f)
    assert set(meta) == {"row_orders", "eval_order", "eval_order_alt", "row_dtype",
                         "greedy_win", "iter", "seed"}
    assert meta["iter"] == 1 and set(meta["greedy_win"]) == {"eval_order", "alt"}
    names = {f"train_{k}.npz" for k in ("actor_params", "critic_params", "actor_opt_state",
                                        "critic_opt_state", "env_state", "obs", "generator",
                                        "iteration", "ep_steps", "obs_mean", "obs_var",
                                        "obs_count")}
    for d in ("save_1", "save_2", "save_final"):
        assert names <= set(os.listdir(os.path.join(out, d))), d
    # the saved actor loads in the JAX package too
    jp = JC.load_component(os.path.join(out, "save_2"), "train_actor_params",
                           JM.actor_init(jax.random.PRNGKey(0), S, A, 16))
    assert all(np.isfinite(np.asarray(x)).all() for x in jax.tree.leaves(jp))

    out2 = str(tmp_path / "resumed")
    assert train_walk.main([out2, "--iters", "1", "--resume", os.path.join(out, "save_2"),
                            *base], device="cpu") == 0
    assert capsys.readouterr().out.splitlines()[0] == (
        f"resumed from {os.path.join(out, 'save_2')} at iteration 2")
    with np.load(os.path.join(out2, "save_1", "train_iteration.npz")) as f:
        assert int(f[""]) == 3


def test_cli_train_num_envs_saves_loadable_components(small, capsys, tmp_path):
    out = str(tmp_path)
    rc = cli.main(["cli", "robot_walk", "ppo_gae", "--num_envs", "2", "--agent_parameters",
                   "hidden_size=16", "horizon=2", "epoch=1", "--env_parameters",
                   "reset_frames=1", "train", out, "-e", "2", "-n", "1"], device="cpu")
    assert rc == 0
    text = capsys.readouterr().out
    m = re.findall(r"save 0 actor=(\S+) critic=(\S+) r/step=(\S+) ([\d,]+) env-steps/s "
                   r"\[(\d)/2\]", text)
    assert [x[-1] for x in m] == ["1", "2"] and all(np.isfinite(float(x[0])) for x in m)
    save = os.path.join(out, "save_0")
    assert sorted(os.listdir(save)) == ["actor.npz", "actor_optimizer.npz", "critic.npz",
                                        "critic_optimizer.npz"]
    actor = load_component(save, "actor", Actor(S, A, 16))
    like = JM.actor_init(jax.random.PRNGKey(0), S, A, 16)
    jp = JC.load_component(save, "actor", like)
    for name, p in actor.named_parameters():
        ref = jp
        for k in name.split("."):
            ref = ref[k]
        np.testing.assert_array_equal(p.detach().numpy(), np.asarray(ref))
    opt = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(1e-3))
    st = JC.load_component(save, "critic_optimizer",
                           opt.init(JM.critic_init(jax.random.PRNGKey(0), S, 16)))
    assert int(st[1][0].count) == 2  # one epoch per iteration, two iterations


def test_cli_batched_ppo_save_runs_on_the_sequential_agent(small, capsys, tmp_path):
    """A ``save_0`` of ``train --num_envs 2`` (batched PPO-GAE) loads into the
    sequential ``ppo_gae`` agent: ``run`` of it on one world (per-env step,
    a 3-step bank) prints its episode with the trained actor's weights."""
    out = str(tmp_path)
    assert cli.main(["cli", "robot_walk", "ppo_gae", "--num_envs", "2", "--agent_parameters",
                     "hidden_size=16", "horizon=2", "epoch=1", "train", out, "-e", "1", "-n",
                     "1"], device="cpu") == 0
    capsys.readouterr()
    loaded = []
    from evomotion_tpu_torch.agents.ppo_gae import PpoGaeAgent

    own = PpoGaeAgent.load

    def load(self, folder):
        own(self, folder)
        loaded.append(self)

    PpoGaeAgent.load = load
    try:
        rc = cli.main(["cli", "robot_walk", "ppo_gae", "--agent_parameters", "seed=3",
                       "hidden_size=16", "gamma=0.99", "lambda=0.95", "epsilon=0.2",
                       "entropy_factor=0.01", "critic_loss_factor=0.5", "epoch=1",
                       "batch_size=2", "train_every=1", "replay_buffer_size=4",
                       "learning_rate=1e-3", "clip_grad_norm=0.5", "--env_parameters",
                       "initial_remaining_seconds=0.05", "run", os.path.join(out, "save_0")],
                      device="cpu")
    finally:
        PpoGaeAgent.load = own
    assert rc == 0
    assert re.match(r"^episode 0: \d+ steps, return \S+$", capsys.readouterr().out.splitlines()[-1])
    actor = load_component(os.path.join(out, "save_0"), "actor", Actor(S, A, 16))
    for a, b in zip(loaded[0].actor.parameters(), actor.parameters()):
        assert torch.equal(a, b)


LIQUID_BATCHED = [("robot_walk", "soft_actor_critic_liquid"), ("robot_walk", "ppo_gae_liquid"),
                  ("cartpole", "ppo_gae_liquid"), ("cartpole", "soft_actor_critic_liquid")]


@pytest.mark.parametrize("env,agent", LIQUID_BATCHED,
                         ids=[f"{e}-{a}" for e, a in LIQUID_BATCHED])
def test_cli_train_liquid_batched(small, env, agent, capsys, tmp_path):
    """``cli <env> <liquid agent> --num_envs 2 ... train`` (two iterations
    of two steps; 8 neurons, 2 unfoldings): finite progress lines, and a
    ``save_0`` of the JAX trainer's components that the JAX agent loads
    equal. A liquid PPO save then runs on the sequential ``ppo_gae_liquid``
    (cartpole: one episode)."""
    from evomotion_tpu.agents import liquid_agents as JLA
    from evomotion_tpu.train.checkpoint import _flatten as jflatten
    from evomotion_tpu_torch.agents import liquid_agents as PLA
    from evomotion_tpu_torch.train.checkpoint import _flatten

    out = str(tmp_path)
    kv = ["neuron_number=8", "unfolding_steps=2", "horizon=2", "epoch=1", "batch_size=4",
          "replay_buffer_size=16"]
    rc = cli.main(["cli", env, agent, "--num_envs", "2", "--agent_parameters", *kv,
                   "--env_parameters", "reset_frames=1" if env == "robot_walk" else
                   "reset_frame_nb=2", "train", out, "-e", "2", "-n", "1"], device="cpu")
    assert rc == 0
    m = re.findall(r"save 0 actor=(\S+) critic=(\S+) r/step=(\S+) ([\d,]+) env-steps/s "
                   r"\[(\d)/2\]", capsys.readouterr().out)
    assert [x[-1] for x in m] == ["1", "2"] and all(np.isfinite(float(x[1])) for x in m)
    save = os.path.join(out, "save_0")
    s, a = (S, A) if env == "robot_walk" else (7, 1)
    if agent == "soft_actor_critic_liquid":
        port = PLA.SoftActorCriticLiquidAgent(0, s, a, 8, 4, 1, 3e-4, 0.99, 0.005, 2, 1, 1,
                                              device="cpu")
        j = JLA.SoftActorCriticLiquidAgent(0, s, a, 8, 4, 1, 3e-4, 0.99, 0.005, 2, 1, 1)
        count = "0/count"
    else:
        args = (0, s, a, 8, 2, 0.99, 0.95, 0.2, 0.01, 0.5, 1, 2, 1, 4, 1e-3, 0.5)
        port, j = PLA.PpoGaeLiquidAgent(*args, device="cpu"), JLA.PpoGaeLiquidAgent(*args)
        count = "1/0/count"
    assert sorted(os.listdir(save)) == sorted(f"{c}.npz" for c in port.SAVE)
    port.load(save)
    j.load(save)
    jcarry = j._carry() if hasattr(j, "_carry") else (
        j.actor_params, j.actor_opt_state, j.critic_params, j.critic_opt_state)
    ref, got = _flatten(port.carry_tree()), jflatten(jcarry)
    assert ref.keys() == got.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    with np.load(os.path.join(save, "actor_optimizer.npz")) as f:
        # SAC: an update per step once the ring holds a batch (the second
        # iteration's two); PPO: one epoch per iteration
        assert int(f[count]) == 2
    if agent == "ppo_gae_liquid" and env == "cartpole":
        seq = ["cli", "cartpole", agent, "--agent_parameters", "seed=3", "neuron_number=8",
               "unfolding_steps=2", "gamma=0.99", "lambda=0.95", "epsilon=0.2",
               "entropy_factor=0.01", "critic_loss_factor=0.5", "epoch=1", "batch_size=2",
               "train_every=1", "replay_buffer_size=4", "learning_rate=1e-3",
               "clip_grad_norm=0.5", "run", save]
        assert cli.main(seq, device="cpu") == 0
        assert re.match(r"^episode 0: \d+ steps, return \S+$",
                        capsys.readouterr().out.splitlines()[-1])

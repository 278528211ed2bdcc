"""The port's CLI and inference driver on the CPU.

``cli.main([... "run", ...], device="cpu")`` runs the sequential tier (one
world, the per-env physics step, the fat-row sweep's plain version) and
prints one line per episode; its step counts and returns equal a hand loop
over the port's env. The parser surface and the strict agent parameters
follow the JAX package's CLI.
"""

import math
import re

import numpy as np
import pytest
import torch

from evomotion_tpu_torch import cli
from evomotion_tpu_torch.envs.cartpole import CartPoleFactory

LINE = re.compile(r"^episode (\d+): (\d+) steps, return (-?[\d.]+)$")


def _hand_loop(env, episodes, value):
    """What ``run`` with a constant agent computes, written out."""
    out = []
    for _ in range(episodes):
        state, res = env.reset(1)
        total, steps = 0.0, 0
        while True:
            state, res = env.step(state, torch.full((1, 1), value))
            while not bool(res.valid[0]):
                state, res = env.step(state, torch.zeros((1, 1)))
            total += float(res.reward[0])
            steps += 1
            if bool(res.done[0]):
                break
        out.append((steps, round(total, 3)))
    return out


def test_run_cartpole_constant_matches_hand_loop(tmp_path, capsys):
    rc = cli.main(["cli", "cartpole", "constant", "--agent_parameters", "action_value=0.3",
                   "run", str(tmp_path), "--episodes", "2"], device="cpu")
    assert rc == 0
    lines = [m.groups() for m in map(LINE.match, capsys.readouterr().out.splitlines()) if m]
    assert [int(i) for i, _, _ in lines] == [0, 1]
    got = [(int(n), float(r)) for _, n, r in lines]
    env = CartPoleFactory({}).make(1234, device="cpu")
    assert got == _hand_loop(env, 2, 0.3)
    assert all(n > 0 for n, _ in got)


def test_run_cartpole3d_random_prints_episodes(tmp_path, capsys):
    rc = cli.main(["cli", "cartpole3d", "random", "--env_seed", "3", "run", str(tmp_path)],
                  device="cpu")
    assert rc == 0
    lines = [LINE.match(x) for x in capsys.readouterr().out.splitlines()]
    assert sum(m is not None for m in lines) == 1


def test_missing_agent_parameter_raises(tmp_path):
    with pytest.raises(ValueError, match="action_value"):
        cli.main(["cli", "cartpole", "constant", "run", str(tmp_path)], device="cpu")


@pytest.mark.parametrize("argv", [
    ["cli", "cartpole", "random", "run", "x", "--record", "t.npz"],
    ["cli", "cartpole", "random", "run", "x", "--live"],
    ["gui"],
], ids=["record", "live", "gui"])
def test_unported_parts_raise(argv):
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        cli.main(argv, device="cpu")


def test_unknown_names_raise():
    with pytest.raises(ValueError):
        cli.main(["cli", "no_such_env", "random", "run", "x"], device="cpu")
    with pytest.raises(ValueError):
        cli.main(["cli", "cartpole", "no_such_agent", "run", "x"], device="cpu")


def test_cli_kv_extraction():
    agent, env, rest = cli._extract_kv_flags(
        ["cli", "cartpole", "ppo_gae", "--agent_parameters", "a=1", "b=2",
         "--env_parameters", "c=3", "train", "/tmp/x", "-e", "4"]
    )
    assert agent == {"a": "1", "b": "2"}
    assert env == {"c": "3"}
    assert rest == ["cli", "cartpole", "ppo_gae", "train", "/tmp/x", "-e", "4"]


def test_env_parameters_reach_the_env(tmp_path, capsys):
    """--env_parameters are parsed by the defaults' types: a 2-step horizon
    ends every episode by the win branch on its third step (step_idx > 2)."""
    cli.main(["cli", "cartpole", "constant", "--agent_parameters", "action_value=0",
              "--env_parameters", "mas_steps=2", "run", str(tmp_path)], device="cpu")
    m = LINE.match(capsys.readouterr().out.splitlines()[-1])
    assert m and int(m.group(2)) == 3


SEQ_PARAMS = {
    "actor_critic": ["hidden_size=8", "batch_size=4", "lr=1e-3", "gamma=0.99",
                     "entropy_start_factor=0.01", "entropy_end_factor=0.001",
                     "entropy_steps=100", "replay_buffer_size=64", "train_every=2"],
    "ppo_vanilla": ["hidden_size=8", "gamma=0.99", "epsilon=0.2", "entropy_factor=0.01",
                    "critic_loss_factor=0.5", "epoch=1", "batch_size=4",
                    "learning_rate=1e-3"],
    "ppo_gae": ["hidden_size=8", "gamma=0.99", "lambda=0.95", "epsilon=0.2",
                "entropy_factor=0.01", "critic_loss_factor=0.5", "epoch=1", "batch_size=2",
                "train_every=2", "replay_buffer_size=8", "learning_rate=1e-3",
                "clip_grad_norm=0.5"],
}


@pytest.mark.parametrize("agent", sorted(SEQ_PARAMS))
def test_cli_train_then_run(agent, tmp_path, capsys):
    """The sequential tier (``--num_envs 1``) as tests/test_cli.py drives the
    JAX CLI: two episodes of training, a save, then ``run`` of the save."""
    base = ["cli", "cartpole", agent, "--agent_parameters", "seed=1", *SEQ_PARAMS[agent],
            "--env_parameters", "mas_steps=30", "reset_frame_nb=2"]
    out = tmp_path / "out"
    assert cli.main(base + ["train", str(out), "-e", "2", "-n", "1"], device="cpu") == 0
    assert sorted(p.name for p in (out / "save_0").iterdir()) == [
        "actor.npz", "actor_optimizer.npz", "critic.npz", "critic_optimizer.npz"]
    meters = re.findall(r"(\w+) = (\S+)", capsys.readouterr().out.replace("\r", "\n"))
    assert meters and all(math.isfinite(float(v)) for _, v in meters)
    assert cli.main(base + ["run", str(out / "save_0"), "--episodes", "1"], device="cpu") == 0
    lines = [m for m in map(LINE.match, capsys.readouterr().out.splitlines()) if m]
    assert len(lines) == 1 and int(lines[0].group(2)) > 0


@pytest.mark.parametrize("agent", ["actor_critic", "ppo_vanilla"])
def test_cli_batched_train_then_sequential_run(agent, tmp_path, capsys):
    """``--num_envs 2 train`` of the step-buffer tier (batched cartpole),
    whose ``save_0`` the sequential agent then runs."""
    out = tmp_path / "out"
    argv = ["cli", "cartpole", agent, "--num_envs", "2", "--agent_parameters",
            "hidden_size=8", "horizon=4", "batch_size=4", "epoch=2", "--env_parameters",
            "reset_frame_nb=2"]
    assert cli.main(argv + ["train", str(out), "-e", "2", "-n", "1"], device="cpu") == 0
    m = re.findall(r"save 0 actor=(\S+) critic=(\S+) r/step=(\S+) ([\d,]+) env-steps/s "
                   r"\[(\d)/2\]", capsys.readouterr().out)
    assert [x[-1] for x in m] == ["1", "2"] and all(math.isfinite(float(x[1])) for x in m)
    with np.load(out / "save_0" / "actor_optimizer.npz") as f:
        # A2C: 4 events per iteration (the ring holds a batch from the first);
        # PPO-vanilla: 2 epochs per iteration
        assert int(f["0/count"]) == {"actor_critic": 8, "ppo_vanilla": 4}[agent]
    run = ["cli", "cartpole", agent, "--agent_parameters", "seed=1",
           *SEQ_PARAMS[agent], "run", str(out / "save_0")]
    assert cli.main(run, device="cpu") == 0
    assert LINE.match(capsys.readouterr().out.splitlines()[-1])


LIQUID_SEQ_PARAMS = {
    "actor_critic_liquid": ["neuron_number=8", "batch_size=4", "lr=1e-3", "gamma=0.99",
                            "entropy_start_factor=0.01", "entropy_end_factor=0.001",
                            "entropy_steps=100", "unfolding_steps=3", "replay_buffer_size=64",
                            "train_every=2"],
    "ppo_gae_liquid": ["neuron_number=8", "unfolding_steps=3", "gamma=0.99", "lambda=0.95",
                       "epsilon=0.2", "entropy_factor=0.01", "critic_loss_factor=0.5",
                       "epoch=1", "batch_size=2", "train_every=2", "replay_buffer_size=8",
                       "learning_rate=1e-3", "clip_grad_norm=0.5"],
    "soft_actor_critic_liquid": ["neuron_number=8", "batch_size=4", "epoch=1",
                                 "learning_rate=1e-3", "gamma=0.99", "tau=0.005",
                                 "unfolding_steps=3", "replay_buffer_size=64", "train_every=1"],
}


def _kv(params):
    return dict(x.split("=", 1) for x in params)


@pytest.mark.parametrize("agent", sorted(LIQUID_SEQ_PARAMS))
def test_cli_liquid_train_then_run(agent, tmp_path, capsys):
    """The liquid agents through the sequential ``train`` (two cartpole
    episodes, a save) then ``run`` of the save, as ``test_cli_train_then_run``;
    ``save_0`` holds the JAX agent's components, which the JAX agent loads
    equal."""
    from evomotion_tpu.agents.factory import get_agent_factory as jax_factory
    from evomotion_tpu.train.checkpoint import _flatten as jflatten
    from evomotion_tpu_torch.agents.factory import get_agent_factory
    from evomotion_tpu_torch.train.checkpoint import _flatten

    params = ["seed=1", *LIQUID_SEQ_PARAMS[agent]]
    base = ["cli", "cartpole", agent, "--agent_parameters", *params, "--env_parameters",
            "mas_steps=30", "reset_frame_nb=2"]
    out = tmp_path / "out"
    assert cli.main(base + ["train", str(out), "-e", "2", "-n", "1"], device="cpu") == 0
    meters = re.findall(r"(\w+) = (\S+)", capsys.readouterr().out.replace("\r", "\n"))
    assert meters and all(math.isfinite(float(v)) for _, v in meters)
    port = get_agent_factory(agent, _kv(params)).create_agent(7, 1, device="cpu")
    assert sorted(p.name for p in (out / "save_0").iterdir()) == sorted(
        f"{c}.npz" for c in port.SAVE)
    port.load(str(out / "save_0"))
    j = jax_factory(agent, _kv(params)).create_agent(7, 1)
    j.load(str(out / "save_0"))
    got = jflatten(j._carry() if hasattr(j, "_carry") else (
        j.actor_params, j.actor_opt_state, j.critic_params, j.critic_opt_state))
    ref = _flatten(port.carry_tree())
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert cli.main(base + ["run", str(out / "save_0"), "--episodes", "1"], device="cpu") == 0
    lines = [m for m in map(LINE.match, capsys.readouterr().out.splitlines()) if m]
    assert len(lines) == 1 and int(lines[0].group(2)) > 0


def test_cli_run_liquid_sac_on_robot_jump(tmp_path, capsys):
    """``run`` of a liquid SAC's components on the spider jump (one world,
    the per-env step; a 1-frame settle and a short bank): one finite episode
    line."""
    from evomotion_tpu_torch.agents.factory import get_agent_factory
    from evomotion_tpu_torch.envs.registry import get_environment_factory

    agent = "soft_actor_critic_liquid"
    params = ["seed=2", *LIQUID_SEQ_PARAMS[agent]]
    env_params = ["reset_seconds=0.02", "initial_seconds=0.05"]
    env = get_environment_factory("robot_jump", _kv(env_params)).make(0, device="cpu")
    saved = get_agent_factory(agent, _kv(params)).create_agent(
        env.observation_size, env.action_size, device="cpu")
    with torch.no_grad():
        saved.actor.cell.b.add_(0.25)  # not the init any agent of this seed draws
    saved.save(str(tmp_path))
    rc = cli.main(["cli", "robot_jump", agent, "--agent_parameters", *params,
                   "--env_parameters", *env_params, "run", str(tmp_path)], device="cpu")
    assert rc == 0
    m = LINE.match(capsys.readouterr().out.splitlines()[-1])
    assert m and int(m.group(2)) > 0 and math.isfinite(float(m.group(3)))

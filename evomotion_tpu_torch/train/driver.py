"""Training and inference drivers (port of ``evomotion_tpu/train/driver.py``).

``train_batched``: the batched trainer behind the CLI's ``train --num_envs
N`` (N > 1): N envs in lockstep on the batched physics step, PPO-GAE
(``ppo_batched``), ``save_<i>/`` checkpoints of the reference's components.
``infer``: src/infer.cpp:19-106: load an agent, then step one env until
done, episode after episode, on a batch of one world stepped by the per-env
physics step.

Not ported yet: the sequential ``train`` (train.cpp, ``--num_envs 1``) and
its learning agents (ROADMAP A8), the other batched trainers (A7) and the
recording hooks (A11).
"""

from __future__ import annotations

import os
import sys
import time

import torch

from ..convert import adam_tree
from ..device import resolve
from .checkpoint import save_component
from .ppo_batched import BatchedPpo, PpoConfig
from .profiling import StepTimer, trace

# batched agents of the JAX package that the port does not train yet
_BATCHED_LATER = ("soft_actor_critic", "cross_q", "soft_actor_critic_liquid", "actor_critic",
                  "ppo_vanilla", "ppo_gae_liquid")


def _progress(prefix: str, i: int, total: int, t0: float) -> None:
    elapsed = time.time() - t0
    eta = elapsed / max(i, 1) * (total - i)
    sys.stdout.write(
        f"\r{prefix} [{i}/{total}] elapsed {elapsed:5.1f}s eta {eta:5.1f}s  "
    )
    sys.stdout.flush()


def train_batched(env_seed, env_factory, agent_params, num_envs, episodes, nb_saves,
                  output_path, agent_name="ppo_gae", device=None):
    """Batched trainer: N envs in lockstep, rollout + update per iteration.

    ``episodes`` is read as train iterations per save (each covers
    horizon * num_envs env steps). Agents: ``ppo_gae`` / ``ppo`` (PPO-GAE,
    ``ppo_batched.py``). Agent parameters and their defaults are the JAX
    package's (``hidden_size`` 256, ``gamma`` 0.99, ``lambda`` 0.95,
    ``epsilon`` 0.2, ``entropy_factor`` 0.01, ``critic_loss_factor`` 0.5,
    ``epoch`` 8, ``learning_rate`` 1e-3, ``clip_grad_norm`` 0.5, ``horizon``
    64, ``seed`` the env seed). Each save writes ``save_<s>/`` with the
    components ``actor``, ``critic``, ``actor_optimizer`` and
    ``critic_optimizer``. ``EVOMOTION_PROFILE=1`` times each iteration and its
    rollout and update phases (``StepTimer``, waiting for the card) and
    prints them at each save with env-steps/s including the update;
    ``EVOMOTION_TRACE_DIR=<dir>`` writes one ``torch.profiler`` trace of
    iteration 10. Runs on ``device`` (default ``cuda``)."""
    if agent_name in _BATCHED_LATER:
        raise NotImplementedError(
            f"batched training of {agent_name!r} is not ported yet (ROADMAP A7)")
    if agent_name not in ("ppo_gae", "ppo"):
        raise SystemExit(f"batched training supports ppo_gae (and, later, "
                         f"{'/'.join(_BATCHED_LATER)}), not {agent_name}")
    dev = resolve(device)
    # mt_parity off: the envs draw their resets from the trainer's generator
    # (a shared mt19937 table would tilt every env identically)
    env = env_factory.make(env_seed, mt_parity=False, device=dev, per_env_step=False)
    g = lambda k, d: type(d)(agent_params[k]) if k in agent_params else d  # noqa: E731
    cfg = PpoConfig(
        hidden_size=g("hidden_size", 256),
        gamma=g("gamma", 0.99),
        lam=g("lambda", 0.95),
        epsilon=g("epsilon", 0.2),
        entropy_factor=g("entropy_factor", 0.01),
        critic_loss_factor=g("critic_loss_factor", 0.5),
        epoch=g("epoch", 8),
        learning_rate=g("learning_rate", 1e-3),
        clip_grad_norm=g("clip_grad_norm", 0.5),
        horizon=g("horizon", 64),
        n_envs=num_envs,
    )
    trainer = BatchedPpo(env, cfg, seed=g("seed", env_seed))
    timer = StepTimer() if os.environ.get("EVOMOTION_PROFILE") else None
    trace_dir = os.environ.get("EVOMOTION_TRACE_DIR")
    train_step = trainer.train_step_fn(timer)
    state = trainer.init()
    os.makedirs(output_path, exist_ok=True)

    t0 = time.time()
    it_global = 0
    for s in range(nb_saves):
        for e in range(episodes):
            it_global += 1
            if trace_dir and it_global == 10:
                with trace(trace_dir):
                    state, metrics = train_step(state)
                    float(metrics.actor_loss)
            elif timer is not None:
                with timer.phase("train_iter", block_on=dev):
                    state, metrics = train_step(state)
            else:
                state, metrics = train_step(state)
            if e % 10 == 0 or e == episodes - 1:
                m = type(metrics)(*(float(x) for x in metrics))
                steps_done = (s * episodes + e + 1) * cfg.horizon * num_envs
                sps = steps_done / (time.time() - t0)
                _progress(
                    f"save {s} actor={m.actor_loss:.4f} critic={m.critic_loss:.4f} "
                    f"r/step={m.mean_reward:.4f} {sps:,.0f} env-steps/s",
                    e + 1, episodes, t0,
                )
        if timer is not None:
            print(f"\n[profile] {timer.summary()}  "
                  f"({timer.rate('train_iter', cfg.horizon * num_envs):,.0f} env-steps/s "
                  f"incl. update)")
        save_dir = os.path.join(output_path, f"save_{s}")
        save_component(save_dir, "actor", state.actor)
        save_component(save_dir, "critic", state.critic)
        save_component(save_dir, "actor_optimizer", adam_tree(state.actor_opt, state.actor))
        save_component(save_dir, "critic_optimizer",
                       adam_tree(state.critic_opt, state.critic))
    print()
    return 0


def _scalars(res):
    """(reward, valid, done) of a batch-of-one StepResult, read from the
    device in one transfer."""
    r, v, d = torch.stack([res.reward.float(), res.valid.float(), res.done.float()]).view(
        3, -1)[:, 0].tolist()
    return r, v > 0.5, d > 0.5


def infer(env_seed, agent_factory, env_factory, input_path, episodes=1, record_path=None,
          device=None):
    """Checkpoint rollout (infer.cpp): ``episodes`` episodes, each a reset
    then act/step until done, settle frames skipped with zero actions; prints
    one line per episode. Runs on ``device`` (default ``cuda``)."""
    if record_path is not None:
        raise NotImplementedError("trajectory recording is not ported yet (ROADMAP A11)")
    dev = resolve(device)
    env = env_factory.make(env_seed, device=dev)
    agent = agent_factory.create_agent(env.observation_size, env.action_size)
    agent.load(input_path)
    agent.set_eval(True)
    # reset draws come from the env's mt19937 table; the generator serves an
    # env made without one
    gen = torch.Generator(device=dev).manual_seed(env_seed)
    zeros = torch.zeros((1, env.action_size), device=dev)
    for ep in range(episodes):
        state, res = env.reset(1, gen)
        reward, _, _ = _scalars(res)
        total, steps = 0.0, 0
        while True:
            action = agent.act(res.obs, reward)
            state, res = env.step(state, action, gen)
            reward, valid, done = _scalars(res)
            # settle-phase frames: the reference blocks inside reset()
            while not valid:
                state, res = env.step(state, zeros, gen)
                reward, valid, done = _scalars(res)
            total += reward
            steps += 1
            if done:
                break
        agent.done(res.obs, reward)
        print(f"episode {ep}: {steps} steps, return {total:.3f}", flush=True)
    return 0

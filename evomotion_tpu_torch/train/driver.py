"""Training and inference drivers (port of ``evomotion_tpu/train/driver.py``).

``train``: src/train.cpp:17-87, the sequential trainer behind the CLI's
``train`` with ``--num_envs 1``: one env (a batch of one on the per-env
physics step), act/done per step, ``save_<i>/`` every ``episodes``
episodes. ``train_batched``: the batched trainers behind ``train
--num_envs N`` (N > 1): N envs in lockstep on the batched physics step,
PPO-GAE (``ppo_batched``) and liquid PPO-GAE (``ppo_liquid_batched``), A2C
and PPO-vanilla (``onpolicy_step_batched``) or SAC, CrossQ and liquid SAC
with a device ring (``offpolicy_batched``), ``save_<i>/`` checkpoints of
the reference's components. ``infer``: src/infer.cpp:19-106: load an agent,
then step one env until done, episode after episode, on the per-env physics
step, optionally recording the body poses (``viewer.recorder``). Both
sequential loops serve every agent of the factory, the liquid ones too.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

import torch

from ..device import resolve
from .offpolicy_batched import (
    BatchedOffPolicy,
    BatchedOffPolicyLiquid,
    OffPolicyConfig,
    OffPolicyLiquidConfig,
)
from .onpolicy_step_batched import BatchedStepTrainer, StepTrainerConfig
from .ppo_batched import BatchedPpo, PpoConfig, save_agent
from .ppo_liquid_batched import BatchedPpoLiquid, PpoLiquidConfig
from .profiling import StepTimer, recording, span, trace


def _progress(prefix: str, i: int, total: int, t0: float) -> None:
    elapsed = time.time() - t0
    eta = elapsed / max(i, 1) * (total - i)
    sys.stdout.write(
        f"\r{prefix} [{i}/{total}] elapsed {elapsed:5.1f}s eta {eta:5.1f}s  "
    )
    sys.stdout.flush()


def _scalars(res):
    """(reward, valid, done) of a batch-of-one StepResult, read from the
    device in one transfer."""
    r, v, d = torch.stack([res.reward.float(), res.valid.float(), res.done.float()]).view(
        3, -1)[:, 0].tolist()
    return r, v > 0.5, d > 0.5


def train(env_seed, agent_factory, env_factory, episodes, nb_saves, output_path, device=None):
    """Sequential reference-parity loop (train.cpp:17-87): one env, act/done
    per step, settle frames stepped through with zero actions, and a save
    every ``episodes`` episodes into ``save_<i>/``. Runs on ``device``
    (default ``cuda``)."""
    dev = resolve(device)
    env = env_factory.make(env_seed, device=dev)
    agent = agent_factory.create_agent(env.observation_size, env.action_size, device=dev)
    os.makedirs(output_path, exist_ok=True)
    # reset draws come from the env's mt19937 table; the generator serves an
    # env made without one
    gen = torch.Generator(device=dev).manual_seed(env_seed)
    zeros = torch.zeros((1, env.action_size), device=dev)
    state, res = env.reset(1, gen)
    reward, _, _ = _scalars(res)
    t0 = time.time()
    for s in range(nb_saves):
        for e in range(episodes):
            while True:
                action = agent.act(res.obs, reward)
                state, res = env.step(state, action, gen)
                reward, valid, done = _scalars(res)
                # skip settle-phase frames (the reference blocks inside
                # reset(); here they arrive as invalid transitions)
                while not valid:
                    state, res = env.step(state, zeros, gen)
                    reward, valid, done = _scalars(res)
                if done:
                    break
            agent.done(res.obs, reward)
            # after done, the env settles; fast-forward to the next
            # episode's first valid observation (reference reset() returns it)
            while not valid:
                state, res = env.step(state, zeros, gen)
                reward, valid, done = _scalars(res)
            metrics = " ".join(m.to_string() for m in agent.get_metrics())
            _progress(f"save {s} {metrics}", e + 1, episodes, t0)
        agent.save(os.path.join(output_path, f"save_{s}"))
    print()
    return 0


def train_batched(env_seed, env_factory, agent_params, num_envs, episodes, nb_saves,
                  output_path, agent_name="ppo_gae", device=None):
    """Batched trainer: N envs in lockstep, rollout + update per iteration.

    ``episodes`` is read as train iterations per save (each covers
    horizon * num_envs env steps). Agents: ``ppo_gae`` / ``ppo`` (PPO-GAE,
    ``ppo_batched.py``) and ``ppo_gae_liquid`` (``ppo_liquid_batched.py``),
    ``actor_critic`` / ``ppo_vanilla`` (``onpolicy_step_batched.py``) and
    ``soft_actor_critic`` / ``cross_q`` / ``soft_actor_critic_liquid``
    (device ring, ``offpolicy_batched.py``). Agent parameters and their defaults are
    the JAX package's (``evomotion_tpu/train/driver.py``); ``seed`` defaults
    to the env seed and ``horizon`` (64) is the rollout length. PPO:
    ``hidden_size`` 256, ``gamma`` 0.99, ``lambda`` 0.95, ``epsilon`` 0.2,
    ``entropy_factor`` 0.01, ``critic_loss_factor`` 0.5, ``epoch`` 8,
    ``learning_rate`` 1e-3, ``clip_grad_norm`` 0.5; each save writes the
    components ``actor``, ``critic``, ``actor_optimizer`` and
    ``critic_optimizer``; liquid PPO-GAE takes the same keys but
    ``hidden_size``, with ``neuron_number`` 64 and ``unfolding_steps`` 6,
    and saves the same components. SAC / CrossQ: ``hidden_size`` 256 (the actor's),
    ``critic_hidden_size`` (default ``hidden_size``), ``batch_size`` 256,
    ``epoch`` 1, ``learning_rate`` 3e-4, ``gamma`` 0.99, ``tau`` 0.005,
    ``train_every`` 1, ``replay_buffer_size`` 262144 (the ring), and, beyond
    the JAX driver's keys, ``nan_guard`` (``true``/``false``, default false:
    skip an update whose losses are not finite, as the walker tool always
    does); each save writes the agent's components. Liquid SAC: the SAC
    keys but ``hidden_size``, ``critic_hidden_size`` and ``nan_guard``, with
    ``neuron_number`` 64, ``unfolding_steps`` 6 and ``replay_buffer_size``
    65536. A2C / PPO-vanilla:
    ``hidden_size`` 256, ``batch_size`` 256, ``learning_rate`` 1e-3,
    ``gamma`` 0.99, ``entropy_start_factor`` 0.01, ``entropy_end_factor``
    1e-4, ``entropy_steps`` 100000, ``epsilon`` 0.2, ``entropy_factor``
    0.01, ``critic_loss_factor`` 0.5, ``epoch`` 8, ``train_every`` 1,
    ``replay_buffer_size`` 262144 (A2C's ring); each save writes the
    agent's four components. ``EVOMOTION_PROFILE=1``
    times each iteration and its rollout and update phases (``StepTimer``,
    waiting for the card) and prints them at each save with env-steps/s
    including the update (the ``[profile]`` line: ``rollout``, ``update``
    and ``train_iter``), and records the program's spans from the trainer's
    build on (``profiling.recording``; the set-up spans wait for the card)
    into the ``[spans]`` line: host seconds and calls of each span, e.g.
    ``setup.trainer``, ``env.reset``, ``kernels.build`` (an nvcc run) and
    ``physics.step``. ``EVOMOTION_TRACE_DIR=<dir>`` writes one
    ``torch.profiler`` trace of iteration 10, ``<dir>/trace.json``, with
    the program's spans as ranges on the card's clock; ``python -m
    evomotion_tpu_torch.train.profiling <dir>/trace.json`` charges its
    kernels and the card's idle time to them. Runs on ``device`` (default
    ``cuda``)."""
    dev = resolve(device)
    timer = StepTimer() if os.environ.get("EVOMOTION_PROFILE") else None
    spans = StepTimer()
    with contextlib.nullcontext() if timer is None else recording(spans):
        trainer, horizon, critic_loss, save = make_batched_trainer(
            env_seed, env_factory, agent_params, num_envs, agent_name, dev)
        trace_dir = os.environ.get("EVOMOTION_TRACE_DIR")
        train_step = trainer.train_step_fn(timer=timer)
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
                    steps_done = (s * episodes + e + 1) * horizon * num_envs
                    sps = steps_done / (time.time() - t0)
                    _progress(
                        f"save {s} actor={m.actor_loss:.4f} critic={critic_loss(m):.4f} "
                        f"r/step={m.mean_reward:.4f} {sps:,.0f} env-steps/s",
                        e + 1, episodes, t0,
                    )
            if timer is not None:
                print(f"\n[profile] {timer.summary()}  "
                      f"({timer.rate('train_iter', horizon * num_envs):,.0f} env-steps/s "
                      f"incl. update)")
                print("[spans] " + ", ".join(
                    f"{k} {spans.totals[k]:.3f} s in {spans.counts[k]} calls"
                    for k in sorted(spans.totals)))
            save(os.path.join(output_path, f"save_{s}"), state)
    print()
    return 0


def make_batched_trainer(env_seed, env_factory, agent_params, num_envs, agent_name="ppo_gae",
                         device=None):
    """The batched trainer of :func:`train_batched` (its agents, keys and
    defaults) over ``num_envs`` envs of ``env_factory`` on ``device``:
    ``(trainer, horizon, critic_loss, save)``, ``critic_loss(metrics)`` the
    progress line's critic loss and ``save(folder, state)`` the writer of
    ``save_<i>/``. The span ``setup.trainer`` holds the build."""
    with span("setup.trainer", block_on=resolve(device)):
        offpolicy = agent_name in ("soft_actor_critic", "cross_q", "soft_actor_critic_liquid")
        step_buffer = agent_name in ("actor_critic", "ppo_vanilla")
        if not (offpolicy or step_buffer or agent_name in ("ppo_gae", "ppo", "ppo_gae_liquid")):
            raise SystemExit("batched training supports ppo_gae/ppo_gae_liquid/actor_critic/"
                             "ppo_vanilla/soft_actor_critic/soft_actor_critic_liquid/cross_q, "
                             f"not {agent_name}")
        dev = resolve(device)
        # mt_parity off: the envs draw their resets from the trainer's generator
        # (a shared mt19937 table would tilt every env identically)
        env = env_factory.make(env_seed, mt_parity=False, device=dev, per_env_step=False)
        g = lambda k, d: type(d)(agent_params[k]) if k in agent_params else d  # noqa: E731
        if offpolicy:
            common = dict(
                batch_size=g("batch_size", 256),
                epoch=g("epoch", 1),
                learning_rate=g("learning_rate", 3e-4),
                gamma=g("gamma", 0.99),
                tau=g("tau", 0.005),
                train_every=g("train_every", 1),
                steps_per_iter=g("horizon", 64),
                n_envs=num_envs,
            )
            if agent_name == "soft_actor_critic_liquid":
                cfg = OffPolicyLiquidConfig(
                    neurons=g("neuron_number", 64),
                    unfolding_steps=g("unfolding_steps", 6),
                    buffer_capacity=g("replay_buffer_size", 65536),
                    **common,
                )
                trainer = BatchedOffPolicyLiquid(env, cfg, seed=g("seed", env_seed))
            else:
                guard = agent_params.get("nan_guard", "false")
                if guard not in ("true", "false"):
                    raise ValueError(f"nan_guard={guard!r}: expected true or false")
                cfg = OffPolicyConfig(
                    actor_hidden_size=g("hidden_size", 256),
                    critic_hidden_size=g("critic_hidden_size", g("hidden_size", 256)),
                    buffer_capacity=g("replay_buffer_size", 262144),
                    nan_guard=guard == "true",
                    **common,
                )
                trainer = BatchedOffPolicy(env, agent_name, cfg, seed=g("seed", env_seed))
            horizon = cfg.steps_per_iter

            def critic_loss(m):
                return m.critic_1_loss

            save = trainer.save
        elif step_buffer:
            cfg = StepTrainerConfig(
                hidden_size=g("hidden_size", 256),
                batch_size=g("batch_size", 256),
                learning_rate=g("learning_rate", 1e-3),
                gamma=g("gamma", 0.99),
                entropy_start_factor=g("entropy_start_factor", 0.01),
                entropy_end_factor=g("entropy_end_factor", 1e-4),
                entropy_steps=g("entropy_steps", 100000),
                epsilon=g("epsilon", 0.2),
                entropy_factor=g("entropy_factor", 0.01),
                critic_loss_factor=g("critic_loss_factor", 0.5),
                epoch=g("epoch", 8),
                train_every=g("train_every", 1),
                steps_per_iter=g("horizon", 64),
                n_envs=num_envs,
                buffer_capacity=g("replay_buffer_size", 262144),
            )
            trainer = BatchedStepTrainer(env, agent_name, cfg, seed=g("seed", env_seed))
            horizon = cfg.steps_per_iter

            def critic_loss(m):
                return m.critic_loss

            save = trainer.save
        else:
            common = dict(
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
            if agent_name == "ppo_gae_liquid":
                cfg = PpoLiquidConfig(
                    neurons=g("neuron_number", 64),
                    unfolding_steps=g("unfolding_steps", 6),
                    **common,
                )
                trainer = BatchedPpoLiquid(env, cfg, seed=g("seed", env_seed))
            else:
                cfg = PpoConfig(hidden_size=g("hidden_size", 256), **common)
                trainer = BatchedPpo(env, cfg, seed=g("seed", env_seed))
            horizon = cfg.horizon

            def critic_loss(m):
                return m.critic_loss

            save = save_agent
        return trainer, horizon, critic_loss, save


def infer(env_seed, agent_factory, env_factory, input_path, episodes=1, record_path=None,
          device=None):
    """Checkpoint rollout (infer.cpp): ``episodes`` episodes, each a reset
    then act/step until done, settle frames skipped with zero actions; prints
    one line per episode. With ``record_path`` the body poses after every
    counted step go to that ``.npz`` (``viewer.recorder``). Runs on
    ``device`` (default ``cuda``)."""
    dev = resolve(device)
    env = env_factory.make(env_seed, device=dev)
    agent = agent_factory.create_agent(env.observation_size, env.action_size, device=dev)
    agent.load(input_path)
    agent.set_eval(True)
    # reset draws come from the env's mt19937 table; the generator serves an
    # env made without one
    gen = torch.Generator(device=dev).manual_seed(env_seed)
    zeros = torch.zeros((1, env.action_size), device=dev)
    recorder = None
    if record_path is not None:
        from ..viewer.recorder import TrajectoryRecorder

        recorder = TrajectoryRecorder(env)
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
            if recorder is not None:
                recorder.add(state)
            total += reward
            steps += 1
            if done:
                break
        agent.done(res.obs, reward)
        print(f"episode {ep}: {steps} steps, return {total:.3f}", flush=True)
    if recorder is not None:
        recorder.save(record_path)
        print(f"trajectory written to {record_path}", flush=True)
    return 0

"""Inference driver of the sequential tier (port of ``infer`` in
``evomotion_tpu/train/driver.py``).

Reference: src/infer.cpp:19-106: load an agent, then step one env until
done, episode after episode. The env is a batch of one world stepped by the
per-env physics step; the GL window's recording hooks are a later slice
(ROADMAP A12). Training (``train``, train.cpp) needs the learning agents and
waits for them.
"""

from __future__ import annotations

import torch

from ..device import resolve


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
        raise NotImplementedError("trajectory recording is not ported yet (ROADMAP A12)")
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

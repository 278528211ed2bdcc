"""Batched step-buffer trainers: A2C (actor_critic) and PPO-vanilla (port
of ``evomotion_tpu/train/onpolicy_step_batched.py``).

Reference counterparts: ActorCriticAgent (actor_critic.cpp: stores steps
in a replay buffer, trains every ``train_every`` steps on a shuffled batch
with a decayed entropy bonus) and PpoVanillaAgent (ppo_vanilla.cpp:
single-step buffer, one-step advantage, ``epoch`` clipped-surrogate epochs
per batch).

As in the JAX package, the tier mirrors ``offpolicy_batched``: N envs in
lockstep, one iteration = a T-step rollout (the truncated-normal policy of
the agent's actor), then for A2C a write of the block into the device
``Ring`` and ``steps_per_iter // train_every`` update events, each on a
batch sampled from the valid ring entries by inverse CDF (the newest slot
excluded, ``torch.searchsorted``, JAX's ``side="left"``), run only once the
ring holds ``batch_size`` valid entries; for PPO-vanilla, its ``epoch``
epochs over the whole rollout block, settle frames included (the JAX
behaviour, kept). The update math is the sequential agents' own ``update``
(``agents.actor_critic``, ``agents.ppo_vanilla``): one source of truth for
the losses, the reference's A2C [B,1,1] x [B,A] broadcast and PPO-vanilla's
recomputed "old" log-prob. A2C's entropy factor decays on ``global_step``,
counted in env-time steps (the sequential agent counts its train steps).

Random draws come from the state's ``torch.Generator`` (on the env's
device), or from a :class:`StepDraws` the caller passes (the tests pass
JAX's). Host reads: A2C's ``has_enough``, once per iteration. Inside a
``parallel.mesh`` the rollout is gathered into its global block, as in
``offpolicy_batched``, and both updates run replicated on it.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, NamedTuple

import torch

from ..agents.actor_critic import ActorCriticAgent
from ..agents.ppo_vanilla import PpoVanillaAgent
from .offpolicy_batched import Ring, gather_traj, rollout


@dataclasses.dataclass(frozen=True)
class StepTrainerConfig:
    hidden_size: int = 256
    batch_size: int = 256
    learning_rate: float = 1e-3
    gamma: float = 0.99
    # A2C entropy schedule (reference exponential_decrease)
    entropy_start_factor: float = 0.01
    entropy_end_factor: float = 1e-4
    entropy_steps: int = 100000
    # PPO-vanilla
    epsilon: float = 0.2
    entropy_factor: float = 0.01
    critic_loss_factor: float = 0.5
    epoch: int = 8
    train_every: int = 1
    steps_per_iter: int = 64
    n_envs: int = 1024
    buffer_capacity: int = 262144  # A2C ring only, rounded up to a multiple of T*N


@dataclasses.dataclass
class StepTrainState:
    agent: Any  # ActorCriticAgent or PpoVanillaAgent: the JAX state's carry
    ring: Ring | None  # A2C's transitions; None for PPO-vanilla
    env_state: Any
    obs: torch.Tensor  # [N, S]
    prev_valid: torch.Tensor  # [N] bool: input-obs validity of the next transition
    generator: torch.Generator  # actions, samples and env resets, on the env's device
    iteration: int
    global_step: int  # env-time steps, drives A2C's entropy schedule
    ep_steps: torch.Tensor  # [N] int32: valid steps in each env's open episode


class StepTrainMetrics(NamedTuple):
    actor_loss: torch.Tensor
    critic_loss: torch.Tensor
    mean_reward: torch.Tensor
    episodes_done: torch.Tensor
    updates_done: torch.Tensor


class StepDraws(NamedTuple):
    """The uniforms of one iteration, in place of the generator's: the
    rollout's actions [T, N, A] and, for A2C, each update event's sample
    [U, B] (PPO-vanilla's update draws nothing)."""

    rollout: torch.Tensor
    sample: torch.Tensor | None = None


class BatchedStepTrainer:
    """algo: ``"actor_critic"`` or ``"ppo_vanilla"``; ``env`` a batched env
    (``reset(n_envs, generator)``, ``step(state, action, generator)``,
    ``observation_size``, ``action_size``, ``device``)."""

    def __init__(self, env, algo: str, config: StepTrainerConfig = StepTrainerConfig(),
                 seed: int = 1234):
        if algo not in ("actor_critic", "ppo_vanilla"):
            raise ValueError(f"unsupported step-trainer algo: {algo}")
        self.env = env
        self.algo = algo
        self.config = cfg = config
        self.seed = seed
        block = cfg.steps_per_iter * cfg.n_envs
        cap = max(cfg.buffer_capacity, block) if algo == "actor_critic" else block
        self.capacity = ((cap + block - 1) // block) * block
        self.updates_per_iter = max(1, cfg.steps_per_iter // cfg.train_every)

    def make_agent(self):
        """A fresh agent (weights from a CPU generator seeded with ``seed``)
        on the env's device."""
        cfg, env = self.config, self.env
        s, a = env.observation_size, env.action_size
        if self.algo == "actor_critic":
            return ActorCriticAgent(
                self.seed, s, a, cfg.hidden_size, cfg.batch_size, cfg.learning_rate, cfg.gamma,
                cfg.entropy_start_factor, cfg.entropy_end_factor, cfg.entropy_steps,
                replay_buffer_size=1, train_every=cfg.train_every, device=env.device)
        return PpoVanillaAgent(
            self.seed, s, a, cfg.hidden_size, cfg.gamma, cfg.epsilon, cfg.entropy_factor,
            cfg.critic_loss_factor, cfg.epoch, cfg.batch_size, cfg.learning_rate,
            device=env.device)

    def init(self) -> StepTrainState:
        """A fresh agent, an empty ring (A2C), and ``n_envs`` envs reset with
        a generator on the env's device seeded with ``seed``."""
        cfg = self.config
        dev = self.env.device
        gen = torch.Generator(device=dev).manual_seed(self.seed)
        env_state, first = self.env.reset(cfg.n_envs, gen)
        ring = (Ring.empty(self.capacity, self.env.observation_size, self.env.action_size, dev)
                if self.algo == "actor_critic" else None)
        return StepTrainState(
            agent=self.make_agent(), ring=ring, env_state=env_state, obs=first.obs,
            prev_valid=first.valid.clone(), generator=gen, iteration=0, global_step=0,
            ep_steps=torch.zeros(cfg.n_envs, dtype=torch.int32, device=dev))

    def entropy_factor(self, global_step: int) -> torch.Tensor:
        """A2C's entropy factor after ``global_step`` env-time steps:
        start * (end / start) ** min(step / entropy_steps, 1), in f32."""
        cfg = self.config
        frac = torch.clamp_max(torch.tensor(global_step, dtype=torch.float32)
                               / max(cfg.entropy_steps, 1), 1.0)
        ratio = torch.tensor(cfg.entropy_end_factor / cfg.entropy_start_factor)
        return cfg.entropy_start_factor * ratio ** frac

    def train_step_fn(self, timer=None):
        """``train_step(state, uniforms=None) -> (state, StepTrainMetrics)``:
        one iteration, the state changed in place. ``uniforms`` is a
        :class:`StepDraws`. With a ``train.profiling.StepTimer`` the rollout
        (with the ring write) and the update are timed as the phases
        ``rollout`` and ``update``, each ending in a wait for the card."""
        cfg = self.config
        block = cfg.steps_per_iter * cfg.n_envs
        dev = self.env.device

        def phase(name):
            if timer is None:
                return contextlib.nullcontext()
            return timer.phase(name, block_on=dev)

        def train_step(state: StepTrainState, uniforms: StepDraws | None = None):
            agent = state.agent
            with phase("rollout"):
                traj = gather_traj(rollout(self.env, agent.actor, state, cfg.steps_per_iter,
                                           None if uniforms is None else uniforms.rollout))
                t_obs, t_act, t_rew, t_done, t_next, t_valid = (
                    x.reshape((block,) + x.shape[2:]) for x in traj[:6])
                if state.ring is not None:
                    state.ring = state.ring.write(
                        (t_obs, t_act, t_rew, t_done.float(), t_next, t_valid))
            with phase("update"):
                if self.algo == "ppo_vanilla":
                    # the rollout block IS the batch (the reference's single-step
                    # buffer holds exactly batch_size steps)
                    losses = agent.update((t_obs, t_act, t_rew[:, None],
                                           t_done[:, None].float(), t_next))
                    updates_done = cfg.epoch
                else:
                    losses, updates_done = self._events(state, uniforms)
            a_loss, c_loss = losses.mean(0)
            state.iteration += 1
            state.global_step += cfg.steps_per_iter
            nv = torch.clamp_min(t_valid.sum(), 1.0)
            return state, StepTrainMetrics(
                actor_loss=a_loss, critic_loss=c_loss,
                mean_reward=(t_rew * t_valid).sum() / nv,
                episodes_done=t_done.sum(),
                updates_done=torch.tensor(updates_done),
            )

        return train_step

    def _events(self, state: StepTrainState, uniforms):
        """A2C's update events on batches drawn from the ring; returns their
        (policy metric, critic loss) [U, 2] and the count, zeros and 0 while
        the ring holds fewer than ``batch_size`` trainable entries."""
        cfg, ring, dev = self.config, state.ring, self.env.device
        n = self.updates_per_iter
        cdf, total = ring.cdf()
        if not bool(total >= cfg.batch_size):  # one host read
            return torch.zeros((n, 2), device=dev), 0
        ef = self.entropy_factor(state.global_step).to(dev)
        out = []
        for i in range(n):
            u = (torch.rand(cfg.batch_size, generator=state.generator, device=dev)
                 if uniforms is None else uniforms.sample[i])
            _, batch = self.sample(ring, cdf, total, u)
            out.append(state.agent.update(batch, ef)[[0, 2]])
        return torch.stack(out), n

    @staticmethod
    def sample(ring: Ring, cdf, total, u):
        """``ring.sample``: the indices ``u`` picks and the batch there."""
        return ring.sample(cdf, total, u)

    def save(self, folder: str, state: StepTrainState) -> None:
        """The agent's four components, as the sequential agent saves them."""
        state.agent.save(folder)

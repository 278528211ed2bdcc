"""Batched PPO-GAE trainer with Liquid-Time-Constant (LTC) networks (port of
``evomotion_tpu/train/ppo_liquid_batched.py``).

Reference counterpart: PpoGaeLiquidAgent
(evo_motion_networks/src/agents/ppo_gae_liquid.cpp), the PPO-GAE algorithm
of ppo_gae.cpp with recurrent actor and critic (LTC cells,
liquid_cell.cpp:52-63) whose hidden states x_t are stored per step in the
replay buffer (replay_buffer.h:33-56) and replayed during training.

As in the JAX package (and ``ppo_batched.BatchedPpo``), N envs advance in
lockstep: the rollout carries the per-env hidden states [N, neurons] and
stores the PRE-step x_t with each step, the hidden state the forward pass
consumed, as the reference's buffers do. The update replays every
(obs_t, x_t) pair of the [T, N] block at once: replay from stored states is
teacher forcing (the reference's training forward passes read the stored
x_t, not a recomputed chain), so the backward pass has no recurrence. Hidden
states reset to the first state (SiLU(0) = 0) on episode end
(actor_critic_liquid.cpp:132-140) and freeze across invalid settle frames,
which in the reference never reach the agent.

The JAX liquid trainer reads only PPO's core fields of its config; so does
this one: ``obs_norm``, the sigma schedule, the entropy decay and the
survival bonus of :class:`~.ppo_batched.PpoConfig` are ignored. Inside a
``parallel.mesh`` it takes the global sums of ``ppo_batched`` (the GAE
statistics, loss denominators, gradients and metrics), each rank replaying
its own rows' hidden states.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, NamedTuple

import torch

from ..networks import distributions as D
from ..networks.liquid import LiquidActor, LiquidCritic, first_x
from .ppo_batched import PpoConfig, PpoMetrics, _step, gae_and_normalize, ppo_metrics


@dataclasses.dataclass(frozen=True)
class PpoLiquidConfig(PpoConfig):
    neurons: int = 64  # reference key: neuron_number
    unfolding_steps: int = 6


@dataclasses.dataclass
class PpoLiquidTrainState:
    actor: LiquidActor
    critic: LiquidCritic
    actor_opt: torch.optim.Adam
    critic_opt: torch.optim.Adam
    env_state: Any  # batched env state, env axis first
    obs: torch.Tensor  # [N, S]
    actor_x: torch.Tensor  # [N, neurons]
    critic_x: torch.Tensor  # [N, neurons]
    generator: torch.Generator  # actions and env resets, on the env's device
    iteration: int
    ep_steps: torch.Tensor  # [N] int32: valid steps in each env's open episode


class LiquidTrajectory(NamedTuple):
    """One rollout, [T, N, ...]: the fields of ``ppo_batched.Trajectory``,
    then the pre-step hidden states."""

    obs: torch.Tensor
    action: torch.Tensor
    log_prob: torch.Tensor
    value: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    valid: torch.Tensor
    done_len: torch.Tensor
    win: torch.Tensor
    actor_x: torch.Tensor  # [T, N, neurons]
    critic_x: torch.Tensor  # [T, N, neurons]


class BatchedPpoLiquid:
    """Liquid PPO-GAE over ``env``, a batched env (``reset(n_envs,
    generator)``, ``step(state, action, generator)``, ``observation_size``,
    ``action_size``, ``device``)."""

    def __init__(self, env, config: PpoLiquidConfig = PpoLiquidConfig(), seed: int = 1234):
        self.env = env
        self.config = config
        self.seed = seed

    def init(self) -> PpoLiquidTrainState:
        """Fresh networks (drawn from a CPU generator seeded with ``seed``,
        actor first), Adam optimizers, first hidden states, and ``n_envs``
        envs reset with a generator on the env's device seeded with
        ``seed``."""
        cfg = self.config
        dev = self.env.device
        s, a = self.env.observation_size, self.env.action_size
        init_gen = torch.Generator().manual_seed(self.seed)
        actor = LiquidActor(s, a, cfg.neurons, cfg.unfolding_steps, init_gen).to(dev)
        critic = LiquidCritic(s, cfg.neurons, cfg.unfolding_steps, init_gen).to(dev)
        gen = torch.Generator(device=dev).manual_seed(self.seed)
        env_state, first = self.env.reset(cfg.n_envs, gen)
        return PpoLiquidTrainState(
            actor=actor,
            critic=critic,
            actor_opt=torch.optim.Adam(actor.parameters(), lr=cfg.learning_rate),
            critic_opt=torch.optim.Adam(critic.parameters(), lr=cfg.learning_rate),
            env_state=env_state,
            obs=first.obs,
            actor_x=first_x(cfg.neurons, cfg.n_envs, dev),
            critic_x=first_x(cfg.neurons, cfg.n_envs, dev),
            generator=gen,
            iteration=0,
            ep_steps=torch.zeros(cfg.n_envs, dtype=torch.int32, device=dev),
        )

    def rollout_fn(self):
        """``rollout(state, uniforms=None) -> (state, LiquidTrajectory)``:
        ``horizon`` env steps of the sampled policy; ``uniforms`` [T, N, A]
        replace the generator's action draws. Advances the state's env
        batch, obs, hidden states and episode steps in place."""
        cfg = self.config
        env = self.env

        @torch.no_grad()
        def rollout(state: PpoLiquidTrainState, uniforms=None):
            env_state, obs, ep_steps = state.env_state, state.obs, state.ep_steps
            ax, cx = state.actor_x, state.critic_x
            steps = []
            for t in range(cfg.horizon):
                mu, sigma, new_ax = state.actor(ax, obs)
                u = None if uniforms is None else uniforms[t]
                action = D.truncated_normal_sample(mu, sigma, state.generator, u)
                log_prob = D.truncated_normal_log_pdf(action, mu, sigma)
                value, new_cx = state.critic(cx, obs)
                env_state, res = env.step(env_state, action, state.generator)
                grown = ep_steps + res.valid.to(torch.int32)
                ended = res.done & res.valid
                done_len = torch.where(ended, grown, 0)
                ep_steps = torch.where(ended, 0, grown)
                steps.append((obs, action, log_prob, value, res.reward, res.done, res.valid,
                              done_len, res.win & ended, ax, cx))
                # advance only across valid frames; reset at episode end
                validf = res.valid[:, None].float()
                donef = res.done[:, None].float()
                ax = (1.0 - donef) * (validf * new_ax + (1.0 - validf) * ax)
                cx = (1.0 - donef) * (validf * new_cx + (1.0 - validf) * cx)
                obs = res.obs
            state.env_state, state.obs, state.ep_steps = env_state, obs, ep_steps
            state.actor_x, state.critic_x = ax, cx
            return state, LiquidTrajectory(*(torch.stack(x) for x in zip(*steps)))

        return rollout

    def train_step_fn(self, timer=None):
        """``train_step(state, uniforms=None) -> (state, PpoMetrics)``: one
        rollout, GAE, ``epoch`` actor and critic updates replayed from the
        stored hidden states. With a ``train.profiling.StepTimer`` the
        rollout and the update are timed as the phases ``rollout`` and
        ``update``, each ending in a wait for the card."""
        rollout = self.rollout_fn()

        def phase(name):
            if timer is None:
                return contextlib.nullcontext()
            return timer.phase(name, block_on=self.env.device)

        def train_step(state: PpoLiquidTrainState, uniforms=None):
            with phase("rollout"):
                state, traj = rollout(state, uniforms)
            with phase("update"):
                metrics = self._update(state, traj)
            return state, metrics

        return train_step

    def _update(self, state: PpoLiquidTrainState, traj: LiquidTrajectory) -> PpoMetrics:
        cfg = self.config
        obs, actions, log_probs = traj.obs, traj.action, traj.log_prob
        with torch.no_grad():
            bootstrap, _ = state.critic(state.critic_x, state.obs)  # [N, 1]
            advantages, returns, maskf, n = gae_and_normalize(
                cfg, traj.value, traj.reward, traj.done, traj.valid, bootstrap)
        n_act = n * actions.shape[-1]

        a_losses, c_losses = [], []
        for _ in range(cfg.epoch):
            # replay from the stored hidden states, [T, N] at once
            mu, sigma, _ = state.actor(traj.actor_x, obs)
            lp = D.truncated_normal_log_pdf(actions, mu, sigma)
            entropy = D.truncated_normal_entropy(mu, sigma)
            ratios = torch.exp(lp - log_probs)
            s1 = ratios * advantages
            s2 = torch.clamp(ratios, 1.0 - cfg.epsilon, 1.0 + cfg.epsilon) * advantages
            obj = torch.minimum(s1, s2) + cfg.entropy_factor * entropy
            a_loss = -(obj * maskf).sum() / n_act
            _step(state.actor_opt, state.actor, a_loss, cfg.clip_grad_norm)
            a_losses.append(a_loss.detach())
            v, _ = state.critic(traj.critic_x, obs)
            c_loss = cfg.critic_loss_factor * (((v - returns) ** 2) * maskf).sum() / n
            _step(state.critic_opt, state.critic, c_loss, cfg.clip_grad_norm)
            c_losses.append(c_loss.detach())

        state.iteration += 1
        return ppo_metrics(a_losses, c_losses, traj, maskf, n)

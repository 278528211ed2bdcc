"""PPO with Generalized Advantage Estimation, trajectory-based (port of
``evomotion_tpu/agents/ppo_gae.py``).

Reference: evo_motion_networks/src/agents/ppo_gae.cpp. Semantics preserved:

- act (ppo_gae.cpp:29-45): sample the truncated normal, store (s, a, 0,
  false, log pi, V, V) with the reward patched one step late;
- done (47-61): writes the terminal V, trains at global_step % train_every
  == train_every - 1 with >= batch_size complete trajectories, then opens
  a new trajectory (``global_curr_step`` counts episodes);
- train (117-190): trajectories padded with done = 1 (to a multiple of 32,
  as the JAX agent pads them; the padded steps are masked out of every
  sum), the GAE backward scan, advantages normalized over the valid steps
  (unbiased), ``returns`` built from the *normalized* advantages (reference
  quirk), ``epoch`` epochs of clipped surrogate + entropy bonus and critic
  MSE x critic_loss_factor, each with optax's global-norm clip then Adam.

Checkpoints hold ``actor``, ``actor_optimizer``, ``critic`` and
``critic_optimizer`` in the layout the batched PPO trainer writes
(``train.driver.train_batched``), so ``run`` of a ``save_<i>/`` from
``train --num_envs N`` loads into this agent.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..buffers.replay import PpoEpisodeStep, TrajectoryReplayBuffer
from ..networks import distributions as D
from ..train.metrics import LossMeter
from .base import ACTOR_CRITIC, ComponentAgent, init_actor_critic

PAD = 32  # trajectories are padded to a multiple of this many steps


class PpoGaeAgent(ComponentAgent):
    SAVE = CARRY = ACTOR_CRITIC

    def __init__(
        self, seed, state_space, action_space, hidden_size, gamma, lam, epsilon,
        entropy_factor, critic_loss_factor, epoch, batch_size, train_every, replay_buffer_size,
        learning_rate, clip_grad_norm, device=None,
    ):
        init_actor_critic(self, seed, state_space, action_space, hidden_size, learning_rate,
                          device)
        # torch: clip_grad_norm_ then Adam step (ppo_gae.cpp:171-186), by optax's rule
        self.clip = clip_grad_norm
        self.gamma, self.lam, self.epsilon = gamma, lam, epsilon
        self.entropy_factor = entropy_factor
        self.critic_loss_factor = critic_loss_factor
        self.epoch, self.batch_size, self.train_every = epoch, batch_size, train_every
        self.replay_buffer = TrajectoryReplayBuffer(replay_buffer_size, seed)
        self.curr_train_step = 0
        self.curr_episode_step = 0
        self.global_curr_step = 0
        self.actor_loss_meter = LossMeter("actor_loss", 64)
        self.critic_loss_meter = LossMeter("critic_loss", 64)
        self.episode_steps_meter = LossMeter("steps", 64)

    def update(self, batch) -> torch.Tensor:
        """``epoch`` epochs on padded trajectories ``batch`` = (states [B, T,
        S], actions [B, T, A], rewards [B, T, 1], dones [B, T, 1], log_probs
        [B, T, A], curr_values [B, T, 1], next_values [B, T, 1]), in place.
        Returns each epoch's actor and critic loss, [epoch, 2]."""
        states, actions, rewards, dones, log_probs, curr_values, next_values = batch
        gamma, lam, eps = self.gamma, self.lam, self.epsilon
        with torch.no_grad():
            # mask: the first step always valid; step t valid if t-1 not done
            maskf = torch.cat([torch.ones_like(dones[:, :1]), 1.0 - dones[:, :-1]], 1)
            maskf = (maskf == 1.0).float()  # [B, T, 1]
            deltas = rewards + (1.0 - dones) * gamma * next_values - curr_values
            advantages = torch.empty_like(deltas)
            g = torch.zeros_like(deltas[:, 0])
            for t in range(deltas.shape[1] - 1, -1, -1):  # backward over time
                g = deltas[:, t] * maskf[:, t] + gamma * lam * (1.0 - dones[:, t]) * g
                advantages[:, t] = g
            n = torch.clamp_min(maskf.sum(), 1.0)
            mean = (advantages * maskf).sum() / n
            var = (((advantages - mean) ** 2) * maskf).sum() / torch.clamp_min(n - 1.0, 1.0)
            advantages = (advantages - mean) / (torch.sqrt(var) + 1e-8)
            returns = advantages + curr_values  # reference uses the normalized advantages
            n_act = torch.clamp_min((maskf * torch.ones_like(actions)).sum(), 1.0)
        losses = []
        for _ in range(self.epoch):
            mu, sigma = self.actor(states)
            log_prob = D.truncated_normal_log_pdf(actions, mu, sigma)
            entropy = D.truncated_normal_entropy(mu, sigma)
            ratios = torch.exp(log_prob - log_probs)
            s1 = ratios * advantages
            s2 = torch.clamp(ratios, 1.0 - eps, 1.0 + eps) * advantages
            obj = torch.minimum(s1, s2) + self.entropy_factor * entropy
            a_loss = self._step("actor", -(obj * maskf).sum() / n_act)
            se = (self.critic(states) - returns) ** 2
            c_loss = self._step("critic", self.critic_loss_factor * (se * maskf).sum() / n)
            losses.append(torch.stack([a_loss, c_loss]))
        return torch.stack(losses)

    # -- the sequential tier ----------------------------------------------------

    def act(self, state, reward):
        """state [1, S] -> action [1, A], a draw of the policy; stores the
        step with its log-probability and value, and patches the previous
        step with ``reward`` and this value as its next value."""
        state = state.to(self.device)
        with torch.no_grad():
            mu, sigma = self.actor(state)
            action = D.truncated_normal_sample(mu, sigma, self.generator)
            log_prob = D.truncated_normal_log_pdf(action, mu, sigma)
            value = self.critic(state)[0]
        buf = self.replay_buffer
        if buf.empty():
            buf.new_trajectory()
        if not buf.trajectory_empty():
            buf.update_last(reward=reward, done=False, next_value=value)
        buf.add(PpoEpisodeStep(state[0], action[0], 0.0, False, log_prob[0], value, value))
        self.curr_episode_step += 1
        return action

    def done(self, state, reward):
        with torch.no_grad():
            value = self.critic(state.to(self.device))[0]
        self.replay_buffer.update_last(reward=reward, done=True, next_value=value)
        self._check_train()
        self.replay_buffer.new_trajectory()
        self.global_curr_step += 1
        self.episode_steps_meter.add(float(self.curr_episode_step))
        self.curr_episode_step = 0

    def pack(self, episodes) -> tuple:
        """Trajectories (lists of ``PpoEpisodeStep``) as the padded batch
        ``update`` takes: T is the longest rounded up to a multiple of
        ``PAD``; a padded step is zero with done = 1."""
        dev = self.device
        pad_t = int(math.ceil(max(len(t) for t in episodes) / PAD) * PAD)

        def stack(get):
            rows = [torch.stack([get(s) for s in traj]) for traj in episodes]
            out = torch.zeros((len(episodes), pad_t, rows[0].shape[-1]), device=dev)
            for i, r in enumerate(rows):
                out[i, : r.shape[0]] = r
            return out

        rewards = np.zeros((len(episodes), pad_t, 1), np.float32)
        dones = np.ones((len(episodes), pad_t, 1), np.float32)  # pad = done
        for i, traj in enumerate(episodes):
            for t, step in enumerate(traj):
                rewards[i, t, 0] = step.reward
                dones[i, t, 0] = 1.0 if step.done else 0.0
        return (stack(lambda s: s.state), stack(lambda s: s.action),
                torch.as_tensor(rewards, device=dev), torch.as_tensor(dones, device=dev),
                stack(lambda s: s.log_prob), stack(lambda s: s.value),
                stack(lambda s: s.next_value))

    def _check_train(self):
        if not (self.global_curr_step % self.train_every == self.train_every - 1
                and self.replay_buffer.enough_trajectory(self.batch_size)):
            return
        losses = self.update(self.pack(self.replay_buffer.sample(self.batch_size)))
        for al, cl in losses.tolist():
            self.actor_loss_meter.add(al)
            self.critic_loss_meter.add(cl)
        self.curr_train_step += 1

    def get_metrics(self):
        return [self.actor_loss_meter, self.critic_loss_meter, self.episode_steps_meter]

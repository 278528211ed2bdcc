"""Single-step-buffer PPO, no GAE, no mask (port of
``evomotion_tpu/agents/ppo_vanilla.py``).

Reference: evo_motion_networks/src/agents/ppo_vanilla.cpp. One-step
advantage r + gamma(1-d)V(s') - V(s), normalized (unbiased std); the "old"
log-prob recomputed from the current actor at train start
(ppo_vanilla.cpp:88-90); train_every = batch_size, and the buffer holds
exactly batch_size steps; ``epoch`` epochs, each a clipped-surrogate +
entropy actor step then a critic step on MSE to target = advantages +
V(s). Plain Adam, no clip.

The buffer holds ``batch_size`` steps and sampling needs one more than
the batch (``ReplayBuffer.has_enough`` leaves out the newest step), so the
sequential agent, as the JAX agent, never reaches an update; the batched
trainer (``train.onpolicy_step_batched``) trains on whole rollout blocks.

The critic's first epoch has a gradient that is zero in exact arithmetic:
v - target = -advantages, which sum to zero, so the output bias's gradient
(and the last LayerNorm bias's) is f32 noise that Adam's first step turns
into up to lr either way (ROADMAP Queue C trap 11).
"""

from __future__ import annotations

import torch

from ..buffers.replay import ReplayBuffer
from ..networks import distributions as D
from ..train.metrics import LossMeter
from .base import ACTOR_CRITIC, StepBufferAgent, init_actor_critic


class PpoVanillaAgent(StepBufferAgent):
    SAVE = CARRY = ACTOR_CRITIC

    def __init__(
        self, seed, state_space, action_space, hidden_size, gamma, epsilon, entropy_factor,
        critic_loss_factor, epoch, batch_size, learning_rate, device=None,
    ):
        init_actor_critic(self, seed, state_space, action_space, hidden_size, learning_rate,
                          device)
        self.gamma, self.epsilon = gamma, epsilon
        self.entropy_factor, self.critic_loss_factor = entropy_factor, critic_loss_factor
        self.epoch, self.batch_size = epoch, batch_size
        self.train_every = batch_size  # ppo_vanilla.cpp:27
        self.replay_buffer = ReplayBuffer(batch_size, seed)
        self.curr_train_step = 0
        self.curr_episode_step = 0
        self.global_curr_step = 0
        self.actor_loss_meter = LossMeter("actor_loss", 64)
        self.critic_loss_meter = LossMeter("critic_loss", 64)
        self.episode_steps_meter = LossMeter("steps", 64)

    def update(self, batch) -> torch.Tensor:
        """``epoch`` epochs on ``batch`` = (states [B, S], actions [B, A],
        rewards [B, 1], dones [B, 1], next_states [B, S]), in place. Returns
        each epoch's actor and critic loss, [epoch, 2]."""
        states, actions, rewards, dones, next_states = batch
        eps = self.epsilon
        with torch.no_grad():
            curr_values = self.critic(states)
            next_values = self.critic(next_states)
            advantages = rewards + (1.0 - dones) * self.gamma * next_values - curr_values
            advantages = (advantages - advantages.mean()) / (advantages.std() + 1e-8)
            target = advantages + curr_values
            old_mu, old_sigma = self.actor(states)
            old_log_prob = D.truncated_normal_log_pdf(actions, old_mu, old_sigma)
        losses = []
        for _ in range(self.epoch):
            mu, sigma = self.actor(states)
            log_prob = D.truncated_normal_log_pdf(actions, mu, sigma)
            entropy = D.truncated_normal_entropy(mu, sigma)
            ratios = torch.exp(log_prob - old_log_prob)
            s1 = ratios * advantages
            s2 = torch.clamp(ratios, 1.0 - eps, 1.0 + eps) * advantages
            a_loss = self._step("actor", -(torch.minimum(s1, s2)
                                           + self.entropy_factor * entropy).sum(-1).mean())
            value = self.critic(states)
            c_loss = self._step("critic",
                                self.critic_loss_factor * ((value - target) ** 2).mean())
            losses.append(torch.stack([a_loss, c_loss]))
        return torch.stack(losses)

    def _check_train(self):
        if not (self.global_curr_step % self.train_every == self.train_every - 1
                and self.replay_buffer.has_enough(self.batch_size)):
            return
        losses = self.update(self._batch(self.replay_buffer.sample(self.batch_size)))
        for al, cl in losses.tolist():
            self.actor_loss_meter.add(al)
            self.critic_loss_meter.add(cl)
        self.curr_train_step += 1

    def get_metrics(self):
        return [self.actor_loss_meter, self.critic_loss_meter, self.episode_steps_meter]

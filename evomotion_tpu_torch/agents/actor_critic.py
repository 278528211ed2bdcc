"""A2C-style TD actor-critic (port of ``evomotion_tpu/agents/actor_critic.py``).

Reference: evo_motion_networks/src/agents/actor_critic.cpp. Critic target =
batch-normalized reward (unbiased std) + gamma(1-d)V(s'), the critic
stepped first; policy loss = log_prob * TD-advantage with a decayed entropy
bonus (``exponential_decrease`` on the agent's train steps). The
reference's advantage is unsqueezed to [B,1,1] against log_prob [B,A],
which broadcasts to an outer-product [B,B,A] weighting
(actor_critic.cpp:104-107): replicated as it is, since the training
dynamics are part of the behavioral contract. Plain Adam, no clip.

PyTorch idiom in place of the JAX carry: the agent owns its modules and
their ``torch.optim.Adam`` optimizers, which ``update`` changes in place,
and a ``torch.Generator`` on its device for the policy's draws.
Checkpoints and ``carry_tree`` follow the JAX agent's components
(``agents.base.ComponentAgent``).
"""

from __future__ import annotations

import torch

from ..buffers.replay import ReplayBuffer
from ..networks import distributions as D
from ..train.metrics import LossMeter
from .base import ACTOR_CRITIC, StepBufferAgent, init_actor_critic


class ActorCriticAgent(StepBufferAgent):
    SAVE = CARRY = ACTOR_CRITIC

    def __init__(
        self, seed, state_space, action_space, hidden_size, batch_size, learning_rate, gamma,
        entropy_start_factor, entropy_end_factor, entropy_steps, replay_buffer_size,
        train_every, device=None, unfolding_steps=None,
    ):
        # unfolding_steps: liquid networks (agents.liquid_agents)
        init_actor_critic(self, seed, state_space, action_space, hidden_size, learning_rate,
                          device, unfolding_steps)
        self.gamma = gamma
        self.entropy_start_factor = entropy_start_factor
        self.entropy_end_factor = entropy_end_factor
        self.entropy_steps = entropy_steps
        self.batch_size, self.train_every = batch_size, train_every
        self.replay_buffer = ReplayBuffer(replay_buffer_size, seed)
        self.curr_train_step = 0
        self.curr_episode_step = 0
        self.global_curr_step = 0
        self.policy_loss_meter = LossMeter("policy", 64)
        self.entropy_meter = LossMeter("entropy", 64)
        self.critic_loss_meter = LossMeter("critic", 64)
        self.episode_steps_meter = LossMeter("steps", 64)

    def update(self, batch, entropy_factor) -> torch.Tensor:
        """One update on ``batch`` = (states [B, S], actions [B, A], rewards
        [B, 1], dones [B, 1], next_states [B, S]) with the entropy bonus
        scaled by ``entropy_factor``, in place. Returns the policy and
        entropy metrics and the critic loss as one tensor [3]."""
        states, actions, rewards, dones, next_states = batch
        with torch.no_grad():
            next_value = self.critic(next_states)
            norm_reward = (rewards - rewards.mean()) / (rewards.std() + 1e-8)
            target = norm_reward + (1.0 - dones) * self.gamma * next_value
        value = self.critic(states)
        c_loss = self._step("critic", ((value - target) ** 2).mean())
        advantage = (target - value.detach())[..., None]  # [B, 1, 1]

        mu, sigma = self.actor(states)
        log_prob = D.truncated_normal_log_pdf(actions, mu, sigma)
        policy_entropy = D.truncated_normal_entropy(mu, sigma) * entropy_factor
        # reference broadcast quirk: [B, A] * [B, 1, 1] -> [B, B, A]
        policy_loss = log_prob * advantage
        self._step("actor", -(policy_loss + policy_entropy).sum(-1).mean())
        return torch.stack([-policy_loss.detach().sum(-1).mean(),
                            -policy_entropy.detach().sum(-1).mean(), c_loss])

    def entropy_factor(self) -> float:
        """The entropy bonus's factor at the agent's current train step."""
        return float(D.exponential_decrease(self.curr_train_step, self.entropy_steps,
                                            self.entropy_start_factor, self.entropy_end_factor))

    def _check_train(self):
        if not (self.global_curr_step % self.train_every == self.train_every - 1
                and self.replay_buffer.has_enough(self.batch_size)):
            return
        batch = self._batch(self.replay_buffer.sample(self.batch_size))
        pm, em, cl = self.update(batch, self.entropy_factor()).tolist()
        self.policy_loss_meter.add(pm)
        self.entropy_meter.add(em)
        self.critic_loss_meter.add(cl)
        self.curr_train_step += 1

    def get_metrics(self):
        return [self.policy_loss_meter, self.entropy_meter, self.critic_loss_meter,
                self.episode_steps_meter]

"""CrossQ: SAC without target networks, BatchRenorm critics, joint-batch trick
(port of ``evomotion_tpu/agents/cross_q.py``).

Reference: evo_motion_networks/src/agents/cross_q.cpp. Critics are
BatchNormQNetworkModule (BatchRenorm between all layers incl. input); the
joint-batch trick concatenates (s,a) with (s',a') into ONE training-mode
forward so the BN statistics cover both distributions, then chunks
(cross_q.cpp:52-65). The actor update runs the critics in eval mode (:93-98).
Adam beta1 = 0.5 everywhere (:19-28).

BatchRenorm updates its running statistics in place on every
training-mode forward. The JAX update runs each critic's training-mode
forward twice on the same inputs and state (once for the target, whose new
state it drops, once for the loss), so both give the same q, next-q and new
state; here each critic runs it once per update and both uses read it.
"""

from __future__ import annotations

import torch

from ..device import resolve
from ..networks.modules import Actor, BatchNormQNetwork
from .soft_actor_critic import Entropy, OffPolicyAgent


class CrossQAgent(OffPolicyAgent):
    SAVE = ("actor", "actor_optimizer", "critic_1", "critic_1_state", "critic_1_optimizer",
            "critic_2", "critic_2_state", "critic_2_optimizer", "entropy", "entropy_optimizer")
    CARRY = ("actor", "actor_optimizer", "critic_1", "critic_1_state", "critic_1_optimizer",
             "critic_2", "critic_2_state", "critic_2_optimizer", "entropy", "entropy_optimizer")

    def __init__(
        self, seed, state_space, action_space, actor_hidden_size, critic_hidden_size,
        batch_size, epoch, learning_rate, gamma, replay_buffer_size, train_every,
        grad_norm_clip=None, device=None,
    ):
        # grad_norm_clip: OPTIONAL training-stability knob with no reference
        # counterpart (the reference clips only its PPO agents); the JAX
        # package's r4 CrossQ walker run diverged without one (critic loss
        # 9.2 -> NaN within 2 events, runs/walk_r4_crossq_s1234/curve.csv it
        # 3880-3920). None keeps the reference behavior.
        self.device = resolve(device)
        gen = torch.Generator().manual_seed(seed)
        self.actor = Actor(state_space, action_space, actor_hidden_size, gen).to(self.device)
        self.critic_1 = BatchNormQNetwork(state_space, action_space, critic_hidden_size, gen).to(
            self.device)
        self.critic_2 = BatchNormQNetwork(state_space, action_space, critic_hidden_size, gen).to(
            self.device)
        self.entropy = Entropy().to(self.device)
        self.gamma = gamma
        self._setup(seed, action_space, batch_size, epoch, learning_rate, replay_buffer_size,
                    train_every, grad_norm_clip, betas=(0.5, 0.999))

    def update(self, batch, u_next=None, u_curr=None):
        states, actions, rewards, dones, next_states = batch
        u_next, u_curr = self._draws(states.shape[0], u_next, u_curr)
        alpha = self.entropy.log_alpha.detach().exp()
        next_action, next_log_proba = self._next_action(next_states, u_next)
        cat_states = torch.cat([states, next_states], 0)
        cat_actions = torch.cat([actions, next_action], 0)
        # one training-mode forward per critic over the joint batch: the
        # loss's q, the target's next-q, and the running statistics stepped
        # once (see the module docstring)
        q1, nq1 = self.critic_1(cat_states, cat_actions).chunk(2, 0)
        q2, nq2 = self.critic_2(cat_states, cat_actions).chunk(2, 0)
        with torch.no_grad():
            target_v = torch.minimum(nq1, nq2) - alpha * next_log_proba
            target_q = rewards + (1.0 - dones) * self.gamma * target_v
        c1_loss = self._step("critic_1", ((q1 - target_q) ** 2).mean())
        c2_loss = self._step("critic_2", ((q2 - target_q) ** 2).mean())

        def q_eval(a):  # the updated critics in eval mode (cross_q.cpp:93-98)
            return torch.minimum(self.critic_1(states, a), self.critic_2(states, a))

        self.critic_1.eval()
        self.critic_2.eval()
        try:
            a_loss, e_loss = self._actor_and_temperature(self.actor(states), u_curr, alpha,
                                                             q_eval)
        finally:
            self.critic_1.train()
            self.critic_2.train()
        return torch.stack([a_loss, c1_loss, c2_loss, e_loss])

    def set_eval(self, eval_mode):
        pass  # train/eval is handled explicitly inside the update

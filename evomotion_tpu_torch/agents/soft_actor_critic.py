"""Soft Actor-Critic with twin Q + twin target Q and a learned temperature
(port of ``evomotion_tpu/agents/soft_actor_critic.py``).

Reference: evo_motion_networks/src/agents/soft_actor_critic.cpp. Target nets
hard-copied at init (:41-42); target entropy = -action_dim (:31); per epoch a
fresh batch; target y = r + gamma(1-d)[min(Qbar1,Qbar2) - alpha*logpi(a')]
(:98-116); two critic MSE updates; actor loss E[alpha*logpi - min(Q1,Q2)]
through the *updated* critics (:135-149); alpha loss
-E[log_alpha * (logpi + H_target)] (:152-157); Polyak tau soft-update.

PyTorch idiom in place of the JAX carry: the agent owns its modules and
their ``torch.optim.Adam`` optimizers, which ``update`` changes in place,
and a ``torch.Generator`` on the agent's device in place of the PRNG key.
Each loss is differentiated with ``torch.autograd.grad`` over the
parameters its optimizer steps, so the actor loss leaves no gradient on the
critics. Weights are drawn from a CPU generator seeded with ``seed``
(actor, critic 1, critic 2: the same weights on every device); JAX's own
init cannot be replayed, so the tests carry JAX's weights across.

:class:`OffPolicyAgent` holds what SAC and CrossQ share beyond
``agents.base.StepBufferAgent`` (the sequential ``act``/``done``
bookkeeping, checkpoints and ``carry_tree`` in the JAX key scheme and
carry layout): the ``train_every``/``epoch`` cadence, the meters, the
uniforms of an update, and ``snapshot``/``restore`` for the nan guard.
Adam is laid out as optax lays out ``adam``, or ``chain(
clip_by_global_norm, adam)`` when ``grad_norm_clip`` is set.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from ..buffers.replay import ReplayBuffer
from ..convert import adam_tree, load_adam
from ..device import resolve
from ..networks import distributions as D
from ..networks.modules import Actor, QNetwork, soft_update
from ..train.metrics import LossMeter
from .base import StepBufferAgent


class Entropy(nn.Module):
    """EntropyParameter(1.f, 1): the temperature as ``log_alpha`` [1], 0 at
    init (alpha = 1)."""

    def __init__(self):
        super().__init__()
        self.log_alpha = nn.Parameter(torch.zeros(1))


class OffPolicyAgent(StepBufferAgent):
    """Shared body of :class:`SoftActorCriticAgent` and ``CrossQAgent``.

    A subclass builds ``actor``, ``critic_1``, ``critic_2`` and ``entropy``
    (and anything else its update needs), calls :meth:`_setup`, and defines
    ``update`` and the component lists ``SAVE`` and ``CARRY`` (its
    ``_carry()`` order, :class:`~.base.ComponentAgent`)."""

    def _setup(self, seed, action_space, batch_size, epoch, learning_rate, replay_buffer_size,
               train_every, grad_norm_clip, betas=(0.9, 0.999)):
        self.clip = grad_norm_clip
        for name in ("actor", "critic_1", "critic_2", "entropy"):
            module = getattr(self, name)
            opt = torch.optim.Adam(module.parameters(), lr=learning_rate, betas=betas)
            # Adam's state exists from the start (count 0, zero moments), so a
            # snapshot of the agent covers it before the first step too
            load_adam(opt, module, adam_tree(opt, module))
            setattr(self, f"{name}_opt", opt)
        self.target_entropy = -float(action_space)
        self.batch_size, self.epoch, self.train_every = batch_size, epoch, train_every
        self.replay_buffer = ReplayBuffer(replay_buffer_size, seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.curr_episode_step = 0
        self.curr_train_step = 0
        self.global_curr_step = 0
        self.actor_loss_meter = LossMeter("actor", 64)
        self.critic_1_loss_meter = LossMeter("critic_1", 64)
        self.critic_2_loss_meter = LossMeter("critic_2", 64)
        self.entropy_loss_meter = LossMeter("entropy", 64)
        self.episode_steps_meter = LossMeter("steps", 64)
        self.rewards_meter = LossMeter("rewards", 64)

    # -- one update -----------------------------------------------------------

    def _draws(self, b: int, u_next, u_curr):
        a = self.actor.mu.w.shape[0]
        return (self._uniform((b, a)) if u_next is None else u_next,
                self._uniform((b, a)) if u_curr is None else u_curr)

    def _next_action(self, next_states, u_next):
        """a' ~ pi(s') and its log-probability (no gradient)."""
        with torch.no_grad():
            mu, sigma = self.actor(next_states)
            action = D.truncated_normal_sample(mu, sigma, u=u_next)
            return action, D.truncated_normal_log_pdf(action, mu, sigma).sum(-1, keepdim=True)

    def _actor_and_temperature(self, pi, u_curr, alpha, q_fn) -> tuple:
        """The actor step on the policy ``pi`` = (mu, sigma) at the batch's
        states through ``q_fn(action)`` (the updated critics), then the
        temperature step; returns their losses."""
        mu, sigma = pi
        action = D.truncated_normal_sample(mu, sigma, u=u_curr)
        log_proba = D.truncated_normal_log_pdf(action, mu, sigma).sum(-1, keepdim=True)
        a_loss = self._step("actor", (alpha * log_proba - q_fn(action)).mean())
        e_loss = self._step("entropy", -(self.entropy.log_alpha
                                         * (log_proba.detach() + self.target_entropy)).mean())
        return a_loss, e_loss

    def update(self, batch, u_next=None, u_curr=None) -> torch.Tensor:
        """One update on ``batch`` = (states [B, S], actions [B, A], rewards
        [B, 1], dones [B, 1], next_states [B, S]), in place; ``u_next`` and
        ``u_curr`` [B, A] are the truncated-normal uniforms of a' ~ pi(s')
        and of the actor loss's a ~ pi(s) (drawn from the generator where
        not given). Returns the losses (actor, critic 1, critic 2, entropy)
        as one tensor [4] on the device."""
        raise NotImplementedError

    # -- the sequential tier ----------------------------------------------------

    def done(self, state, reward):
        super().done(state, reward)
        self.rewards_meter.add(reward)

    def _check_train(self):
        if not (self.global_curr_step % self.train_every == self.train_every - 1
                and self.replay_buffer.has_enough(self.batch_size)):
            return
        for _ in range(self.epoch):
            batch = self._batch(self.replay_buffer.sample(self.batch_size))
            a, c1, c2, e = self.update(batch).tolist()  # the meters: one read per update
            self.actor_loss_meter.add(a)
            self.critic_1_loss_meter.add(c1)
            self.critic_2_loss_meter.add(c2)
            self.entropy_loss_meter.add(e)
            self.curr_train_step += 1

    # -- state ---------------------------------------------------------------

    def tensors(self) -> list[torch.Tensor]:
        """Every tensor an update changes: parameters and buffers of every
        component, and each Adam state's step and moments."""
        out = []
        for c in self.SAVE:
            kind, module, opt = self._parts(c)
            if kind == "optimizer":
                out += [t for p in module.parameters() for t in opt.state[p].values()]
            elif kind == "params":
                out += list(module.parameters()) + list(module.buffers())
        return out

    @torch.no_grad()
    def snapshot(self) -> list[torch.Tensor]:
        return [t.clone() for t in self.tensors()]

    @torch.no_grad()
    def restore(self, snap) -> None:
        for t, s in zip(self.tensors(), snap):
            t.copy_(s)

    def get_metrics(self):
        return [self.actor_loss_meter, self.critic_1_loss_meter, self.critic_2_loss_meter,
                self.entropy_loss_meter, self.episode_steps_meter, self.rewards_meter]


class SoftActorCriticAgent(OffPolicyAgent):
    SAVE = ("actor", "actor_optimizer", "critic_1", "target_critic_1", "critic_1_optimizer",
            "critic_2", "target_critic_2", "critic_2_optimizer", "entropy", "entropy_optimizer")
    CARRY = ("actor", "actor_optimizer", "critic_1", "critic_1_optimizer", "critic_2",
             "critic_2_optimizer", "target_critic_1", "target_critic_2", "entropy",
             "entropy_optimizer")

    def __init__(
        self, seed, state_space, action_space, actor_hidden_size, critic_hidden_size,
        batch_size, epoch, learning_rate, gamma, tau, replay_buffer_size, train_every,
        grad_norm_clip=None, device=None,
    ):
        # grad_norm_clip: optional stability knob (no reference counterpart;
        # see cross_q.py)
        self.device = resolve(device)
        gen = torch.Generator().manual_seed(seed)
        self.actor = Actor(state_space, action_space, actor_hidden_size, gen).to(self.device)
        self.critic_1 = QNetwork(state_space, action_space, critic_hidden_size, gen).to(
            self.device)
        self.critic_2 = QNetwork(state_space, action_space, critic_hidden_size, gen).to(
            self.device)
        # hard_update at init (soft_actor_critic.cpp:41-42)
        self.target_critic_1 = copy.deepcopy(self.critic_1).requires_grad_(False)
        self.target_critic_2 = copy.deepcopy(self.critic_2).requires_grad_(False)
        self.entropy = Entropy().to(self.device)
        self.gamma, self.tau = gamma, tau
        self._setup(seed, action_space, batch_size, epoch, learning_rate, replay_buffer_size,
                    train_every, grad_norm_clip)

    def update(self, batch, u_next=None, u_curr=None):
        states, actions, rewards, dones, next_states = batch
        u_next, u_curr = self._draws(states.shape[0], u_next, u_curr)
        # alpha is read once, before the temperature step: a constant in the
        # target and the actor loss
        alpha = self.entropy.log_alpha.detach().exp()
        next_action, next_log_proba = self._next_action(next_states, u_next)
        with torch.no_grad():
            target_v = torch.minimum(self.target_critic_1(next_states, next_action),
                                     self.target_critic_2(next_states, next_action))
            target_q = rewards + (1.0 - dones) * self.gamma * (target_v - alpha * next_log_proba)
        c1_loss = self._step("critic_1", ((self.critic_1(states, actions) - target_q) ** 2).mean())
        c2_loss = self._step("critic_2", ((self.critic_2(states, actions) - target_q) ** 2).mean())
        a_loss, e_loss = self._actor_and_temperature(
            self.actor(states), u_curr, alpha,
            lambda a: torch.minimum(self.critic_1(states, a), self.critic_2(states, a)))
        soft_update(self.target_critic_1, self.critic_1, self.tau)
        soft_update(self.target_critic_2, self.critic_2, self.tau)
        return torch.stack([a_loss, c1_loss, c2_loss, e_loss])

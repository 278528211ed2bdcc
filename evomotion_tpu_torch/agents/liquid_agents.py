"""Liquid (LTC-recurrent) agent variants: A2C, PPO-GAE, SAC (port of
``evomotion_tpu/agents/liquid_agents.py``).

Reference: evo_motion_networks/src/agents/{actor_critic_liquid,
ppo_gae_liquid, soft_actor_critic_liquid}.cpp. Shared recipe: every network
is an LTC cell + linear head (``networks.liquid``); ``act`` advances the
agent's hidden states and the replay buffers also store the hidden states
at act time; training replays forward passes from the STORED hidden states
(feedforward given x_t, no sequence backprop); hidden states reset to the
first state on episode end.

Reference quirks preserved:

- liquid A2C's critic target is NOT detached (actor_critic_liquid.cpp:86-90)
  and its log_prob is log(pdf) rather than the fused log-pdf (:95-96); the
  [B,1,1]-vs-[B,A] broadcast gives the non-liquid A2C's outer-product
  weighting, and actor_loss takes a plain mean without sum(-1) (:101);
  rewards are normalized with the unbiased std; the entropy bonus decays
  exponentially over the agent's train steps;
- liquid PPO-GAE stores the pre-step hidden states per step and pads
  trajectories to a multiple of 32 (as the non-liquid PPO-GAE), with
  optax's global-norm clip then Adam;
- liquid SAC's ``act`` advances all five hidden chains, the target critics'
  too, with (obs, action), and the buffer stores each net's state before
  ("in") and after ("out") the step; plain Adam, no clip.

Each agent is its non-liquid counterpart (``actor_critic``, ``ppo_gae``,
``soft_actor_critic``) with liquid networks: the same buffers, cadence,
meters, update uniforms (SAC's ``update(batch, u_next, u_curr)``) and
checkpoints in the JAX agents' component names and layouts.
"""

from __future__ import annotations

import copy

import torch

from ..device import resolve
from ..networks import distributions as D
from ..networks.liquid import LiquidActor, LiquidQNet, first_x
from ..networks.modules import soft_update
from .actor_critic import ActorCriticAgent
from .ppo_gae import PpoGaeAgent
from .soft_actor_critic import Entropy, OffPolicyAgent, SoftActorCriticAgent


class LiquidChains:
    """The hidden states ``x`` {net: [1, n]} of a liquid agent's ``NETS``:
    the first state at init and after ``done``; a step buffer's batch
    carries each stored step's states as two dicts, {net: [B, n]} before
    ("in") and after ("out") its act."""

    NETS: tuple[str, ...] = ()

    def reset_x(self) -> None:
        self.x = {n: first_x(self.neurons, 1, self.device) for n in self.NETS}

    def _batch(self, items):
        """The step batch of liquid buffer items, then their in and out states."""
        xs = [{n: torch.cat([i.x_t[k][n] for i in items]) for n in self.NETS}
              for k in ("in", "out")]
        return (*super()._batch([i.step for i in items]), *xs)

    def done(self, state, reward):
        super().done(state, reward)
        self.reset_x()


class ActorCriticLiquidAgent(LiquidChains, ActorCriticAgent):
    NETS = ("actor", "critic")

    def __init__(
        self, seed, state_space, action_space, neuron_number, batch_size, lr, gamma,
        entropy_start_factor, entropy_end_factor, entropy_steps, unfolding_steps,
        replay_buffer_size, train_every, device=None,
    ):
        super().__init__(seed, state_space, action_space, neuron_number, batch_size, lr, gamma,
                         entropy_start_factor, entropy_end_factor, entropy_steps,
                         replay_buffer_size, train_every, device, unfolding_steps)
        self.neurons = neuron_number
        self.reset_x()

    @torch.no_grad()
    def _policy(self, state):
        x_in = self.x
        mu, sigma, ax = self.actor(x_in["actor"], state)
        action = D.truncated_normal_sample(mu, sigma, u=self._uniform(mu.shape))
        _, cx = self.critic(x_in["critic"], state)
        self.x = {"actor": ax, "critic": cx}
        return action, {"in": x_in, "out": self.x}

    def update(self, batch, entropy_factor) -> torch.Tensor:
        """One update on ``batch`` = (states, actions, rewards, dones,
        next_states, x, next_x) with the stored hidden states x and next_x
        ({net: [B, n]}), in place. Returns the policy and entropy metrics
        and the critic loss as one tensor [3]."""
        states, actions, rewards, dones, next_states, x, next_x = batch
        next_value, _ = self.critic(next_x["critic"], next_states)
        value, _ = self.critic(x["critic"], states)
        norm_reward = (rewards - rewards.mean()) / (rewards.std() + 1e-8)
        # the reference does not detach the target (actor_critic_liquid.cpp:86-90)
        target = norm_reward + (1.0 - dones) * self.gamma * next_value
        c_loss = self._step("critic", ((value - target) ** 2).mean())
        advantage = (target - value).detach()[..., None]  # [B, 1, 1]

        mu, sigma, _ = self.actor(x["actor"], states)
        log_prob = torch.log(D.truncated_normal_pdf(actions, mu, sigma))
        policy_entropy = D.truncated_normal_entropy(mu, sigma) * entropy_factor
        # reference broadcast quirk: [B, A] * [B, 1, 1] -> [B, B, A], plain mean
        policy_loss = log_prob * advantage
        self._step("actor", -(policy_loss + policy_entropy).mean())
        return torch.stack([-policy_loss.detach().sum(-1).mean(),
                            -policy_entropy.detach().sum(-1).mean(), c_loss])


class PpoGaeLiquidAgent(LiquidChains, PpoGaeAgent):
    """PPO-GAE where the per-step stored hidden states replace recurrence
    during training: ``pack`` adds the actor's and the critic's stored
    states [B, T, n] to the padded batch."""

    NETS = ("actor", "critic")

    def __init__(
        self, seed, state_space, action_space, neuron_number, unfolding_steps, gamma, lam,
        epsilon, entropy_factor, critic_loss_factor, epoch, batch_size, train_every,
        replay_buffer_size, learning_rate, clip_grad_norm, device=None,
    ):
        super().__init__(seed, state_space, action_space, neuron_number, gamma, lam, epsilon,
                         entropy_factor, critic_loss_factor, epoch, batch_size, train_every,
                         replay_buffer_size, learning_rate, clip_grad_norm, device,
                         unfolding_steps)
        self.neurons = neuron_number
        self.reset_x()

    def _pi(self, batch):
        mu, sigma, _ = self.actor(batch[7], batch[0])
        return mu, sigma

    def _v(self, batch):
        return self.critic(batch[8], batch[0])[0]

    @torch.no_grad()
    def _policy(self, state):
        x_t = {n: x[0] for n, x in self.x.items()}  # the pre-step states
        mu, sigma, ax = self.actor(self.x["actor"], state)
        action = D.truncated_normal_sample(mu, sigma, self.generator)
        log_prob = D.truncated_normal_log_pdf(action, mu, sigma)
        value, cx = self.critic(self.x["critic"], state)
        self.x = {"actor": ax, "critic": cx}
        return action, log_prob, value[0], x_t

    @torch.no_grad()
    def _value(self, state):
        value, self.x["critic"] = self.critic(self.x["critic"], state)
        return value[0]

    def pack(self, episodes) -> tuple:
        """The padded batch of :meth:`PpoGaeAgent.pack`, then the stored
        actor and critic states [B, T, n] (zero past each end)."""
        batch = super().pack([[i.step for i in traj] for traj in episodes])
        pad_t = batch[0].shape[1]
        return (*batch, *(self._stack(episodes, lambda i, n=n: i.x_t[n], pad_t)
                          for n in self.NETS))


class SoftActorCriticLiquidAgent(LiquidChains, OffPolicyAgent):
    """SAC over a liquid actor and liquid twin Q (+ liquid twin target Q);
    all five hidden states stored per step."""

    NETS = ("actor", "critic_1", "critic_2", "target_critic_1", "target_critic_2")
    SAVE = SoftActorCriticAgent.SAVE
    CARRY = SoftActorCriticAgent.CARRY

    def __init__(
        self, seed, state_space, action_space, neuron_number, batch_size, epoch,
        learning_rate, gamma, tau, unfolding_steps, replay_buffer_size, train_every,
        device=None,
    ):
        self.device = resolve(device)
        gen = torch.Generator().manual_seed(seed)
        self.actor = LiquidActor(state_space, action_space, neuron_number, unfolding_steps,
                                 gen).to(self.device)
        self.critic_1 = LiquidQNet(state_space, action_space, neuron_number, unfolding_steps,
                                   gen).to(self.device)
        self.critic_2 = LiquidQNet(state_space, action_space, neuron_number, unfolding_steps,
                                   gen).to(self.device)
        self.target_critic_1 = copy.deepcopy(self.critic_1).requires_grad_(False)
        self.target_critic_2 = copy.deepcopy(self.critic_2).requires_grad_(False)
        self.entropy = Entropy().to(self.device)
        self.gamma, self.tau = gamma, tau
        self._setup(seed, action_space, batch_size, epoch, learning_rate, replay_buffer_size,
                    train_every, None)
        self.neurons = neuron_number
        self.reset_x()

    @torch.no_grad()
    def advance(self, x, state, generator=None, u=None):
        """A draw of the policy at ``state`` [B, S] from hidden states ``x``
        ({net: [B, n]}; uniforms ``u`` [B, A] where given, else from
        ``generator``), and the five nets' new hidden states: all five
        chains advance with (obs, action), stateful inference."""
        mu, sigma, ax = self.actor(x["actor"], state)
        action = D.truncated_normal_sample(mu, sigma, generator, u)
        return action, {"actor": ax, **{n: getattr(self, n)(x[n], state, action)[1]
                                        for n in self.NETS[1:]}}

    def _policy(self, state):
        x_in = self.x
        action, self.x = self.advance(x_in, state, self.generator)
        return action, {"in": x_in, "out": self.x}

    def update(self, batch, u_next=None, u_curr=None):
        """One update on ``batch`` = (states, actions, rewards, dones,
        next_states, x, next_x) with the stored hidden states x and next_x
        ({net: [B, n]}), in place; ``u_next`` and ``u_curr`` as
        :meth:`OffPolicyAgent.update`. Returns the losses (actor, critic 1,
        critic 2, entropy) as one tensor [4]."""
        states, actions, rewards, dones, next_states, x, nx = batch
        u_next, u_curr = self._draws(states.shape[0], u_next, u_curr)
        alpha = self.entropy.log_alpha.detach().exp()
        with torch.no_grad():
            mu, sigma, _ = self.actor(nx["actor"], next_states)
            next_action = D.truncated_normal_sample(mu, sigma, u=u_next)
            next_log_proba = D.truncated_normal_log_pdf(next_action, mu, sigma).sum(
                -1, keepdim=True)
            target_v = torch.minimum(
                self.target_critic_1(nx["target_critic_1"], next_states, next_action)[0],
                self.target_critic_2(nx["target_critic_2"], next_states, next_action)[0])
            target_q = rewards + (1.0 - dones) * self.gamma * (target_v - alpha * next_log_proba)

        def q(name, a):
            return getattr(self, name)(x[name], states, a)[0]

        c1_loss = self._step("critic_1", ((q("critic_1", actions) - target_q) ** 2).mean())
        c2_loss = self._step("critic_2", ((q("critic_2", actions) - target_q) ** 2).mean())
        a_loss, e_loss = self._actor_and_temperature(
            self.actor(x["actor"], states)[:2], u_curr, alpha,
            lambda a: torch.minimum(q("critic_1", a), q("critic_2", a)))
        soft_update(self.target_critic_1, self.critic_1, self.tau)
        soft_update(self.target_critic_2, self.critic_2, self.tau)
        return torch.stack([a_loss, c1_loss, c2_loss, e_loss])

    def get_metrics(self):
        return super().get_metrics()[:5]  # the JAX agent keeps no rewards meter

"""Agent interface of the sequential tier (port of ``evomotion_tpu/agents/base.py``).

Reference: evo_motion_networks/include/evo_motion_networks/agent.h:16-36.
``act(state, reward) -> action`` and ``done(state, reward)`` carry the
reference's one-step-late reward bookkeeping. States and actions are batch
first, as the port's envs give and take them: the sequential tier is a batch
of one (``state [1, obs]`` -> ``action [1, act]``).

What the port's learning agents share: :class:`ComponentAgent` (one Adam
step of a module, checkpoints and the JAX carry by component),
:class:`StepBufferAgent` (``act``/``done`` over a step replay buffer: A2C,
PPO-vanilla, SAC, CrossQ and the liquid A2C and SAC) and
:func:`init_actor_critic` (the on-policy agents' networks and optimizers,
liquid or not).
"""

from __future__ import annotations

import abc

import torch

from ..buffers.replay import EpisodeStep, LiquidEpisodeStep
from ..convert import adam_tree, load_adam, load_params, load_state, params_tree, state_tree
from ..device import resolve
from ..networks import distributions as D
from ..networks.liquid import LiquidActor, LiquidCritic
from ..networks.modules import Actor, Critic
from ..train.checkpoint import load_component, save_component
from ..train.ppo_batched import clip_by_global_norm_


class Agent(abc.ABC):
    @abc.abstractmethod
    def act(self, state: torch.Tensor, reward: float) -> torch.Tensor: ...

    @abc.abstractmethod
    def done(self, state: torch.Tensor, reward: float) -> None: ...

    @abc.abstractmethod
    def save(self, output_folder_path: str) -> None: ...

    @abc.abstractmethod
    def load(self, input_folder_path: str) -> None: ...

    @abc.abstractmethod
    def get_metrics(self) -> list: ...

    @abc.abstractmethod
    def set_eval(self, eval_mode: bool) -> None: ...

    @abc.abstractmethod
    def count_parameters(self) -> int: ...


class ComponentAgent(Agent):
    """An agent made of named components, checkpointed one ``<component>.npz``
    each in the JAX key scheme (``train.checkpoint``).

    A subclass lists its components in ``SAVE`` (the JAX agent's save order)
    and ``CARRY`` (the order of the JAX agent's carry tuple). A component
    name ending in ``_optimizer`` is the ``torch.optim.Adam`` state (the
    attribute ``<module>_opt``) of the module it prefixes, laid out as optax
    lays out ``adam``, or ``chain(clip_by_global_norm, adam)`` when ``clip``
    is set; one ending in ``_state`` the module's buffers; any other a
    module's parameters. ``carry_tree`` gives the JAX carry as numpy
    pytrees, ``load_carry_tree`` reads it back."""

    SAVE: tuple[str, ...] = ()
    CARRY: tuple[str, ...] = ()
    clip = None  # global-norm gradient clip of every optimizer, or None

    def _step(self, name: str, loss: torch.Tensor) -> torch.Tensor:
        """One Adam step of module ``name`` on ``loss`` (clipped by optax's
        rule when ``clip`` is set); returns the loss, detached."""
        params = list(getattr(self, name).parameters())
        for p, g in zip(params, torch.autograd.grad(loss, params)):
            p.grad = g
        if self.clip is not None:
            clip_by_global_norm_(params, self.clip)
        getattr(self, f"{name}_opt").step()
        for p in params:
            p.grad = None
        return loss.detach()

    def _parts(self, component: str):
        """(kind, module, optimizer) of a component: kind ``optimizer``,
        ``state`` or ``params``."""
        for kind in ("optimizer", "state"):
            if component.endswith(f"_{kind}"):
                name = component[: -len(kind) - 1]
                return kind, getattr(self, name), getattr(self, f"{name}_opt", None)
        return "params", getattr(self, component), None

    def tree(self, component: str):
        """``component`` as the JAX agent's pytree (numpy arrays)."""
        kind, module, opt = self._parts(component)
        if kind == "optimizer":
            return adam_tree(opt, module, clip=self.clip is not None)
        return state_tree(module) if kind == "state" else params_tree(module)

    def load_tree(self, component: str, tree) -> None:
        kind, module, opt = self._parts(component)
        if kind == "optimizer":
            load_adam(opt, module, tree)
        elif kind == "state":
            load_state(module, tree)
        else:
            load_params(module, tree)

    def carry_tree(self) -> tuple:
        """The JAX agent's carry, as numpy pytrees."""
        return tuple(self.tree(c) for c in self.CARRY)

    def load_carry_tree(self, carry) -> None:
        for c, tree in zip(self.CARRY, carry):
            self.load_tree(c, tree)

    def save(self, folder):
        for c in self.SAVE:
            save_component(folder, c, self.tree(c))

    def load(self, folder):
        for c in self.SAVE:
            self.load_tree(c, load_component(folder, c, self.tree(c)))

    def set_eval(self, eval_mode):
        pass

    def count_parameters(self):
        return sum(sum(p.numel() for p in module.parameters())
                   for kind, module, _ in map(self._parts, self.SAVE) if kind == "params")


class StepBufferAgent(ComponentAgent):
    """The sequential ``act``/``done`` of the agents that learn from a step
    replay buffer (A2C, PPO-vanilla, SAC, CrossQ): the reference's
    one-step-late reward (``buffers.replay``), a policy draw per act from
    the agent's ``generator``, and ``_check_train`` after each stored step.
    A subclass sets ``actor``, ``device``, ``generator``, ``replay_buffer``,
    ``episode_steps_meter`` and the step counters."""

    def _uniform(self, shape) -> torch.Tensor:
        return torch.rand(shape, generator=self.generator, device=self.device)

    def _policy(self, state):
        """(action [1, A], a draw of the policy at ``state`` [1, S]; the
        hidden states a liquid agent stores with the step, else None)."""
        with torch.no_grad():
            mu, sigma = self.actor(state)
            return D.truncated_normal_sample(mu, sigma, u=self._uniform(mu.shape)), None

    def act(self, state, reward):
        """state [1, S] -> action [1, A], a draw of the policy; stores the
        transition and patches the previous one with ``reward``."""
        state = state.to(self.device)
        action, x_t = self._policy(state)
        s = state[0]
        if not self.replay_buffer.empty():
            self.replay_buffer.update_last(reward=reward, next_state=s, done=False)
        step = EpisodeStep(s, action[0], 0.0, False, s)
        self.replay_buffer.add(step if x_t is None else LiquidEpisodeStep(step, x_t))
        self._check_train()
        self.curr_episode_step += 1
        self.global_curr_step += 1
        return action

    def done(self, state, reward):
        self.replay_buffer.update_last(reward=reward, next_state=state.to(self.device)[0],
                                       done=True)
        self.episode_steps_meter.add(float(self.curr_episode_step))
        self.curr_episode_step = 0

    def _check_train(self):
        raise NotImplementedError

    def _batch(self, steps):
        """(states [B, S], actions [B, A], rewards [B, 1], dones [B, 1],
        next_states [B, S]) of buffer steps, on the agent's device."""
        def col(xs):
            return torch.tensor(xs, dtype=torch.float32, device=self.device)[:, None]

        return (torch.stack([s.state for s in steps]), torch.stack([s.action for s in steps]),
                col([s.reward for s in steps]), col([1.0 if s.done else 0.0 for s in steps]),
                torch.stack([s.next_state for s in steps]))


# the components of the on-policy agents, in the JAX agents' save order and
# carry order alike: (actor_params, actor_opt_state, critic_params,
# critic_opt_state)
ACTOR_CRITIC = ("actor", "actor_optimizer", "critic", "critic_optimizer")


def init_actor_critic(agent, seed: int, state_space: int, action_space: int, hidden_size: int,
                      learning_rate: float, device, unfolding_steps: int | None = None) -> None:
    """Gives ``agent`` its ``device``, an ``actor`` and a ``critic`` (weights
    drawn from a CPU generator seeded with ``seed``, actor first: the same
    weights on every device), their ``torch.optim.Adam`` optimizers
    ``actor_opt`` and ``critic_opt`` (optax's ``adam`` with its defaults),
    and a ``generator`` on the device seeded with ``seed``. With
    ``unfolding_steps`` the networks are the liquid ones
    (``networks.liquid``), ``hidden_size`` their cells' neuron count."""
    agent.device = dev = resolve(device)
    gen = torch.Generator().manual_seed(seed)
    if unfolding_steps is None:
        agent.actor = Actor(state_space, action_space, hidden_size, gen).to(dev)
        agent.critic = Critic(state_space, hidden_size, gen).to(dev)
    else:
        agent.actor = LiquidActor(state_space, action_space, hidden_size, unfolding_steps,
                                  gen).to(dev)
        agent.critic = LiquidCritic(state_space, hidden_size, unfolding_steps, gen).to(dev)
    agent.actor_opt = torch.optim.Adam(agent.actor.parameters(), lr=learning_rate)
    agent.critic_opt = torch.optim.Adam(agent.critic.parameters(), lr=learning_rate)
    agent.generator = torch.Generator(device=dev).manual_seed(seed)

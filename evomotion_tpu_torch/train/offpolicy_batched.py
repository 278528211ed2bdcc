"""Batched off-policy trainers, SAC and CrossQ, with a device ring buffer
(port of ``evomotion_tpu/train/offpolicy_batched.py``).

Reference counterpart: the sequential train loop (src/train.cpp:17-87) with
SoftActorCriticAgent (soft_actor_critic.cpp:16-251) or CrossQAgent
(cross_q.cpp:9-239), which trains ``epoch`` sampled batches every
``train_every`` env steps. As in the JAX package, N envs advance in
lockstep, transitions land in a PREALLOCATED RING on the env's device, and
one iteration = [T-step rollout] + [ring write] + [updates].

The update math is the sequential agents' own ``update``
(``agents.soft_actor_critic``, ``agents.cross_q``): one source of truth for
the losses, clamps, Adam betas and Polyak updates. The train state holds
such an agent, whose modules and optimizers the updates change in place.

Cadence: ``updates_per_iter = max(1, steps_per_iter // train_every)`` train
events per iteration, each ``epoch`` updates (not scaled by N: the env batch
is one time stream, as in the JAX package).

Sampling: uniform over the valid ring entries by inverse CDF
(``torch.searchsorted`` on the cumulative 0/1 weights, JAX's
``side="left"``), with the newest written slot excluded (the reference's
newest-excluded quirk, replay_buffer.cpp:50-52). A transition is trainable
iff both its input observation and its result are valid episode frames, so
settle frames are never sampled. The weights are 0/1 and the ring holds at
most 2^24 entries, so the f32 cumulative sum is exact and the same uniforms
pick the same indices as in the JAX package.

Random draws come from the state's ``torch.Generator`` (on the env's
device), or from a :class:`Draws` the caller passes (the tests pass JAX's).
Host reads: ``has_enough`` once per iteration; with ``nan_guard``, one per
update (see ``train_step_fn``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from ..agents.cross_q import CrossQAgent
from ..agents.liquid_agents import SoftActorCriticLiquidAgent
from ..agents.soft_actor_critic import SoftActorCriticAgent
from ..networks import distributions as D
from ..networks.liquid import first_x
from .checkpoint import load_component, save_component


@dataclasses.dataclass(frozen=True)
class OffPolicyConfig:
    actor_hidden_size: int = 256
    critic_hidden_size: int = 256
    batch_size: int = 256
    epoch: int = 1
    learning_rate: float = 3e-4
    gamma: float = 0.99
    tau: float = 0.005  # SAC only
    train_every: int = 1
    steps_per_iter: int = 64  # rollout length T per train iteration
    n_envs: int = 1024
    buffer_capacity: int = 262144  # rounded up to a multiple of T*N
    # optional stability knobs (no reference counterpart; the JAX package's
    # r4 CrossQ walker diverged at ~64M steps, see agents/cross_q.py):
    grad_norm_clip: float | None = None
    # skip (not apply) any update whose losses come back non-finite: the
    # agent stays at its last finite state instead of being poisoned
    nan_guard: bool = False


class Ring(NamedTuple):
    """Ring buffer of transitions on the env's device, [CAP, ...]; the
    tensors are written in place."""

    obs: torch.Tensor
    action: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor  # f32
    next_obs: torch.Tensor
    valid: torch.Tensor  # f32: trainable transition
    cursor: int  # next write slot
    filled: int  # entries ever written (capped at CAP)

    @classmethod
    def empty(cls, capacity: int, obs_size: int, action_size: int, device) -> "Ring":
        def z(*shape):
            return torch.zeros((capacity, *shape), device=device)

        return cls(obs=z(obs_size), action=z(action_size), reward=z(), done=z(),
                   next_obs=z(obs_size), valid=z(), cursor=0, filled=0)

    def write(self, block) -> "Ring":
        """Writes ``block`` = (obs, action, reward, done, next_obs, valid),
        each [K, ...], at the cursor (in place; the capacity is a whole
        number of such blocks) and returns the ring with its cursor and
        fill advanced. A field that is a dict of tensors (``LiquidRing``'s
        hidden states) takes a dict of blocks with its keys."""
        cap, k, c = self.obs.shape[0], block[0].shape[0], self.cursor
        for dst, src in zip(self[:-2], block):
            pairs = ((dst[n], src[n]) for n in dst) if isinstance(dst, dict) else [(dst, src)]
            for d, x in pairs:
                d[c:c + k] = x
        return self._replace(cursor=(c + k) % cap, filled=min(self.filled + k, cap))

    def cdf(self):
        """The cumulative sampling weights, the valid entries with the newest
        written slot excluded (replay_buffer.cpp:50-52), and their total."""
        weights = self.valid.clone()
        weights[(self.cursor - 1) % self.obs.shape[0]] = 0.0
        cdf = torch.cumsum(weights, 0)
        return cdf, cdf[-1]

    def sample(self, cdf, total, u):
        """The ring indices that the uniforms ``u`` [B] pick by inverse CDF
        (``cdf`` the cumulative sampling weights, ``total`` their sum) and
        the batch (obs, action, reward [B, 1], done [B, 1], next_obs) there."""
        idx = torch.searchsorted(cdf, u * total)
        return idx, (self.obs[idx], self.action[idx], self.reward[idx][:, None],
                     self.done[idx][:, None], self.next_obs[idx])


@dataclasses.dataclass
class OffPolicyTrainState:
    agent: Any  # SoftActorCriticAgent or CrossQAgent: the JAX state's carry
    ring: Ring
    env_state: Any
    obs: torch.Tensor  # [N, S]
    prev_valid: torch.Tensor  # [N] bool: input-obs validity of the next transition
    generator: torch.Generator  # actions, samples and env resets, on the env's device
    iteration: int
    ep_steps: torch.Tensor  # [N] int32: valid steps in each env's open episode


class OffPolicyMetrics(NamedTuple):
    actor_loss: torch.Tensor
    critic_1_loss: torch.Tensor
    critic_2_loss: torch.Tensor
    entropy_loss: torch.Tensor
    mean_reward: torch.Tensor
    episodes_done: torch.Tensor
    updates_done: torch.Tensor
    # per-episode diagnostics over episodes that ENDED this iteration
    # (reference progress line, train.cpp:67-78)
    mean_ep_len: torch.Tensor
    win_rate: torch.Tensor


class Draws(NamedTuple):
    """The uniforms of one iteration, in place of the generator's: the
    rollout's actions [T, N, A], and for each of the U updates its sample
    [U, B] and its two truncated-normal draws (a' ~ pi(s'), a ~ pi(s))
    [U, B, A] each."""

    rollout: torch.Tensor
    sample: torch.Tensor
    next: torch.Tensor
    curr: torch.Tensor


def guarded_update(agent, batch, u_next, u_curr) -> torch.Tensor:
    """``agent.update`` under the nan guard: when any of its losses is not
    finite, the whole agent is taken back to where it was (a device copy
    made before the update; deciding is one host read) and the losses read
    0."""
    snap = agent.snapshot()
    losses = agent.update(batch, u_next, u_curr)
    if bool(torch.isfinite(losses).all()):
        return losses
    agent.restore(snap)
    return torch.zeros_like(losses)


def rollout(env, actor, state, n_steps: int, uniforms=None):
    """``n_steps`` env steps of ``actor``'s sampled policy (``uniforms``
    [T, N, A] in place of the generator's action draws) from a train state
    with ``env_state``, ``obs``, ``prev_valid``, ``ep_steps`` and
    ``generator``, which it advances in place. Returns the trajectory
    ``(obs, action, reward, done, next_obs, trainable, done_len, win)``,
    each [T, N, ...]: a transition is trainable iff its input observation
    and its result are both valid episode frames."""
    gen = state.generator
    env_state, obs, prev_valid, ep_steps = (state.env_state, state.obs, state.prev_valid,
                                            state.ep_steps)
    steps = []
    with torch.no_grad():
        for t in range(n_steps):
            mu, sigma = actor(obs)
            u = None if uniforms is None else uniforms[t]
            action = D.truncated_normal_sample(mu, sigma, gen, u)
            env_state, res = env.step(env_state, action, gen)
            trainable = prev_valid & res.valid
            grown = ep_steps + res.valid.to(torch.int32)
            ended = res.done & res.valid
            done_len = torch.where(ended, grown, 0)
            ep_steps = torch.where(ended, 0, grown)
            steps.append((obs, action, res.reward, res.done, res.obs, trainable.float(),
                           done_len, res.win & ended))
            obs, prev_valid = res.obs, res.valid
    state.env_state, state.obs, state.prev_valid, state.ep_steps = (
        env_state, obs, prev_valid, ep_steps)
    return tuple(torch.stack(x) for x in zip(*steps))


class BatchedOffPolicy:
    """algo: ``"soft_actor_critic"`` or ``"cross_q"``; ``env`` a batched env
    (``reset(n_envs, generator)``, ``step(state, action, generator)``,
    ``observation_size``, ``action_size``, ``device``)."""

    ALGOS = ("soft_actor_critic", "cross_q")

    def __init__(self, env, algo: str, config: OffPolicyConfig = OffPolicyConfig(),
                 seed: int = 1234):
        if algo not in self.ALGOS:
            raise ValueError(f"unsupported off-policy algo: {algo}")
        self.env = env
        self.algo = algo
        cfg = config
        block = cfg.steps_per_iter * cfg.n_envs
        cap = max(cfg.buffer_capacity, block)
        self.capacity = ((cap + block - 1) // block) * block
        self.config = cfg
        self.seed = seed
        self.updates_per_iter = max(1, cfg.steps_per_iter // cfg.train_every)

    def make_agent(self):
        """A fresh agent (weights from a CPU generator seeded with ``seed``)
        on the env's device."""
        cfg, env = self.config, self.env
        common = dict(replay_buffer_size=1, train_every=cfg.train_every,
                      grad_norm_clip=cfg.grad_norm_clip, device=env.device)
        args = (self.seed, env.observation_size, env.action_size, cfg.actor_hidden_size,
                cfg.critic_hidden_size, cfg.batch_size, cfg.epoch, cfg.learning_rate, cfg.gamma)
        if self.algo == "soft_actor_critic":
            return SoftActorCriticAgent(*args, cfg.tau, **common)
        return CrossQAgent(*args, **common)

    # -- state ----------------------------------------------------------------

    def init(self) -> OffPolicyTrainState:
        """A fresh agent, an empty ring, and ``n_envs`` envs reset with a
        generator on the env's device seeded with ``seed``."""
        cfg = self.config
        dev = self.env.device
        gen = torch.Generator(device=dev).manual_seed(self.seed)
        env_state, first = self.env.reset(cfg.n_envs, gen)
        ring = Ring.empty(self.capacity, self.env.observation_size, self.env.action_size, dev)
        return OffPolicyTrainState(
            agent=self.make_agent(), ring=ring, env_state=env_state, obs=first.obs,
            prev_valid=first.valid.clone(), generator=gen, iteration=0,
            ep_steps=torch.zeros(cfg.n_envs, dtype=torch.int32, device=dev))

    # -- one iteration --------------------------------------------------------

    def rollout(self, state: OffPolicyTrainState, uniforms=None):
        """:func:`rollout` of ``steps_per_iter`` steps with the agent's actor."""
        return rollout(self.env, state.agent.actor, state, self.config.steps_per_iter, uniforms)

    def train_step_fn(self, learn: bool = True, timer=None):
        """``train_step(state, uniforms=None) -> (state, OffPolicyMetrics)``:
        one iteration, the state changed in place. ``uniforms`` is a
        :class:`Draws`. ``learn=False`` builds the ring-REFILL variant: the
        envs advance and transitions land in the ring, but no update runs;
        it repopulates the ring before updates resume from a params-only
        checkpoint (updates onto a nearly-empty ring collapsed the JAX
        package's r4 CrossQ resume). With a ``train.profiling.StepTimer``
        the rollout (with the ring write) and the updates are timed as the
        phases ``rollout`` and ``update``, each ending in a wait for the
        card.

        ``nan_guard`` takes the whole agent back (parameters, Adam states,
        BatchRenorm buffers, target critics) when any loss of an update is
        not finite, and that update's losses read 0, as the JAX trainer's
        ``where``. The optimizers work in place, so each update starts from
        a device copy of the agent, and deciding whether to restore it is
        one host read per update."""
        cfg = self.config
        block = cfg.steps_per_iter * cfg.n_envs
        n_updates = self.updates_per_iter * cfg.epoch
        dev = self.env.device

        def phase(name):
            if timer is None:
                return contextlib.nullcontext()
            return timer.phase(name, block_on=dev)

        def train_step(state: OffPolicyTrainState, uniforms: Draws | None = None):
            def flat(x):  # [T, N, ...] -> [T * N, ...]
                return x.reshape((block,) + x.shape[2:])

            with phase("rollout"):
                traj = self.rollout(state, None if uniforms is None else uniforms.rollout)
                t_obs, t_act, t_rew, t_done, t_next, t_valid = map(flat, traj[:6])
                done_lens, wins = traj[6], traj[7]
                # a liquid rollout's hidden states, {net: [T, N, n]}, follow
                hidden = ({n: flat(x) for n, x in xs.items()} for xs in traj[8:])
                ring = state.ring = state.ring.write(
                    (t_obs, t_act, t_rew, t_done.float(), t_next, t_valid, *hidden))

            losses = torch.zeros((n_updates, 4), device=dev)
            has_enough = False
            with phase("update"):
                if learn:
                    cdf, total = ring.cdf()
                    has_enough = bool(total >= cfg.batch_size)  # one host read
                if has_enough:
                    losses = self._updates(state.agent, ring, cdf, total, uniforms,
                                           state.generator)

            state.iteration += 1
            nv = torch.clamp_min(t_valid.sum(), 1.0)
            n_ended = torch.clamp_min((done_lens > 0).sum(), 1)
            a_l, c1_l, c2_l, e_l = losses.mean(0)
            metrics = OffPolicyMetrics(
                actor_loss=a_l, critic_1_loss=c1_l, critic_2_loss=c2_l, entropy_loss=e_l,
                mean_reward=(t_rew * t_valid).sum() / nv,
                episodes_done=t_done.sum(),
                updates_done=torch.tensor(n_updates if has_enough else 0),
                mean_ep_len=done_lens.sum() / n_ended,
                win_rate=wins.sum() / n_ended,
            )
            return state, metrics

        return train_step

    def _updates(self, agent, ring: Ring, cdf, total, uniforms, gen) -> torch.Tensor:
        """The iteration's updates on batches drawn from the ring; returns
        their losses [U, 4]."""
        cfg = self.config
        b, a, dev = cfg.batch_size, self.env.action_size, self.env.device
        out = []
        for i in range(self.updates_per_iter * cfg.epoch):
            if uniforms is None:
                u = torch.rand(b, generator=gen, device=dev)
                u_next = torch.rand((b, a), generator=gen, device=dev)
                u_curr = torch.rand((b, a), generator=gen, device=dev)
            else:
                u, u_next, u_curr = uniforms.sample[i], uniforms.next[i], uniforms.curr[i]
            _, batch = self.sample(ring, cdf, total, u)
            out.append(guarded_update(agent, batch, u_next, u_curr) if cfg.nan_guard
                       else agent.update(batch, u_next, u_curr))
        return torch.stack(out)

    @staticmethod
    def sample(ring: Ring, cdf, total, u):
        """``ring.sample``: the indices ``u`` picks and the batch there."""
        return ring.sample(cdf, total, u)

    # -- checkpoints (the sequential agent's per-component layout) --------------

    def save(self, folder: str, state: OffPolicyTrainState) -> None:
        state.agent.save(folder)

    def load_carry(self, folder: str):
        """A fresh agent with the components of ``folder`` (written by
        :meth:`save`, by the sequential agent, or by either JAX class)."""
        agent = self.make_agent()
        agent.load(folder)
        return agent

    # -- full-state checkpoints (exact resume incl. the replay ring) -------------

    def save_full(self, folder: str, state: OffPolicyTrainState) -> None:
        """Checkpoints EVERYTHING, one ``train_<field>.npz`` per field of the
        JAX package's train state: the agent as JAX's carry, the ring with
        its cursor, the env batch, obs, validity, the iteration and the
        episode steps, with ``train_generator.npz`` (the generator's state
        bytes) in place of JAX's ``train_key.npz``, so training resumes
        exactly. The ring dominates the size (GBs at the walker's
        capacity); use :meth:`save` and a refill (``train_step_fn(
        learn=False)``) when only the agent needs to travel."""
        ring = state.ring._replace(cursor=np.int32(state.ring.cursor),
                                   filled=np.int32(state.ring.filled))
        for name, tree in (
            ("carry", state.agent.carry_tree()),
            ("ring", ring),
            ("env_state", state.env_state),
            ("obs", state.obs),
            ("prev_valid", state.prev_valid),
            ("generator", state.generator.get_state()),
            ("iteration", np.int32(state.iteration)),
            ("ep_steps", state.ep_steps),
        ):
            save_component(folder, f"train_{name}", tree)

    def load_full(self, folder: str, like: OffPolicyTrainState) -> OffPolicyTrainState:
        """Loads a directory written by :meth:`save_full` into ``like`` (its
        agent and generator in place) and returns it."""

        def load(name, cur):
            return load_component(folder, f"train_{name}", cur)

        like.agent.load_carry_tree(load("carry", like.agent.carry_tree()))
        ring = load("ring", like.ring)
        like.ring = ring._replace(cursor=int(ring.cursor), filled=int(ring.filled))
        like.env_state = load("env_state", like.env_state)
        like.obs = load("obs", like.obs)
        like.prev_valid = load("prev_valid", like.prev_valid)
        like.generator.set_state(load("generator", like.generator.get_state()))
        like.iteration = int(load("iteration", np.int32(like.iteration)))
        like.ep_steps = load("ep_steps", like.ep_steps)
        return like


# -- liquid SAC -----------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class OffPolicyLiquidConfig(OffPolicyConfig):
    neurons: int = 64  # reference key: neuron_number
    unfolding_steps: int = 6
    # hidden states are stored per transition (5 nets x 2 x neurons floats),
    # so the default ring is smaller than the MLP tier's
    buffer_capacity: int = 65536


class LiquidRing(NamedTuple):
    """:class:`Ring` plus the per-step LTC hidden states: the reference's
    liquid replay buffers store the hidden state each forward pass consumed
    and produced (replay_buffer.h:33-56, liquid_sac_memory); here that is
    {net: [CAP, neurons]} for the five SAC nets, ``x`` at the transition's
    obs and ``next_x`` at its next_obs."""

    obs: torch.Tensor
    action: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    next_obs: torch.Tensor
    valid: torch.Tensor
    x: dict  # {net: [CAP, neurons]} pre-step hidden states
    next_x: dict  # {net: [CAP, neurons]} post-step hidden states
    cursor: int
    filled: int

    @classmethod
    def empty(cls, capacity: int, obs_size: int, action_size: int, neurons: int, nets,
              device) -> "LiquidRing":
        ring = Ring.empty(capacity, obs_size, action_size, device)

        def xs():
            return {n: torch.zeros((capacity, neurons), device=device) for n in nets}

        return cls(*ring[:6], x=xs(), next_x=xs(), cursor=0, filled=0)

    write = Ring.write
    cdf = Ring.cdf

    def sample(self, cdf, total, u):
        """:meth:`Ring.sample`, the batch followed by the hidden states
        ``x`` and ``next_x`` ({net: [B, neurons]}) at the indices."""
        idx, batch = Ring.sample(self, cdf, total, u)
        return idx, (*batch, *({n: t[idx] for n, t in xs.items()} for xs in (self.x, self.next_x)))


@dataclasses.dataclass
class OffPolicyLiquidTrainState(OffPolicyTrainState):
    xs: dict = None  # {net: [N, neurons]} live per-env hidden states


class BatchedOffPolicyLiquid(BatchedOffPolicy):
    """Batched ``soft_actor_critic_liquid`` (soft_actor_critic_liquid.cpp):
    SAC over a liquid actor and twin liquid Q (+ targets), N envs in
    lockstep, the hidden states carried through the rollout and stored in
    the ring so that updates replay from the stored x_t (teacher forcing),
    as the reference's LiquidReplayBuffer training path. The ring write,
    sampling, ``has_enough`` gate, cadence and checkpoints are
    :class:`BatchedOffPolicy`'s; the JAX liquid trainer has no full-state
    checkpoint, and neither has this one."""

    ALGOS = ("soft_actor_critic_liquid",)
    NETS = SoftActorCriticLiquidAgent.NETS

    def __init__(self, env, config: OffPolicyLiquidConfig = OffPolicyLiquidConfig(),
                 seed: int = 1234):
        super().__init__(env, "soft_actor_critic_liquid", config, seed)

    def make_agent(self):
        cfg, env = self.config, self.env
        return SoftActorCriticLiquidAgent(
            self.seed, env.observation_size, env.action_size, cfg.neurons, cfg.batch_size,
            cfg.epoch, cfg.learning_rate, cfg.gamma, cfg.tau, cfg.unfolding_steps,
            replay_buffer_size=1, train_every=cfg.train_every, device=env.device)

    def init(self) -> OffPolicyLiquidTrainState:
        """A fresh agent, an empty ring, first hidden states, and ``n_envs``
        envs reset with a generator on the env's device seeded with
        ``seed``."""
        cfg = self.config
        dev = self.env.device
        gen = torch.Generator(device=dev).manual_seed(self.seed)
        env_state, first = self.env.reset(cfg.n_envs, gen)
        ring = LiquidRing.empty(self.capacity, self.env.observation_size, self.env.action_size,
                                cfg.neurons, self.NETS, dev)
        return OffPolicyLiquidTrainState(
            agent=self.make_agent(), ring=ring, env_state=env_state, obs=first.obs,
            prev_valid=first.valid.clone(), generator=gen, iteration=0,
            ep_steps=torch.zeros(cfg.n_envs, dtype=torch.int32, device=dev),
            xs={n: first_x(cfg.neurons, cfg.n_envs, dev) for n in self.NETS})

    @torch.no_grad()
    def rollout(self, state: OffPolicyLiquidTrainState, uniforms=None):
        """:func:`rollout`'s trajectory of the agent's liquid policy,
        followed by each step's hidden states before and after it ({net:
        [T, N, n]}); all five chains advance with (obs, action), freeze
        across invalid settle frames and reset at episode end. Advances the
        state's ``xs`` in place too."""
        agent, gen, nets = state.agent, state.generator, self.NETS
        env_state, obs, prev_valid, ep_steps, xs = (state.env_state, state.obs,
                                                    state.prev_valid, state.ep_steps, state.xs)
        steps = []
        for t in range(self.config.steps_per_iter):
            u = None if uniforms is None else uniforms[t]
            action, new_xs = agent.advance(xs, obs, gen, u)
            env_state, res = self.env.step(env_state, action, gen)
            trainable = prev_valid & res.valid
            grown = ep_steps + res.valid.to(torch.int32)
            ended = res.done & res.valid
            done_len = torch.where(ended, grown, 0)
            ep_steps = torch.where(ended, 0, grown)
            steps.append(((obs, action, res.reward, res.done, res.obs, trainable.float(),
                           done_len, res.win & ended), xs, new_xs))
            validf = res.valid[:, None].float()
            donef = res.done[:, None].float()
            xs = {n: (1.0 - donef) * (validf * new_xs[n] + (1.0 - validf) * xs[n]) for n in nets}
            obs, prev_valid = res.obs, res.valid
        state.env_state, state.obs, state.prev_valid, state.ep_steps, state.xs = (
            env_state, obs, prev_valid, ep_steps, xs)
        out = tuple(torch.stack(x) for x in zip(*(s[0] for s in steps)))
        return (*out, *({n: torch.stack([s[k][n] for s in steps]) for n in nets}
                        for k in (1, 2)))

    def save_full(self, folder, state):
        raise NotImplementedError("the liquid SAC trainer has no full-state checkpoint "
                                  "(nor has the JAX package's)")

    load_full = save_full

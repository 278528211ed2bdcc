"""Batched PPO-GAE trainer (port of ``evomotion_tpu/train/ppo_batched.py``).

Reference counterpart: the train driver loop (src/train.cpp:17-87) running
ONE env sequentially with PpoGaeAgent. As in the JAX package, N
environments advance in lockstep:

    rollout: T steps of [batched env.step + actor sample]
    learn:   done-aware GAE over the [T, N] batch + ``epoch`` full-batch
             epochs of the clipped-surrogate and critic updates (same
             losses, clamps and normalization as the reference's
             PpoGaeAgent::train, ppo_gae.cpp:117-190)

Env transitions flagged invalid (settle phases, ``envs/base.py``) are masked
out of GAE and the losses; fixed-horizon rollouts bootstrap truncated
episodes with the critic value.

PyTorch idiom in place of the JAX pytrees: the train state holds the actor
and critic modules and their ``torch.optim.Adam`` optimizers, which the
update changes in place, and a ``torch.Generator`` in place of the PRNG key.
Gradients are clipped by the rule of optax's ``clip_by_global_norm`` (scale
by ``max_norm / norm`` only when ``norm >= max_norm``), which
``torch.nn.utils.clip_grad_norm_`` does not follow. The rollout draws its
actions from the generator, or from uniforms the caller passes (the tests
pass JAX's draws).

Inside a ``parallel.mesh`` (each rank stepping its rows of the env batch)
the GAE statistics, the loss denominators, the obs statistics and the
metrics are sums over the global batch, and the gradients are summed over
the ranks before clipping; outside one those collectives are no-ops.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Any, NamedTuple

import numpy as np
import torch

from ..convert import adam_tree, load_adam
from ..networks import distributions as D
from ..networks.modules import Actor, Critic
from ..parallel.mesh import all_reduce_grads, psum
from .checkpoint import load_component, save_component
from .profiling import span


@dataclasses.dataclass(frozen=True)
class PpoConfig:
    """Hyper-parameters; defaults are the reference baseline config
    (BASELINE.md / README docker command)."""

    hidden_size: int = 256
    gamma: float = 0.99
    lam: float = 0.95
    epsilon: float = 0.2
    entropy_factor: float = 0.01
    critic_loss_factor: float = 0.5
    epoch: int = 8
    learning_rate: float = 1e-3
    clip_grad_norm: float = 0.5
    horizon: int = 64  # rollout length T per train iteration
    n_envs: int = 1024
    # entropy-bonus decay: factor = entropy_factor * (entropy_end /
    # entropy_factor) ** min(it / entropy_steps, 1), the reference's
    # exponential_decrease schedule (functions.cpp); entropy_steps <= 0
    # keeps the factor fixed, as the reference's PPO does
    entropy_end: float = 1e-4
    entropy_steps: int = 0
    # running observation normalization over masked rollout frames:
    # rollouts and updates both see (obs - mean) / sqrt(var + eps) with the
    # previous iteration's stats. Off by default: the parity config.
    obs_norm: bool = False
    # sigma annealing: the sampling std is scaled by
    # sigma_scale_end ** min(it / sigma_scale_steps, 1) in rollouts AND
    # updates. Off (1.0 / 0) by default.
    sigma_scale_end: float = 1.0
    sigma_scale_steps: int = 0
    # survival shaping (training only; metrics report the raw env reward):
    # a constant added to every valid step's reward inside GAE
    survival_bonus: float = 0.0


@dataclasses.dataclass
class PpoTrainState:
    actor: Actor
    critic: Critic
    actor_opt: torch.optim.Adam
    critic_opt: torch.optim.Adam
    env_state: Any  # batched env state, env axis first
    obs: torch.Tensor  # [N, S]
    generator: torch.Generator  # actions and env resets, on the env's device
    iteration: int
    ep_steps: torch.Tensor  # [N] int32: valid steps in each env's open episode
    # running obs-normalization stats (identity while obs_count is 0)
    obs_mean: torch.Tensor  # [S]
    obs_var: torch.Tensor  # [S]
    obs_count: torch.Tensor  # scalar f32


class Trajectory(NamedTuple):
    """One rollout, [T, N, ...]."""

    obs: torch.Tensor  # [T, N, S] raw observations
    action: torch.Tensor  # [T, N, A]
    log_prob: torch.Tensor  # [T, N, A]
    value: torch.Tensor  # [T, N, 1]
    reward: torch.Tensor  # [T, N]
    done: torch.Tensor  # [T, N] bool
    valid: torch.Tensor  # [T, N] bool
    done_len: torch.Tensor  # [T, N] int32: the ended episode's length on its done step
    win: torch.Tensor  # [T, N] bool: ended by reaching the win horizon


class PpoMetrics(NamedTuple):
    actor_loss: torch.Tensor
    critic_loss: torch.Tensor
    mean_reward: torch.Tensor
    episodes_done: torch.Tensor
    mean_episode_return: torch.Tensor
    # over the episodes that ENDED this iteration: mean length in valid
    # steps, and the fraction that ended by reaching the win horizon
    mean_ep_len: torch.Tensor
    win_rate: torch.Tensor


def _sigma_scale(cfg: PpoConfig, iteration: int) -> float:
    if cfg.sigma_scale_steps <= 0:
        return 1.0
    return cfg.sigma_scale_end ** min(iteration / cfg.sigma_scale_steps, 1.0)


def normalize_obs(state: PpoTrainState, obs: torch.Tensor) -> torch.Tensor:
    """(obs - mean) / sqrt(var + eps) with the running stats of ``state``
    (its ``obs_mean``, ``obs_var`` and ``obs_count``); the identity while no
    frames have been folded in (fresh state, obs_norm off)."""
    return torch.where(
        state.obs_count > 0.5, (obs - state.obs_mean) * torch.rsqrt(state.obs_var + 1e-8), obs)


def _update_obs_stats(state: PpoTrainState, obs, maskf) -> None:
    """Folds masked rollout frames [T, N, S] into the running mean and var
    (parallel Welford / Chan merge), in place."""
    m = maskf[..., 0]  # [T, N]
    w = m[..., None]
    sums = psum(torch.cat([m.sum()[None], (obs * w).sum((0, 1))]))
    n_b = torch.clamp_min(sums[0], 1.0)
    mean_b = sums[1:] / n_b
    var_b = psum((((obs - mean_b) ** 2) * w).sum((0, 1))) / n_b
    n_a = state.obs_count
    tot = n_a + n_b
    delta = mean_b - state.obs_mean
    state.obs_mean = state.obs_mean + delta * (n_b / tot)
    state.obs_var = (n_a * state.obs_var + n_b * var_b + delta**2 * (n_a * n_b / tot)) / tot
    state.obs_count = tot


def gae_and_normalize(cfg: PpoConfig, values, rewards, dones, valids, bootstrap):
    """Done-aware masked GAE + the reference's normalized-advantage returns
    (ppo_gae.cpp:134-152). values [T, N, 1], rewards/dones/valids [T, N],
    bootstrap [N, 1]; returns (advantages, returns, maskf, n_valid)."""
    rewards = rewards[..., None]
    donesf = dones[..., None].float()
    maskf = valids[..., None].float()

    next_values = torch.cat([values[1:], bootstrap[None]], 0)
    deltas = (rewards + cfg.gamma * (1.0 - donesf) * next_values - values) * maskf

    advantages = torch.empty_like(deltas)
    g = torch.zeros_like(deltas[0])
    for t in range(deltas.shape[0] - 1, -1, -1):
        g = deltas[t] + cfg.gamma * cfg.lam * (1.0 - donesf[t]) * maskf[t] * g
        advantages[t] = g

    sums = psum(torch.stack([maskf.sum(), (advantages * maskf).sum()]))
    n = torch.clamp_min(sums[0], 1.0)
    mean = sums[1] / n
    var = psum((((advantages - mean) ** 2) * maskf).sum()) / torch.clamp_min(n - 1.0, 1.0)
    advantages = (advantages - mean) / (torch.sqrt(var) + 1e-8)
    returns = advantages + values  # reference quirk: normalized adv
    return advantages, returns, maskf, n


@torch.no_grad()
def clip_by_global_norm_(params, max_norm: float) -> None:
    """optax.clip_by_global_norm on the gradients of ``params``, in place:
    kept as they are while their global norm is below ``max_norm``, else
    each scaled as ``g / norm * max_norm``."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


def save_train_state(folder: str, state: PpoTrainState) -> None:
    """Full train-state checkpoint: one ``train_<field>.npz`` per field of
    the JAX package's train state (actor and critic params, their optax-laid
    Adam states, env batch, obs, iteration, episode steps, obs stats), with
    ``train_generator.npz`` (the generator's state bytes) in place of JAX's
    ``train_key.npz``. The reference cannot resume training (SURVEY §5); the
    JAX package and the port checkpoint everything."""
    for name, tree in (
        ("actor_params", state.actor),
        ("critic_params", state.critic),
        ("actor_opt_state", adam_tree(state.actor_opt, state.actor)),
        ("critic_opt_state", adam_tree(state.critic_opt, state.critic)),
        ("env_state", state.env_state),
        ("obs", state.obs),
        ("generator", state.generator.get_state()),
        ("iteration", np.int32(state.iteration)),
        ("ep_steps", state.ep_steps),
        ("obs_mean", state.obs_mean),
        ("obs_var", state.obs_var),
        ("obs_count", state.obs_count),
    ):
        save_component(folder, f"train_{name}", tree)


def load_train_state(folder: str, like: PpoTrainState) -> PpoTrainState:
    """Loads a directory written by :func:`save_train_state` or by the JAX
    package's ``save_train_state`` into ``like`` (its modules, optimizers
    and generator in place) and returns it. A field whose file is missing
    keeps ``like``'s value (checkpoints written before the field existed).
    A JAX directory has ``train_key.npz`` and no generator state: the
    generator is then seeded with the key's two uint32 words,
    ``(key[0] << 32) | key[1]``; the env state's per-env ``key`` has no
    counterpart and is not read."""

    def has(name):
        return os.path.exists(os.path.join(folder, f"train_{name}.npz"))

    def load(name, cur):
        return load_component(folder, f"train_{name}", cur) if has(name) else cur

    load("actor_params", like.actor)
    load("critic_params", like.critic)
    for name, opt, module in (("actor_opt_state", like.actor_opt, like.actor),
                              ("critic_opt_state", like.critic_opt, like.critic)):
        if has(name):
            load_adam(opt, module, load(name, adam_tree(opt, module)))
    like.env_state = load("env_state", like.env_state)
    like.obs = load("obs", like.obs)
    if has("generator"):
        like.generator.set_state(load("generator", like.generator.get_state()))
    elif has("key"):
        k = load_component(folder, "train_key", np.zeros(2, np.uint32))
        like.generator.manual_seed((int(k[0]) << 32) | int(k[1]))
    like.iteration = load("iteration", like.iteration)
    for name in ("ep_steps", "obs_mean", "obs_var", "obs_count"):
        setattr(like, name, load(name, getattr(like, name)))
    return like


class BatchedPpo:
    """PPO-GAE over ``env``, a batched env (``reset(n_envs, generator)``,
    ``step(state, action, generator)``, ``observation_size``,
    ``action_size``, ``device``)."""

    def __init__(self, env, config: PpoConfig = PpoConfig(), seed: int = 1234):
        self.env = env
        self.config = config
        self.seed = seed

    def init(self) -> PpoTrainState:
        """Fresh networks (drawn from a CPU generator seeded with ``seed``,
        actor first: the same weights on every device), Adam optimizers, and
        ``n_envs`` envs reset with a generator on the env's device seeded
        with ``seed``."""
        cfg = self.config
        dev = self.env.device
        s, a = self.env.observation_size, self.env.action_size
        init_gen = torch.Generator().manual_seed(self.seed)
        actor = Actor(s, a, cfg.hidden_size, init_gen).to(dev)
        critic = Critic(s, cfg.hidden_size, init_gen).to(dev)
        gen = torch.Generator(device=dev).manual_seed(self.seed)
        env_state, first = self.env.reset(cfg.n_envs, gen)
        return PpoTrainState(
            actor=actor,
            critic=critic,
            actor_opt=torch.optim.Adam(actor.parameters(), lr=cfg.learning_rate),
            critic_opt=torch.optim.Adam(critic.parameters(), lr=cfg.learning_rate),
            env_state=env_state,
            obs=first.obs,
            generator=gen,
            iteration=0,
            ep_steps=torch.zeros(cfg.n_envs, dtype=torch.int32, device=dev),
            obs_mean=torch.zeros(s, device=dev),
            obs_var=torch.ones(s, device=dev),
            obs_count=torch.zeros((), device=dev),
        )

    def rollout_fn(self):
        """``rollout(state, uniforms=None) -> (state, Trajectory)``: ``horizon``
        env steps of the sampled policy; ``uniforms`` [T, N, A] replace the
        generator's action draws. Advances the state's env batch, obs and
        episode steps in place."""
        cfg = self.config
        env = self.env

        @torch.no_grad()
        def rollout(state: PpoTrainState, uniforms=None):
            sig_scale = _sigma_scale(cfg, state.iteration)
            env_state, obs, ep_steps = state.env_state, state.obs, state.ep_steps
            steps = []
            for t in range(cfg.horizon):
                with span("rollout.policy"):
                    obs_in = normalize_obs(state, obs) if cfg.obs_norm else obs
                    mu, sigma = state.actor(obs_in)
                    sigma = sigma * sig_scale
                    u = None if uniforms is None else uniforms[t]
                    action = D.truncated_normal_sample(mu, sigma, state.generator, u)
                    log_prob = D.truncated_normal_log_pdf(action, mu, sigma)
                    value = state.critic(obs_in)
                env_state, res = env.step(env_state, action, state.generator)
                # per-episode bookkeeping: count valid frames; emit the
                # finished length (and its win flag) on the done step
                grown = ep_steps + res.valid.to(torch.int32)
                ended = res.done & res.valid
                done_len = torch.where(ended, grown, 0)
                ep_steps = torch.where(ended, 0, grown)
                steps.append((obs, action, log_prob, value, res.reward, res.done, res.valid,
                              done_len, res.win & ended))
                obs = res.obs
            state.env_state, state.obs, state.ep_steps = env_state, obs, ep_steps
            return state, Trajectory(*(torch.stack(x) for x in zip(*steps)))

        return rollout

    def train_step_fn(self, timer=None):
        """``train_step(state, uniforms=None) -> (state, PpoMetrics)``: one
        rollout, GAE, ``epoch`` actor and critic updates, then the obs
        stats fold. With a ``train.profiling.StepTimer`` the rollout and the
        update are timed as the phases ``rollout`` and ``update``, each
        ending in a wait for the card."""
        cfg = self.config
        rollout = self.rollout_fn()

        def phase(name):
            if timer is None:
                return contextlib.nullcontext()
            return timer.phase(name, block_on=self.env.device)

        def train_step(state: PpoTrainState, uniforms=None):
            it = state.iteration  # the rollout's log_probs were computed under it
            with phase("rollout"):
                state, traj = rollout(state, uniforms)
            with phase("update"):
                metrics = self._update(state, traj, it)
            return state, metrics

        return train_step

    def targets(self, state: PpoTrainState, traj: Trajectory):
        """What every epoch of the update fits, from a rollout ``traj`` and
        the state it ended in (obs stats not yet folded): the observations
        as the networks see them, then GAE's ``(advantages, returns, maskf,
        n_valid)``."""
        cfg = self.config
        with torch.no_grad(), span("update.gae"):
            obs, last_obs = traj.obs, state.obs
            if cfg.obs_norm:
                obs = normalize_obs(state, obs)
                last_obs = normalize_obs(state, last_obs)
            bootstrap = state.critic(last_obs)  # [N, 1]
            shaped = traj.reward + cfg.survival_bonus  # masked inside the GAE
            return (obs, *gae_and_normalize(cfg, traj.value, shaped, traj.done, traj.valid,
                                            bootstrap))

    def critic_step(self, state: PpoTrainState, obs, returns, maskf, n) -> torch.Tensor:
        """One epoch's critic update, in place; returns its loss."""
        cfg = self.config
        with span("update.critic"):
            v = state.critic(obs)
            c_loss = cfg.critic_loss_factor * (((v - returns) ** 2) * maskf).sum() / n
            _step(state.critic_opt, state.critic, c_loss, cfg.clip_grad_norm)
        return c_loss.detach()

    def _update(self, state: PpoTrainState, traj: Trajectory, it: int) -> PpoMetrics:
        cfg = self.config
        actor = state.actor
        actions, log_probs = traj.action, traj.log_prob
        obs, advantages, returns, maskf, n = self.targets(state, traj)
        n_act = n * actions.shape[-1]
        if cfg.entropy_steps > 0:
            frac = min(it / cfg.entropy_steps, 1.0)
            # reference functions.cpp exponential_decrease
            ent_factor = cfg.entropy_factor * (cfg.entropy_end / cfg.entropy_factor) ** frac
        else:
            ent_factor = cfg.entropy_factor
        sig_scale = _sigma_scale(cfg, it)

        a_losses, c_losses = [], []
        for _ in range(cfg.epoch):
            with span("update.actor"):
                mu, sigma = actor(obs)
                sigma = sigma * sig_scale
                lp = D.truncated_normal_log_pdf(actions, mu, sigma)
                entropy = D.truncated_normal_entropy(mu, sigma)
                ratios = torch.exp(lp - log_probs)
                s1 = ratios * advantages
                s2 = torch.clamp(ratios, 1.0 - cfg.epsilon, 1.0 + cfg.epsilon) * advantages
                obj = torch.minimum(s1, s2) + ent_factor * entropy
                a_loss = -(obj * maskf).sum() / n_act
                _step(state.actor_opt, actor, a_loss, cfg.clip_grad_norm)
            a_losses.append(a_loss.detach())
            c_losses.append(self.critic_step(state, obs, returns, maskf, n))

        state.iteration = it + 1
        if cfg.obs_norm:
            # fold this rollout's frames in AFTER the update so the next
            # rollout and its stored log_probs share one normalizer
            _update_obs_stats(state, traj.obs, maskf)
        return ppo_metrics(a_losses, c_losses, traj, maskf, n)


def ppo_metrics(a_losses, c_losses, traj, maskf, n) -> PpoMetrics:
    """The metrics of an update from its per-epoch losses, its rollout
    ``traj`` (``reward``, ``done``, ``done_len``, ``win``), the valid mask
    and count: sums over the global batch inside a mesh (two collectives)."""
    epochs = len(a_losses)
    fsum = psum(torch.cat([torch.stack(a_losses), torch.stack(c_losses),
                           (traj.reward * maskf[..., 0]).sum()[None]]))
    isum = psum(torch.stack([traj.done.sum(), (traj.done_len > 0).sum(), traj.done_len.sum(),
                             traj.win.sum()]))
    n_done, reward_sum = isum[0], fsum[-1]
    n_ended = torch.clamp_min(isum[1], 1)
    return PpoMetrics(
        actor_loss=fsum[:epochs].mean(),
        critic_loss=fsum[epochs:2 * epochs].mean(),
        mean_reward=reward_sum / n,
        episodes_done=n_done,
        mean_episode_return=reward_sum / torch.clamp_min(n_done, 1.0),
        mean_ep_len=isum[2] / n_ended,
        win_rate=isum[3] / n_ended,
    )


def save_agent(folder: str, state) -> None:
    """A batched PPO state's (plain or liquid) agent as the components
    ``actor``, ``critic``, ``actor_optimizer`` and ``critic_optimizer``
    (optax's ``chain(clip_by_global_norm, adam)`` layout), as the JAX
    driver saves them: the sequential ``ppo_gae`` (``ppo_gae_liquid``) agent
    loads them."""
    save_component(folder, "actor", state.actor)
    save_component(folder, "critic", state.critic)
    save_component(folder, "actor_optimizer", adam_tree(state.actor_opt, state.actor))
    save_component(folder, "critic_optimizer", adam_tree(state.critic_opt, state.critic))


def _step(opt: torch.optim.Adam, module, loss, max_norm: float) -> None:
    opt.zero_grad(set_to_none=True)
    loss.backward()
    all_reduce_grads(module.parameters())
    clip_by_global_norm_(module.parameters(), max_norm)
    opt.step()

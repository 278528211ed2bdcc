"""Greedy evaluation of robot_walk checkpoints (port of ``tools/eval_walk.py``).

    python -m evomotion_tpu_torch.tools.eval_walk ppo <save dir> [--episodes 64] [--seed 999]
    python -m evomotion_tpu_torch.tools.eval_walk ppo evomotion_tpu_torch/resources/walker_r5e_s42
    python -m evomotion_tpu_torch.tools.eval_walk crossq <save dir> [--hidden 256]

Runs the deterministic policy, clip(mu, -1, 1), over ``--episodes`` fresh
batched envs for the 1800-step win horizon and prints the win rate, the
episode lengths and the mean return, then one JSON line with those numbers,
the mean valid steps within the first 400 env steps, and the milliseconds
per env step (host clock around the step loop, which ends in a wait for the
card). Tiers: ``ppo`` reads a train-state directory (``train_actor_params``
and the obs-normalization stats ``train_obs_{mean,var,count}``, applied when
the count is above 0.5); ``crossq`` and ``sac`` read the ``actor``
component, the only part of those agents the evaluation uses. The solver
row order is the checkpoint's ``meta.json`` ``eval_order`` unless
``--row-order`` is given. ``evomotion_tpu_torch/resources/walker_r5e_s42``
is the port's copy of the committed walker's policy files.

Resets draw from a ``torch.Generator`` seeded with ``--seed``; the JAX tool
draws them from ``jax.random``, so the two agree statistically, not episode
by episode. Runs on the card unless ``main`` is given ``device="cpu"``.
Recording the best episode (``--out``) waits for the viewer (ROADMAP A11).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ..device import resolve
from ..envs.robot import RobotWalkFactory
from ..networks.modules import Actor
from ..train.checkpoint import load_component
from ..train.ppo_batched import normalize_obs
from ..train.profiling import wait_for

WIN = 1800  # env steps of the win horizon (max_episode_seconds 30 at 60 Hz)
EARLY = 400  # the JAX package's upright check counts valid steps over this many
WALKER_DIR = os.path.join(os.path.dirname(__file__), "..", "resources", "walker_r5e_s42")


def greedy_action(actor: Actor, obs):
    """The deterministic policy: clip(mu, -1, 1) of ``actor`` on ``obs``
    (already normalized where the checkpoint normalizes)."""
    with torch.no_grad():
        return torch.clamp(actor(obs)[0], -1.0, 1.0)


class GreedyPolicy(nn.Module):
    """:func:`greedy_action` on observations normalized with a checkpoint's
    running stats (``train.ppo_batched.normalize_obs``: the identity until
    the count is above 0.5)."""

    def __init__(self, actor: Actor, obs_mean=None, obs_var=None, obs_count=0.0):
        super().__init__()
        self.actor = actor
        w = actor.h1.lin.w  # the stats default to the identity, on the actor's device
        s, dev = w.shape[1], w.device
        self.register_buffer("obs_mean", torch.zeros(s, device=dev) if obs_mean is None
                             else obs_mean)
        self.register_buffer("obs_var", torch.ones(s, device=dev) if obs_var is None
                             else obs_var)
        self.register_buffer("obs_count", torch.as_tensor(obs_count, dtype=torch.float32,
                                                          device=dev))

    @property
    def use_norm(self) -> bool:
        return float(self.obs_count) > 0.5

    def normalize(self, obs):
        return normalize_obs(self, obs)

    def forward(self, obs):
        return greedy_action(self.actor, self.normalize(obs))


def load_policy(tier: str, ckpt: str, obs_size: int, action_size: int, hidden: int,
                device) -> GreedyPolicy:
    """The greedy policy of a checkpoint directory, on ``device``."""
    actor = Actor(obs_size, action_size, hidden)
    if tier == "ppo":
        load_component(ckpt, "train_actor_params", actor)
        stats = [load_component(ckpt, f"train_obs_{k}", torch.zeros(shape))
                 for k, shape in (("mean", obs_size), ("var", obs_size), ("count", ()))]
        policy = GreedyPolicy(actor, *stats)
    else:
        policy = GreedyPolicy(load_component(ckpt, "actor", actor))
    return policy.to(device).eval()


class EvalResult(NamedTuple):
    steps: torch.Tensor  # [N] int32: valid steps of each env's first episode
    ret: torch.Tensor  # [N] f32: its return
    won: torch.Tensor  # [N] bool: it reached the win horizon
    early_steps: torch.Tensor  # [N] int32: valid steps within the first EARLY env steps
    reset_s: float  # host clock of the reset, ending in a wait for the card
    steps_s: float  # host clock of the step loop, the same way


def greedy_eval(env, policy, n_envs: int, horizon: int, generator) -> EvalResult:
    """``n_envs`` fresh envs (reset draws from ``generator``) step under
    ``policy`` for ``horizon`` env steps; each env's first episode counts:
    its valid steps and return while alive, and whether it won. Settle
    frames (``valid`` False) count for nothing."""
    t0 = time.perf_counter()
    est, res = env.reset(n_envs, generator)
    wait_for(res.obs)
    t1 = time.perf_counter()
    dev = res.obs.device
    alive = torch.ones(n_envs, dtype=torch.bool, device=dev)
    steps = torch.zeros(n_envs, dtype=torch.int32, device=dev)
    ret = torch.zeros(n_envs, device=dev)
    won = torch.zeros(n_envs, dtype=torch.bool, device=dev)
    early = None
    obs = res.obs
    for t in range(horizon):
        est, res = env.step(est, policy(obs), generator)
        live = alive & res.valid
        steps = steps + live.to(torch.int32)
        ret = ret + torch.where(live, res.reward, 0.0)
        won = won | (live & res.win)
        alive = alive & ~(res.done & res.valid)
        obs = res.obs
        if t + 1 == EARLY:
            early = steps.clone()
    wait_for(steps)
    t2 = time.perf_counter()
    return EvalResult(steps, ret, won, steps if early is None else early, t1 - t0, t2 - t1)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("tier", choices=["ppo", "crossq", "sac"])
    p.add_argument("ckpt")
    p.add_argument("--episodes", type=int, default=64)
    p.add_argument("--seed", type=int, default=999)
    p.add_argument("--out", default=None, help="record best episode: OUT.npz + OUT.html")
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--row-order", default=None,
                   help="solver row order override (default: checkpoint meta.json "
                        "eval_order, else the model default)")
    return p


def main(argv=None, device=None) -> int:
    args = build_parser().parse_args(argv)
    if args.out:
        raise NotImplementedError("recording an episode (--out) needs the viewer, not "
                                  "ported yet (ROADMAP A11)")
    dev = resolve(device)
    env = RobotWalkFactory({}).make(args.seed, mt_parity=False, device=dev, per_env_step=False)

    # the solve order is physics-visible for trained gaits: adopt the order
    # the checkpoint was evaluated and selected under unless overridden
    order = args.row_order
    meta_path = os.path.join(args.ckpt, "meta.json")
    if order is None and os.path.exists(meta_path):
        with open(meta_path) as f:
            order = json.load(f).get("eval_order")
    if order is not None and order != env.model.row_order:
        print(f"row_order: {env.model.row_order} -> {order} "
              f"({'cli override' if args.row_order else 'checkpoint meta.json'})")
        env.model = dataclasses.replace(env.model, row_order=order)

    policy = load_policy(args.tier, args.ckpt, env.observation_size, env.action_size,
                         args.hidden, dev)
    n = args.episodes
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    r = greedy_eval(env, policy, n, WIN, gen)
    steps, ret, won = (x.cpu().numpy() for x in (r.steps, r.ret, r.won))
    early = float(r.early_steps.float().mean())
    ms = r.steps_s / WIN * 1e3
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"greedy eval over {n} envs (win horizon {WIN} steps):")
    print(f"  win rate      : {won.mean():.3f} ({int(won.sum())}/{n})")
    print(f"  mean ep len   : {steps.mean():.1f}  (median {np.median(steps):.0f}, "
          f"max {steps.max()})")
    print(f"  mean return   : {ret.mean():.2f}")
    print(f"  early steps   : {early:.1f} mean valid steps within the first {EARLY}")
    print(f"  ms per step   : {ms:.3f} ({n} envs, host clock, {card})")
    print(json.dumps({
        "tier": args.tier, "row_order": env.model.row_order, "envs": n, "seed": args.seed,
        "win_horizon": WIN, "wins": int(won.sum()), "win_rate": float(won.mean()),
        "mean_len": float(steps.mean()), "median_len": float(np.median(steps)),
        "max_len": int(steps.max()), "mean_return": float(ret.mean()),
        "early_steps_mean": early, "early_horizon": EARLY, "ms_per_step": ms,
        "reset_s": r.reset_s, "steps_s": r.steps_s, "device": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Replay of the strict-Bullet trajectory artifact on the port.

    python -m evomotion_tpu_torch.tools.strict_trajectory [--steps 256] [--device cpu]

The port of ``run_strict_trajectory`` (``tools/gen_strict_artifact.py``):
one ``robot_walk`` world (``reset_frames`` 30, seed 1234, the reference's
mt19937 reset stream) on the per-env step with ``strict_bullet=True`` and
``solver="xla"``, reset, then stepped with the artifact's action stream.
The JAX tool draws its actions with ``jax.random`` (split of key 1235, then
uniform in [-1, 1)), which torch cannot replay, so the port reads them from
``resources/strict_walk/actions.npy`` (256 x 12 f32; the tests hold that
file equal to JAX's draws). The JAX reset takes its tilt from the mt19937
table, which the port replays.

Compares pos and reward per step against ``tests/goldens/strict_walk.npz``
and prints the largest difference over the steps run, the first step that
exceeds the artifact's tolerance (1e-4), ms per env step, then one JSON
line. The free run parts from the artifact within the reset's settle: the
spider's settle is chaotic in f32, and JAX's own step compiled two ways
parts by ~0.4 (ROADMAP Queue C, trap 14), so the distance is a reading;
``tests/test_torch_strict_replay.py`` holds the port to JAX step by step.
Runs on the card unless given ``--device cpu``; exit 1 on a non-finite
replay.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from ..device import resolve
from ..envs.robot import RobotWalkFactory
from ..train.profiling import wait_for

STEPS = 256
SEED = 1234
TOL = 1e-4  # the JAX test's tolerance (tests/test_physics_golden.py)
_HERE = os.path.dirname(os.path.abspath(__file__))
ACTIONS = os.path.join(_HERE, "..", "resources", "strict_walk", "actions.npy")
ARTIFACT = os.path.join(_HERE, "..", "..", "tests", "goldens", "strict_walk.npz")


def strict_env(device=None):
    """The artifact's env: robot_walk, 30 reset frames, seed 1234 with the
    mt19937 stream, the per-env step, strict Bullet, the xla solver."""
    env = RobotWalkFactory({"reset_frames": "30"}).make(SEED, mt_parity=True, device=device,
                                                        per_env_step=True)
    env.model = dataclasses.replace(env.model, strict_bullet=True, solver="xla")
    return env


def run_strict_trajectory(steps: int = STEPS, device=None):
    """Reset, then ``steps`` env steps with the artifact's actions. Returns
    numpy (pos [T, NB, 3], quat [T, NB, 4], reward [T]) and the host-clock
    seconds of the steps (after the reset)."""
    dev = resolve(device)
    env = strict_env(dev)
    actions = torch.as_tensor(np.load(ACTIONS)[:steps], device=dev)
    state, _ = env.reset(1)
    wait_for(state.physics.pos)
    pos, quat, rew = [], [], []
    t0 = time.perf_counter()
    for t in range(steps):
        state, res = env.step(state, actions[t][None])
        pos.append(state.physics.pos[0])
        quat.append(state.physics.quat[0])
        rew.append(res.reward[0])
    out = tuple(torch.stack(x).cpu().numpy() for x in (pos, quat, rew))
    return out + (time.perf_counter() - t0,)


def compare(pos, reward, ref=None):
    """(max |pos - artifact|, max |reward - artifact|, first step where
    either exceeds TOL or None) over the steps given."""
    ref = np.load(ARTIFACT) if ref is None else ref
    n = len(pos)
    dp = np.abs(pos - ref["pos"][:n]).reshape(n, -1).max(1)
    dr = np.abs(reward - ref["reward"][:n])
    bad = np.nonzero((dp > TOL) | (dr > TOL))[0]
    return float(dp.max()), float(dr.max()), (int(bad[0]) if len(bad) else None)


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--device", default=device)
    args = ap.parse_args(argv)
    pos, quat, rew, secs = run_strict_trajectory(args.steps, args.device)
    err_pos, err_rew, first = compare(pos, rew)
    ms = secs / args.steps * 1e3
    print(f"strict replay, {args.steps} steps: max |pos - artifact| {err_pos:.3e}, max |reward "
          f"- artifact| {err_rew:.3e} (tol {TOL:g}); first step over tol: {first}; "
          f"{ms:.1f} ms per env step (host clock)", flush=True)
    print(json.dumps({"steps": args.steps, "max_pos_err": err_pos, "max_reward_err": err_rew,
                      "first_over_tol": first, "ms_per_step": ms}), flush=True)
    return 0 if np.isfinite(pos).all() and np.isfinite(rew).all() else 1


if __name__ == "__main__":
    sys.exit(main())

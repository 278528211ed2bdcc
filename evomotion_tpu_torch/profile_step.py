"""Where the time of the port's robot_walk step goes on the card.

    python -m evomotion_tpu_torch.profile_step [--envs 2048] [--steps 10]
    python -m evomotion_tpu_torch.profile_step --per-env --envs 1

Resets the spider at B envs, warms up, then profiles ``--steps`` env steps
with uniform random actions under ``torch.profiler`` (CPU + CUDA
activities). The default is the batched step; ``--per-env`` steps each
world with the per-env step (fat rows, the fat-row sweep twice per physics
step), as the CLI's ``run`` does with one world. Prints the card's name and
power limit, the wall time per step, the device's busy and idle share of
that time, the CUDA kernel launches per step, and the kernels that take the
most device time, then one JSON line. Needs a CUDA card; measurement only,
nothing in the package calls it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time


def _device_events(prof):
    """(name, microseconds) of every kernel, copy and fill the card ran,
    read from the profiler's chrome trace (stable across torch versions)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return [(e["name"], float(e.get("dur", 0.0))) for e in events
            if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--envs", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--per-env", action="store_true",
                    help="profile the per-env step (the sequential tier) instead of the "
                    "batched step")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from .envs.robot import RobotWalk

    if not torch.cuda.is_available():
        print("profile_step: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown card"
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    env = RobotWalk(device=dev, per_env_step=args.per_env)
    state, _ = env.reset(args.envs, gen)

    def step(state):
        action = torch.rand((args.envs, env.action_size), generator=gen, device=dev) * 2 - 1
        return env.step(state, action, gen)[0]

    for _ in range(3):
        state = step(state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state = step(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    kernels = {}
    for name, us in _device_events(prof):
        k = kernels.setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += us
    busy_us = sum(v[1] for v in kernels.values())
    launches = sum(v[0] for v in kernels.values())
    step_ms = wall / args.steps * 1e3
    busy = busy_us / 1e3 / (wall * 1e3)
    print(f"card: {card}", flush=True)
    step_kind = "per-env" if args.per_env else "batched"
    print(f"B={args.envs}, {step_kind} step: {step_ms:.3f} ms per env step (host clock, profiler on), "
          f"device busy {100 * busy:.1f}%, idle {100 * (1 - busy):.1f}%, "
          f"{launches / args.steps:.0f} CUDA kernel launches per step", flush=True)
    print(f"{'device ms/step':>14} {'share':>6} {'calls/step':>10}  kernel")
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[: args.top]
    for name, (count, us) in top:
        print(f"{us / 1e3 / args.steps:14.3f} {100 * us / busy_us:5.1f}% "
              f"{count / args.steps:10.1f}  {name[:100]}")
    print(json.dumps({
        "card": card, "envs": args.envs, "step": step_kind, "steps": args.steps,
        "step_ms": step_ms,
        "device_busy": busy, "launches_per_step": launches / args.steps,
        "top": [{"kernel": n[:100], "ms_per_step": us / 1e3 / args.steps, "calls_per_step":
                 c / args.steps} for n, (c, us) in top],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

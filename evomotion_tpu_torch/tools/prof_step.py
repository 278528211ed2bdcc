"""Phase breakdown of the port's batched spider robot_walk step.

    python -m evomotion_tpu_torch.tools.prof_step [--envs 2048] [--no-members]
    python -m evomotion_tpu_torch.tools.prof_step --device cpu --envs 2 --reps 1 \\
        --reset-frames 1 --iterations 1 --no-members

The port of the repo's ``tools/prof_step.py``. It resets ``--envs`` spiders
(``solver="pallas"``, the model's row order), then times each phase of the
env-last physics step alone on that state, ``--reps`` calls after one
warm-up call, with a device sync before and after: the full env step (zero
actions), the physics step, and within it the world inverse inertia, floor
contacts, joint rows, member narrowphase (the plain version's) and the
member phase as the step runs it (kernel #4 on the card: cull,
narrowphase, rows and warm start in one launch); then the sweep
kernel alone (the env-last fat-row sweep, TPU kernel #3's port, on random
rows N(0, 1) * 0.01 with the spider's full-sweep metadata, as the TPU tool
does) and the obs/env overhead (env step minus physics step). On the card
each phase's line also gives the CUDA kernels, copies and fills one call of
it launches, counted with ``torch.profiler``. Ends with one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from ..device import resolve
from ..envs.robot import RobotWalk, RobotWalkParams
from ..kernels import member as km
from ..kernels import sweep_envlast as se
from ..physics import batched as bt
from ..physics import engine as E
from ..physics.model import MAX_CONTACTS_PER_PAIR
from ._profile import card_name, device_events


def device_launches(fn, dev):
    """Kernels, copies and fills the card runs for one call of ``fn``
    (torch.profiler); None on the CPU."""
    if dev.type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return len(device_events(prof))


def timeit(fn, reps, dev):
    """Mean seconds of ``fn()`` over ``reps`` calls after one warm-up call,
    synchronised before and after."""
    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync()
    return (time.perf_counter() - t0) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--envs", type=int, default=2048)
    ap.add_argument("--no-members", action="store_true",
                    help="model without member-member contacts")
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--reset-frames", type=int, default=None,
                    help="settle frames of the reset (default: the env's)")
    ap.add_argument("--iterations", type=int, default=None,
                    help="solver iterations (default: the model's)")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    n = args.envs

    params = RobotWalkParams() if args.reset_frames is None else RobotWalkParams(
        reset_frames=args.reset_frames)
    env = RobotWalk(params, device=dev)
    over = dict(solver="pallas", member_contacts=not args.no_members)
    if args.iterations is not None:
        over["n_iterations"] = args.iterations
    m = env.model = dataclasses.replace(env.model, **over)
    st = env.physics_step.statics
    gen = torch.Generator(device=dev).manual_seed(0)
    state, _ = env.reset(n, gen)
    phys = state.physics
    card = card_name() if dev.type == "cuda" else "cpu"
    print(f"card: {card}; B={n}, row order {m.row_order}, {args.reps} reps per "
          "phase (host clock, synchronised)", flush=True)

    phases = []

    def phase(name, fn, note=lambda t: ""):
        t = timeit(fn, args.reps, dev)
        launches = device_launches(fn, dev)
        count = "" if launches is None else f"  {launches:6d} launches"
        print(f"{name:<21}{t * 1e3:8.3f} ms{count}{note(t)}", flush=True)
        phases.append({"phase": name.strip(" :"), "ms": t * 1e3, "launches": launches})
        return t

    def rate(t):
        return f"  ({n / t:,.0f} steps/s)"

    act = torch.zeros((n, env.action_size), device=dev)
    t_env = phase("full env step:", lambda: env.step(state, act, gen), rate)
    ns = m.n_slider
    mt = torch.zeros((n, ns), device=dev)
    me = torch.ones((n, ns), dtype=torch.bool, device=dev)
    t_phys = phase("physics step:", lambda: env.physics_step(phys, mt, me), rate)

    pos, quat = phys.pos.movedim(0, -1), phys.quat.movedim(0, -1)
    lin, ang = phys.lin_vel.movedim(0, -1), phys.ang_vel.movedim(0, -1)
    mtl, mel = mt.movedim(0, -1), me.movedim(0, -1)
    dt = env.physics_step.dt
    jd = bt._j_dtype(m)
    phase("  iinv_world:", lambda: bt._iinv_world(st, quat))
    phase("  floor contacts:", lambda: bt.detect_contacts(m, st, pos, quat))
    phase("  joint rows:",
          lambda: bt.build_joint_rows(m, st, pos, quat, mtl, mel, dt, j_dtype=jd))
    if st.n_dyn:
        phase("  member narrowphase:", lambda: bt._dyn_narrowphase(m, st, pos, quat))
        warm = (phys.dyn_vid.movedim(0, -1), phys.dyn_lambda.movedim(0, -1))
        iinv = bt._iinv_world(st, quat)
        phase("  member rows:", lambda: km.member_contact_rows(
            m, st, pos, quat, lin, ang, iinv, dt, warm_cache=warm, j_dtype=jd))

    # the sweep kernel alone: random rows, the spider's full-sweep metadata
    k = MAX_CONTACTS_PER_PAIR
    n_full = m.n_rows + st.n_pair * k + st.n_dyn + st.n_pair * k * 2 + st.n_dyn * 2
    nr_pad = -(-n_full // 32) * 32  # the TPU tool's padding: chunk 8 x 4 buffers
    fm = E._solver_meta(m, "full", st.n_pair, st.n_dyn)
    meta = se.make_envlast_meta(fm.idx6_a, fm.idx6_b, fm.parent, fm.mu, fm.kind, fm.skip_b,
                                n_full, dev)
    rng = np.random.default_rng(1)
    rows = torch.as_tensor(
        rng.standard_normal((nr_pad, se.ROW_FP, n)).astype(np.float32) * 0.01, device=dev)
    vel = torch.zeros((m.n_bodies * 6, n), device=dev)
    lam = torch.zeros((nr_pad, n), device=dev)
    calls = [0]
    launches0 = se.KERNEL.launches

    def sweep():
        calls[0] += 1
        return se.solver_sweep_envlast(rows, vel, lam, meta, m.n_iterations)

    phase("  sweep kernel:", sweep, lambda t: f"  ({n_full} rows, {m.n_iterations} iters)")
    print(f"{'obs/env overhead:':<21}{(t_env - t_phys) * 1e3:8.3f} ms", flush=True)
    print(json.dumps({
        "card": card, "envs": n, "row_order": m.row_order, "reps": args.reps,
        "phases": phases, "obs_env_overhead_ms": (t_env - t_phys) * 1e3,
        "sweep_rows": n_full, "sweep_calls": calls[0],
        "sweep_launches": se.KERNEL.launches - launches0,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # on a machine with a CUDA card and nvcc
    python3 chip_smoke.py --cpu      # rehearsal on the CPU: tiny batch, plain versions

Six paths run, each with its kernel: the batched spider ``robot_walk``
rollout (the fused slim sweep, ``kernels/csrc/sweep_envlast_slim.cu``), in
the canonical and in the ``scheduled`` row order (the slim sweep's groups
mode); the CLI's sequential ``run`` (one world, the per-env physics step,
the fat-row sweep ``kernels/csrc/solver_sweep.cu`` twice per spider step);
the two profilers of ``evomotion_tpu_torch.tools`` (the env-last fat-row
sweep ``kernels/csrc/solver_sweep_envlast.cu``); the greedy eval of the
committed walker (``tools.eval_walk``) and the CLI's batched PPO ``train``,
both on the batched step and the slim sweep. Phases, each printed with its
seconds:

1. device: the card's name, power limit and top SM clock (nvidia-smi),
   torch and nvcc versions, the f32 matmul setting (no TF32);
2. build: nvcc builds the three kernels, one process each, started
   together, and prints their registers and spills;
3. kernel check: the slim sweep's inputs are captured at B=2048 from the
   first step after a reset of the spider, for bf16 rows (the shipped
   default) and f32 rows; the kernel runs on all envs, its plain PyTorch
   version on the card on 256 of them, and the outputs must agree within TOL;
   each launch plan is printed (blocks, envs per block, threads, shared
   memory, stages, copy path, and the CUDA runtime's resident blocks per SM
   for it on this card) with ptxas's registers and spills of the kernel
   instance launched, and the chain estimate beside the roofline bound;
4. step check: one batched physics step of 4 of those envs on the card
   (kernel) against the same step on the CPU (plain version), f32 rows;
5. groups check: the same first step under ``row_order="scheduled"``: the
   slim sweep on the permuted bf16 rows with the schedule's groups against
   its grouped plain version (256 envs), and one scheduled batched step of
   4 envs on the card against the CPU, f32 rows;
6. main path: ``RobotWalk`` at B=2048, ``reset`` (60 settle steps) and 120
   steps of uniform random actions from a seeded ``torch.Generator``; the
   outputs must be finite, the spider on the floor, and the slim sweep
   launched exactly once per physics step (launch counts set to 0 just
   before, read just after);
7. scheduled rollout: the same at B=2048 under ``scheduled`` (reset and 60
   steps), counted the same way; env-steps/s printed beside the canonical
   run's (a reading, not a claim);
8. fat kernel check: the fat-row sweep's inputs (push pass and velocity
   sweep) are captured from the first per-env spider step after a seeded
   reset; kernel and plain version on the card must agree within TOL at B=1,
   and on 64 slightly perturbed copies (the batched call shape); the push
   pass must leave some push velocity non-zero; the launch plan at B=1 and
   B=64 (blocks, threads, shared memory, stages, the CUDA runtime's resident
   blocks per SM) with ptxas's registers and spills; the velocity sweep and
   the push pass timed at B=1, the chain estimate beside the roofline bound;
9. per-env step check: that per-env spider step on the card (kernel)
   against the same step on the CPU (plain version);
10. per-env groups check: the same under ``scheduled``: the fat-row sweep's
    velocity sweep (permuted rows, the schedule's groups) against its grouped
    plain version at B=1 (and timed, beside phase 8's canonical sweep), and
    the per-env step on the card against the CPU;
11. sequential run path: ``cli.main([... "run" ...])`` on cartpole and
    cartpole3d (3 episodes each) and the spider robot_walk (1 episode),
    random agent; episode lines printed, returns finite, the fat-row sweep
    launched exactly once (cartpoles) or twice (spider) per physics step and
    the slim sweep never (counts set to 0 just before each env's run, read
    just after); each cartpole run's first fat-row sweep call is held
    against its plain version within TOL;
12. envlast kernel check: the env-last fat-row sweep at B=2048 with the
    spider's full-sweep metadata against its plain version on all envs, on
    ``prof_step``'s inputs (rows N(0, 1) * 0.01, small outputs; timed) and
    on rows at O(1) scale; each output within TOL and within REL_TOL of its
    own largest magnitude; its time, bound, chain estimate and launch plan;
13. profilers: ``tools.prof_kernel`` (five cases) and ``tools.prof_step``
    (phase times and launches), each once through its ``main``; the
    env-last sweep's launches (set to 0 just before each, read just after)
    must equal the sweep calls each tool reports;
14. walker eval, the serving path: ``tools.eval_walk.main`` on the port's
    copy of the committed walker (``ppo`` tier, its ``scheduled`` order, 64
    envs, the 1800-step win horizon, seed 999); the actor on the card
    against the CPU actor on the eval's first observations within
    POLICY_TOL, the mean valid steps within the first 400 above
    WALKER_EARLY_FLOOR; the slim sweep's kernel on the eval's first call
    (64 envs, scheduled rows with their groups) against its plain version
    within TOL; win rate, episode lengths, return and ms per env step
    printed; the slim sweep launched once per physics step (counts set to 0
    just before, read just after);
15. ppo train: ``cli.main([... "robot_walk", "ppo_gae", "--num_envs",
    "2048", ... "train", ...])`` for 3 iterations with the walker's recipe
    and ``EVOMOTION_PROFILE=1``: finite losses, moved params, ``save_0``
    loading back equal; rollout and update ms per iteration and env-steps/s
    printed; the slim sweep counted as in 14, and its kernel on the run's
    first call against its plain version within TOL; then a 200-step
    greedy eval of the saved actor at 16 envs;
16. the kernels line and the last line (one JSON object each).

Any failed check exits non-zero before the last line. Without a card (and
without ``--cpu``) the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import math
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

# |kernel - plain| bound on the sweep's outputs (vel6', lam', push_vel6).
# The two differ only by f32 rounding (FMA contraction, summation order):
# the plain version in f32 against f64 on spider rows differs by ~3e-6
# (|vel| up to ~16), while a wrong index, clamp or row order moves the
# outputs by far more than 1e-3.
TOL = 1e-3
# |kernel - plain| bound relative to max |plain| of each output, where the
# outputs are small (kernel #3 on prof_step's rows): the same rounding, while
# a dropped body, a wrong slot or a missing inv_eff moves an output by a
# large share of its own size.
REL_TOL = 1e-4
# envs of a captured full-batch sweep call that its plain version checks
N_CMP = 256
# |card step - CPU step| bound on pos, quat and velocities after one physics
# step with f32 rows: the same arithmetic, rounded in another order.
STEP_TOL = 1e-3
# published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s and
# fp32 outside the tensor cores, at the full 700 W power limit
H100_BYTES_PER_S = 3.35e12
H100_FP32_FLOPS = 67e12
REPLACES = "evomotion_tpu/physics/solver_pallas.py:656"
TPU_KERNEL = ("solver_sweep_envlast_slim -> _sweep_kernel_envlast_slim "
              "(evomotion_tpu/physics/solver_pallas.py:508, pallas_call :592)")
FAT_REPLACES = "evomotion_tpu/physics/solver_pallas.py:98"
ENVLAST_REPLACES = "evomotion_tpu/physics/solver_pallas.py:424"
ENVLAST_TPU_KERNEL = ("solver_sweep_envlast -> _sweep_kernel_envlast "
                      "(evomotion_tpu/physics/solver_pallas.py:300, pallas_call :375)")
FAT_TPU_KERNEL = ("solver_sweep -> _sweep_kernel "
                  "(evomotion_tpu/physics/solver_pallas.py:191, pallas_call :276)")
# An estimate, not a measurement: every sweep is a chain of dependent row
# visits per env, each reading velocities the previous visit may have
# written. Its dependent fp32 operations per visit, as counted here: a
# 12-term dot product (one multiply, then four levels of adds), rhs - jv,
# x inv_eff, + lam, the two-sided clamp (2), the impulse delta, and the
# velocity update (one FMA): 12. At an assumed 4-cycle fp32 latency a visit
# takes 48 cycles at the SM clock that nvidia-smi reports; the shared-memory
# round trips that every visit also pays are left out, so the true floor is
# higher. Kernels #1 and #3 add the push pass's chain, one more visit per
# contact normal row. Printed beside the roofline bound, apart from the
# kernels line, which holds only what this run measured and the bound.
CHAIN_OPS = 12
FP32_LATENCY_CYCLES = 4
SEQ_EPISODES = {"cartpole": 3, "cartpole3d": 3, "robot_walk": 1}
SCHEDULED_STEPS = 60  # env steps of the scheduled rollout after its reset
# the walker eval: the JAX tool's defaults (64 envs, seed 999)
WALKER_ENVS, WALKER_SEED = 64, 999
# |card - CPU| bound on the walker actor's (mu, sigma): f32 matmuls on both
# (no TF32), summed in another order; mu and sigma are O(1)
POLICY_TOL = 1e-4
# the JAX package's floor for a non-degenerate gait: mean valid steps
# within the first 400 (tests/test_walker_artifact.py:117, the alt order's)
WALKER_EARLY_FLOOR = 100
EPISODE_LINE = re.compile(r"^episode (\d+): (\d+) steps, return (\S+)$")


def ptxas_report(build_log):
    """Per kernel function of an nvcc -Xptxas -v log: registers and spill
    bytes, ``[{"function", "registers", "spill_stores", "spill_loads"}]``."""
    out, cur = [], None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"function": m.group(1)}
            out.append(cur)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur is not None:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return out


def launch_info(kernel, plan, b, n_sms, instance, label, **which):
    """Prints a kernel's launch plan at ``b`` envs, the CUDA runtime's
    resident blocks per SM for it on this card (and the waves of blocks
    that gives over ``n_sms`` SMs), and ptxas's report of the kernel
    instance launched (the function whose mangled name holds ``instance``;
    ``which`` picks that instance for the occupancy query); returns them as
    the kernels line's ``launch`` object."""
    per_sm = kernel.blocks_per_sm(plan, **which)
    info = {**plan.describe(b), "blocks_per_sm": per_sm,
            "waves": -(-plan.blocks(b) // (per_sm * n_sms)) if per_sm else None,
            "ptxas": [f for f in ptxas_report(kernel.build_log)
                      if instance in f["function"]]}
    print(f"{label} launch plan at B={b}: " + ", ".join(
        f"{k} {v}" for k, v in info.items() if k != "ptxas"), flush=True)
    for f in info["ptxas"]:
        print(f"{label} ptxas: {f.get('registers')} registers, spill stores "
              f"{f.get('spill_stores')} B, loads {f.get('spill_loads')} B ({f['function']})",
              flush=True)
    return info


def phase(name):
    print(f"== {name}", flush=True)
    return time.perf_counter()


def done(name, t0):
    print(f"== {name}: {time.perf_counter() - t0:.2f} s", flush=True)


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


class SweepCapture:
    """Stands in for a sweep module where a step module looks it up
    (``step_module.<alias>``): counts the calls of its entry ``fn_name`` and,
    while armed, keeps a copy of each call's inputs in ``captured`` (of the
    first ``limit`` calls, where a limit is given)."""

    def __init__(self, sweep_module, step_module, alias, fn_name):
        self.sp = sweep_module
        self.calls = 0
        self.armed = False
        self.limit = None
        self.captured = []
        self._orig = getattr(sweep_module, fn_name)
        setattr(self, fn_name, self._call)
        setattr(step_module, alias, self)

    def __getattr__(self, name):
        return getattr(self.sp, name)

    @property
    def inputs(self):
        return self.captured[0] if self.captured else None

    def _call(self, *args):
        self.calls += 1
        if self.armed and (self.limit is None or len(self.captured) < self.limit):
            self.captured.append([a.clone() if hasattr(a, "clone") else a for a in args])
        return self._orig(*args)

    def arm(self, limit=None):
        self.captured = []
        self.limit = limit
        self.armed = True


# fp32 operations per row visit, counted as each kernel does them: (body A
# with the impulse update, body B's extra); csrc/sweep_envlast_slim.cu
# recomputes dv and eff (61, +56), the fat-row kernels csrc/solver_sweep.cu
# and csrc/solver_sweep_envlast.cu read them (J_a.v_a 12, impulse update 3,
# delta 1, body A's update 12: 28; body B's J.v and update: +25)
SLIM_OPS = (61, 56)
FAT_OPS = (28, 25)


def sweep_flops(rows, ops, n_iters, b):
    """fp32 operations of one sweep call: per row ``(kind, has_b, push)``,
    ``ops`` (see SLIM_OPS), the clamp by kind (joint 2, normal 1, friction
    4), and the split-impulse pass of a contact normal row (29, +25 with
    body B)."""
    base, body_b = ops
    per_env_iter = sum(base + (2, 1, 4)[kind] + (body_b if has_b else 0)
                       + ((29 + (25 if has_b else 0)) if push else 0)
                       for kind, has_b, push in rows)
    return per_env_iter * n_iters * b


def rows_with_push(meta):
    """(kind, has_b, push) per row of a slim or env-last sweep meta."""
    return [(kind, not skip_b, pslot >= 0) for _a, _b, kind, _p, skip_b, pslot, *_ in meta.rows]


def fat_rows(meta):
    """(kind, has_b, push) per row of a fat-row sweep meta."""
    return [(kind, ib6 >= 0, False) for _a, ib6, kind, _p, _mu in meta.rows]


def bound(tensors, flops):
    """Least time for one call: ``tensors`` (each input read once, each
    output written once) over HBM bandwidth, or ``flops`` over the fp32
    peak. Returns (ms, "bytes" or "operations", bytes)."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = flops / H100_FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes


def max_err(a_list, b_list):
    return max(float((a - b).abs().max()) for a, b in zip(a_list, b_list))


def fat_check(inp, cpu, label):
    """Runs the fat-row sweep (the plain version on the CPU) and its plain
    version on the same inputs; fails unless they agree within TOL. Returns
    (outputs, max |diff|, plain version's milliseconds on the host clock)."""
    import torch

    from evomotion_tpu_torch.kernels import sweep_fat as sf

    def sync():
        if not cpu:
            torch.cuda.synchronize()

    out = sf.sweep_fat_plain(*inp) if cpu else sf.solver_sweep(*inp)
    sync()
    ts = time.perf_counter()
    ref = sf.sweep_fat_plain(*inp)
    sync()
    plain_ms = (time.perf_counter() - ts) * 1e3
    err = max_err(out, ref)
    print(f"{label}: max |kernel - plain| {err:.3e} (tol {TOL:g}); plain version "
          f"{plain_ms:.1f} ms (host clock, synchronised)", flush=True)
    if not err <= TOL:  # NaN fails too
        fail(f"fat sweep kernel ({label}) disagrees with its plain version: {err}")
    return out, err, plain_ms


def print_chain(visits, clock_mhz, bound_ms):
    """Prints the chain estimate (see CHAIN_OPS) of ``visits`` dependent row
    visits beside the roofline bound."""
    if not clock_mhz:
        print("estimate of the row-visit chain: not computed (no SM clock reading)", flush=True)
        return
    est = visits * CHAIN_OPS * FP32_LATENCY_CYCLES / (clock_mhz * 1e3)
    print(f"estimate, not measured: a chain of {visits} dependent row visits x "
          f"{CHAIN_OPS * FP32_LATENCY_CYCLES} cycles (assumed fp32 latency, shared-memory "
          f"round trips left out) at the reported {clock_mhz:.0f} MHz -> {est:.4f} ms, "
          f"beside the roofline bound {bound_ms:.6g} ms", flush=True)


def sweep_visits(meta, n_iters):
    """Dependent row visits per env of a kernel #1 or #3 call: every row,
    and the push pass's visit of each contact normal row, each iteration."""
    return n_iters * sum(1 + (pslot >= 0) for _a, _b, _k, _p, _s, pslot, *_ in meta.rows)


def cuda_ms(fn, reps):
    """Mean milliseconds of ``fn()`` over ``reps`` back-to-back calls (CUDA
    events, after one warm-up call)."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def fat_kernel_check(args, dev, cpu, params, fat_cap, clock_mhz, card):
    """Phase 8: the fat-row sweep against its plain version on real spider
    rows (push pass and velocity sweep of one per-env step) at B=1, and on
    64 perturbed copies of the velocity sweep's inputs; its time and bound."""
    import torch

    from evomotion_tpu_torch.envs.robot import RobotWalk
    from evomotion_tpu_torch.kernels import sweep_fat as sf

    t0 = phase("fat kernel check")
    env = RobotWalk(params, mt_seed=args.seed, device=dev, per_env_step=True)
    state, _ = env.reset(1)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 2)
    action = torch.rand((1, env.action_size), generator=gen, device=dev) * 2 - 1
    fat_cap.arm()
    env.step(state, action)
    fat_cap.armed = False
    if len(fat_cap.captured) != 2:
        fail(f"expected 2 fat sweep calls in one spider step, got {len(fat_cap.captured)}")
    push_in, full_in = fat_cap.captured

    errs, times, outs = {}, {}, {}
    for label, inp in (("push", push_in), ("full", full_in)):
        rows, vel6, lam0, meta, n_iters = inp
        print(f"{label}: rows {tuple(rows.shape)}, vel6 {tuple(vel6.shape)}, iters {n_iters}",
              flush=True)
        outs[label], errs[label], plain_ms = fat_check(inp, cpu, label)
        if label == "full":
            times["plain_ms"] = plain_ms
    # the push pass starts from zero velocities; the settled spider presses
    # into the floor, so its correction velocities cannot all be zero
    push_max = float(outs["push"][0].abs().max())
    print(f"push: max |push velocity| {push_max:.3e}", flush=True)
    if not push_max > 0.0:
        fail("the push pass left every push velocity at zero")

    # the batched call shape (the JAX per-env solver's vmap rule): 64 copies
    # of the velocity sweep's inputs, each slightly perturbed
    rows, vel6, lam0, meta, n_iters = full_in
    g = torch.Generator(device=dev).manual_seed(args.seed + 3)

    def copies(x, scale):
        noise = torch.randn((64,) + tuple(x.shape[1:]), generator=g, device=dev)
        return (x.expand((64,) + tuple(x.shape[1:])) * (1 + scale * noise)).contiguous()

    in64 = [copies(rows, 1e-3), copies(vel6, 1e-3), copies(lam0, 1e-3), meta, n_iters]
    _, errs["full_b64"], _ = fat_check(in64, cpu, "full, B=64 perturbed copies")

    launch = None
    if not cpu:
        n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
        rare = meta.rare  # the instance this meta launches (the spider's: no RARE hand-over)
        for b, inp in ((64, in64), (1, full_in)):  # the launch of the kernels line last
            launch = launch_info(sf.KERNEL, sf.KERNEL.plan_for(inp[0], inp[1]), b, n_sms,
                                 f"solver_sweep_kernelILb{int(rare)}", "fat kernel", rare=rare)

    flops = sweep_flops(fat_rows(meta), FAT_OPS, n_iters, rows.shape[0])
    # the metadata a row needs: its table's four index words and mu (the
    # table's padding is the kernel's layout, not work)
    nr = rows.shape[1]
    bound_ms, bound_by, nbytes = bound(
        (rows, vel6, lam0, meta.table[:nr, :4], meta.table[:nr, 6], *outs["full"]), flops)
    print(f"bound: {nbytes / 1e3:.1f} kB, {flops / 1e6:.3f} MFLOP -> "
          f"{bound_ms * 1e3:.4f} us ({bound_by})", flush=True)
    print_chain(n_iters * nr, clock_mhz, bound_ms)
    if not cpu:
        times["ms"] = cuda_ms(lambda: sf.solver_sweep(*full_in), 20)
        times["push_ms"] = cuda_ms(lambda: sf.solver_sweep(*push_in), 20)
        push_visits = push_in[4] * push_in[0].shape[1]
        print(f"fat sweep kernel ms/call at B=1 (CUDA events): full {times['ms']:.4f} "
              f"({n_iters * nr} row visits, {times['ms'] * 1e6 / (n_iters * nr):.1f} ns "
              f"each), push {times['push_ms']:.4f} ({push_visits} row visits, "
              f"{times['push_ms'] * 1e6 / push_visits:.1f} ns each); plain version full "
              f"{times['plain_ms']:.1f} [{card}]", flush=True)
    done("fat kernel check", t0)
    return {"env": env, "state": state, "action": action, "errs": errs, "times": times,
            "bound_ms": bound_ms, "bound_by": bound_by, "launch": launch}


def perenv_step_check(fat, dev, cpu, name="per-env step check"):
    """One per-env spider step on the card (kernels) against the same step
    on the CPU (plain versions): phase 9, and phase 10 under scheduled."""
    import torch

    from evomotion_tpu_torch.physics.perenv import PerEnvStep

    t0 = phase(name)
    if not cpu:
        env, state = fat["env"], fat["state"]
        tgt = fat["action"] * env._speed
        on = torch.ones((1, env.model.n_slider), dtype=torch.bool, device=dev)
        card, _ = env.physics_step(state.physics, tgt, on)
        host_step = PerEnvStep(env.model, env.physics_step.dt, device="cpu")
        host, _ = host_step(type(state.physics)(*(x.cpu() for x in state.physics)), tgt.cpu(),
                            on.cpu())
        err = max(float((getattr(card, f).cpu() - getattr(host, f)).abs().max())
                  for f in ("pos", "quat", "lin_vel", "ang_vel"))
        print(f"max |card - cpu| after one per-env spider step, row order "
              f"{env.model.row_order}: {err:.3e} (tol {STEP_TOL:g})", flush=True)
        if not err <= STEP_TOL:
            fail(f"per-env card step disagrees with the CPU step: {err}")
    done(name, t0)


def sequential_run(args, dev, cpu, card, cap, fat_cap):
    """Phase 11: the CLI's sequential ``run`` on each env, random agent. The
    launch counts and a count of per-env physics steps are set to 0 just
    before each run and read just after. The first fat-row sweep call of
    each cartpole run is captured and, after the counts are read, held
    against its plain version (the spider's calls are held in phase 6)."""
    import torch

    from evomotion_tpu_torch import cli
    from evomotion_tpu_torch.kernels import sweep as sp
    from evomotion_tpu_torch.kernels import sweep_fat as sf
    from evomotion_tpu_torch.physics import perenv

    t0 = phase("sequential run path")
    steps = [0]
    run_once = perenv.PerEnvStep._run

    def counted(self, *a):
        steps[0] += 1
        return run_once(self, *a)

    perenv.PerEnvStep._run = counted
    total, errs = 0, {}
    try:
        for env_name, episodes in SEQ_EPISODES.items():
            argv = ["cli", env_name, "random", "--env_seed", str(args.seed)]
            if cpu:  # rehearsal: one short episode each
                episodes = 1
                if env_name == "robot_walk":
                    argv += ["--env_parameters", "reset_frames=1",
                             "initial_remaining_seconds=0.05"]
            argv += ["run", ".", "--episodes", str(episodes)]
            buf = io.StringIO()
            if env_name != "robot_walk":
                fat_cap.arm(limit=1)
            sp.KERNEL.launches = sf.KERNEL.launches = 0
            cap.calls = fat_cap.calls = steps[0] = 0
            ts = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(argv, device=dev)
            if not cpu:
                torch.cuda.synchronize()
            wall = time.perf_counter() - ts
            n_phys, launches, calls = steps[0], sf.KERNEL.launches, fat_cap.calls
            slim = (sp.KERNEL.launches, cap.calls)
            fat_cap.armed = False
            lines = [m for m in map(EPISODE_LINE.match, buf.getvalue().splitlines()) if m]
            for m in lines:
                print(f"{env_name}: {m.group(0)}", flush=True)
            per_step = 2 if env_name == "robot_walk" else 1
            env_steps = sum(int(m.group(2)) for m in lines)
            print(f"{env_name}: {n_phys} physics steps, fat sweep calls {calls}, kernel "
                  f"launches {launches}, slim sweep launches/calls {slim}", flush=True)
            if rc != 0 or len(lines) != episodes:
                fail(f"{env_name}: run returned {rc} with {len(lines)} episode lines")
            if not all(math.isfinite(float(m.group(3))) for m in lines):
                fail(f"{env_name}: non-finite episode return")
            if calls != per_step * n_phys or (not cpu and launches != calls) or slim != (0, 0):
                fail(f"{env_name}: expected {per_step} fat sweep launches per physics step "
                     f"and no slim sweep, got {launches} launches / {calls} calls in "
                     f"{n_phys} physics steps, slim {slim}")
            print(f"{env_name}: {wall:.2f} s, {env_steps / wall:.1f} env-steps/s, "
                  f"{wall / n_phys * 1e3:.2f} ms per physics step (host clock, "
                  f"{n_phys} physics steps incl. reset settling) [{card}]", flush=True)
            total += launches
            if fat_cap.captured:
                inp, fat_cap.captured = fat_cap.inputs, []
                _, errs[env_name], _ = fat_check(
                    inp, cpu, f"{env_name}: first sweep call, rows {tuple(inp[0].shape)}")
    finally:
        perenv.PerEnvStep._run = run_once
        fat_cap.armed = False
    if set(errs) != {"cartpole", "cartpole3d"}:
        fail(f"no fat sweep call captured from a cartpole run: {sorted(errs)}")
    done("sequential run path", t0)
    return {"launches": total, "errs": errs}


def slim_check(inp, out, n_cmp, label):
    """The slim sweep's plain version on the first ``n_cmp`` envs of ``inp``
    against the kernel's outputs ``out``; fails unless within TOL. Returns
    the largest difference."""
    import torch

    from evomotion_tpu_torch.kernels import sweep as sp

    sub = [x[..., :n_cmp].contiguous() if torch.is_tensor(x) else x for x in inp]
    ts = time.perf_counter()
    ref = sp.sweep_plain(*sub)
    if sub[0].is_cuda:
        torch.cuda.synchronize()
    print(f"{label}: plain version on {n_cmp} envs {time.perf_counter() - ts:.2f} s",
          flush=True)
    err = [float((a[..., :n_cmp] - b).abs().max()) for a, b in zip(out, ref)]
    print(f"{label}: max |kernel - plain| vel6 {err[0]:.3e} lam {err[1]:.3e} "
          f"push {err[2]:.3e} (tol {TOL:g})", flush=True)
    if not all(x <= TOL for x in err):  # NaN fails too
        fail(f"{label} sweep kernel disagrees with its plain version: {err}")
    return max(err)


def captured_check(inp, cpu, label):
    """The slim sweep's kernel on one captured call's inputs against its
    plain version on the first N_CMP envs (fails unless within TOL);
    returns the largest difference. On the CPU, the plain version twice."""
    import torch

    from evomotion_tpu_torch.kernels import sweep as sp

    if inp is None:
        fail(f"{label}: no slim sweep call was captured")
    meta = inp[5]
    print(f"{label}: rows {tuple(inp[0].shape)} {inp[0].dtype}, "
          f"{len(meta.groups or ())} groups", flush=True)
    out = sp.sweep_plain(*inp) if cpu else sp.solver_sweep_envlast_slim(*inp)
    if not cpu:
        torch.cuda.synchronize()
    return slim_check(inp, out, min(N_CMP, inp[0].shape[-1]), label)


def batched_step_check(env, state, action, n, dev, label):
    """One batched physics step of ``n`` envs on the card (kernel) against
    the same step on the CPU (plain version); returns the largest difference."""
    import torch

    from evomotion_tpu_torch.envs.robot import RobotWalk

    cpu_env = RobotWalk(env.params, device="cpu")
    cpu_env.model = env.model
    few = type(state.physics)(*(x[:n] for x in state.physics))
    tgt = action[:n] * env._speed
    on = torch.ones((n, env.model.n_slider), dtype=torch.bool, device=dev)
    card, _ = env.physics_step(few, tgt, on)
    host, _ = cpu_env.physics_step(type(few)(*(x.cpu() for x in few)), tgt.cpu(), on.cpu())
    err = max(float((getattr(card, f).cpu() - getattr(host, f)).abs().max())
              for f in ("pos", "quat", "lin_vel", "ang_vel"))
    print(f"max |card - cpu| after one step, {label}, {n} envs: {err:.3e} "
          f"(tol {STEP_TOL:g})", flush=True)
    if not err <= STEP_TOL:
        fail(f"card step ({label}) disagrees with the CPU step: {err}")
    return err


def groups_check(env, env32, state, action, cap, n_cmp, dev, cpu):
    """Phase 5: the slim sweep in the scheduled order, with its groups,
    against its grouped plain version, and one scheduled batched step on the
    card against the CPU. Returns the sweep's largest difference."""
    import torch

    from evomotion_tpu_torch.envs.robot import RobotWalk
    from evomotion_tpu_torch.kernels import sweep as sp

    t0 = phase("groups check")
    sched = RobotWalk(env.params, device=dev)
    sched.model = dataclasses.replace(env.model, row_order="scheduled")
    cap.arm()
    sched.step(state, action, torch.Generator(device=dev).manual_seed(0))
    cap.armed = False
    inp = cap.inputs
    meta = inp[5]
    sizes = [z for _, z in meta.groups or ()]
    print(f"scheduled: rows {tuple(inp[0].shape)} {inp[0].dtype}, {len(sizes)} groups, "
          f"{sum(z > 1 for z in sizes)} of them with several rows "
          f"(largest {max(sizes, default=0)})", flush=True)
    if not sizes or max(sizes) < 2:
        fail("the scheduled order's meta carries no groups of several rows")
    out = sp.sweep_plain(*inp) if cpu else sp.solver_sweep_envlast_slim(*inp)
    if not cpu:
        torch.cuda.synchronize()
    err = slim_check(inp, out, n_cmp, "scheduled bf16")
    if not cpu:
        s32 = RobotWalk(env.params, device=dev)
        s32.model = dataclasses.replace(env32.model, row_order="scheduled")
        batched_step_check(s32, state, action, 4, dev, "scheduled, f32 rows")
    done("groups check", t0)
    return err


def batched_rollout(env, n_envs, n_steps, seed, cap, dev, cpu, card, label):
    """A batched path: reset (settle steps) then ``n_steps`` steps of
    uniform random actions. The slim sweep's counts are set to 0 just before
    and read just after; it must have launched once per physics step. The
    outputs must be finite and the spider on the floor. Returns the
    readings."""
    import torch

    from evomotion_tpu_torch.kernels import sweep as sp

    gen = torch.Generator(device=dev).manual_seed(seed)
    sp.KERNEL.launches = 0
    cap.calls = 0
    ts = time.perf_counter()
    state, res = env.reset(n_envs, gen)
    if not cpu:
        torch.cuda.synchronize()
    t_reset = time.perf_counter() - ts
    root = env.meta.root_body
    sk = env._skeleton
    root_y0 = state.physics.pos[:, root, 1]
    ts = time.perf_counter()
    rewards, ended, y_lo, y_hi = [], [], [], []
    for _ in range(n_steps):
        action = torch.rand((n_envs, env.action_size), generator=gen, device=dev) * 2 - 1
        state, res = env.step(state, action, gen)
        rewards.append(res.reward)
        ended.append(res.done)
        ys = state.physics.pos[:, sk, 1]
        y_lo.append(ys.amin())
        y_hi.append(ys.amax())
    if not cpu:
        torch.cuda.synchronize()
    t_steps = time.perf_counter() - ts
    launches, calls = sp.KERNEL.launches, cap.calls
    want = env.settle_total + n_steps
    print(f"{label}: sweep calls {calls}, kernel launches {launches}, physics steps {want}",
          flush=True)
    if calls != want or (not cpu and launches != want):
        fail(f"{label}: expected {want} sweep kernel launches (one per physics step), "
             f"got {launches} launches of {calls} calls")
    rewards = torch.stack(rewards)
    finite = all(torch.isfinite(x.float()).all() for x in (res.obs, rewards, *state.physics))
    if not finite:
        fail(f"{label}: non-finite obs, rewards or physics state")
    if tuple(res.obs.shape) != (n_envs, env.observation_size):
        fail(f"{label}: obs shape {tuple(res.obs.shape)}")
    y_lo, y_hi = float(torch.stack(y_lo).min()), float(torch.stack(y_hi).max())
    drift = float((state.physics.pos[:, root] - torch.tensor([1.0, 0.25, 2.0], device=dev))
                  [:, [0, 2]].abs().max())
    q = torch.quantile(root_y0.float().cpu(), torch.tensor([0.0, 0.05, 0.5, 0.95, 1.0]))
    print(f"{label}: after reset: root y min/5%/50%/95%/max "
          + " ".join(f"{x:.3f}" for x in q.tolist()), flush=True)
    print(f"{label}: over {n_steps} steps: body y in [{y_lo:.3f}, {y_hi:.3f}], root xz drift "
          f"max {drift:.3f}, episodes ended {int(torch.stack(ended).sum())} of {n_envs} envs, "
          f"mean reward {float(rewards.mean()):.4f}", flush=True)
    # The floor is the 2 m thick cube between y=-3 and y=-1. Random muscle
    # actions press members some way into it (split-impulse correction is
    # soft) but a body that went through would fall on below y=-1.5 within
    # the run; nothing the muscles do flings a body 5 m up or 20 m away.
    if not (y_lo > -1.5 and y_hi < 5.0):
        fail(f"{label}: spider through the floor or flown off")
    if drift > 20.0:
        fail(f"{label}: spider root drifted impossibly far")
    # spawned at y=0.25 with a random tilt, the spider has come down onto the
    # floor after the 60 settle steps (1 s) of a full reset; some land propped
    # on their legs, so the check is on the median and the extremes
    if not cpu and not (q[0] > -1.0 and q[2] < 0.0 and q[4] < 1.5):
        fail(f"{label}: spider did not settle on the floor during reset")
    sps = n_envs * n_steps / t_steps
    print(f"{label}: reset ({env.settle_total} settle steps) {t_reset:.2f} s; {n_steps} steps "
          f"{t_steps:.2f} s", flush=True)
    print(f"{label}: env-steps/s {sps:.1f} at B={n_envs} [{card}]", flush=True)
    return {"launches": launches, "sps": sps, "step_ms": t_steps / n_steps * 1e3}


def perenv_groups_check(args, dev, cpu, params, fat_cap, fat, card):
    """Phase 10: the fat-row sweep's velocity sweep in the scheduled order
    (permuted rows, the schedule's groups) against its grouped plain version
    at B=1, from the first per-env spider step after a seeded reset, and
    timed beside phase 8's canonical sweep (``fat``); then that per-env step
    on the card against the CPU. Returns (largest difference, ms per
    scheduled velocity sweep or None)."""
    import torch

    from evomotion_tpu_torch.envs.robot import RobotWalk

    t0 = phase("per-env groups check")
    env = RobotWalk(params, mt_seed=args.seed, device=dev, per_env_step=True)
    env.model = dataclasses.replace(env.model, row_order="scheduled")
    state, _ = env.reset(1)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 2)
    action = torch.rand((1, env.action_size), generator=gen, device=dev) * 2 - 1
    fat_cap.arm()
    env.step(state, action)
    fat_cap.armed = False
    if len(fat_cap.captured) != 2:
        fail(f"expected 2 fat sweep calls in one spider step, got {len(fat_cap.captured)}")
    push_in, full_in = fat_cap.captured
    if push_in[3].groups is not None or not full_in[3].groups:
        fail("scheduled per-env step: the velocity sweep must carry groups, the push pass none")
    errs = [fat_check(inp, cpu, f"scheduled {label}")[1]
            for label, inp in (("push", push_in), ("full", full_in))]
    ms = None
    if not cpu:
        from evomotion_tpu_torch.kernels import sweep_fat as sf

        ms = cuda_ms(lambda: sf.solver_sweep(*full_in), 20)
        visits = full_in[4] * full_in[0].shape[1]
        canon = fat["times"]["ms"]
        print(f"fat sweep kernel ms/call at B=1 (CUDA events), velocity sweep: scheduled "
              f"{ms:.4f} ({ms * 1e6 / visits:.1f} ns per visit), canonical {canon:.4f} "
              f"({canon * 1e6 / visits:.1f} ns); scheduled / canonical {ms / canon:.3f}; a "
              f"reading [{card}]", flush=True)
    done("per-env groups check", t0)
    perenv_step_check({"env": env, "state": state, "action": action}, dev, cpu,
                      "per-env scheduled step check")
    return max(errs), ms


def o1_envlast_rows(fm, n_bodies, nr_pad, n_envs, dev, seed):
    """Env-last rows for the spider's full-sweep metadata ``fm`` at O(1)
    scale, built as a caller builds them: J ~ N(0, 0.25) (J_b zero where
    body B is static), dv = Minv J^T with a diagonal Minv of per-body,
    per-env inverse masses in [0.5, 2], inv_eff = 1 / (J Minv J^T),
    rhs ~ N(0, 1), joint bounds +-2|N(0, 1)|, rhs_push |N(0, 1)| on contact
    normal rows; velocities N(0, 1), impulses 0.1 |N(0, 1)| (padding rows
    too). Returns (rows, vel6, lam0)."""
    import torch

    from evomotion_tpu_torch.kernels import sweep as sp
    from evomotion_tpu_torch.kernels import sweep_envlast as se

    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    n = len(fm.idx6_a)
    j = randn(n, 12, n_envs) * 0.5
    j[torch.as_tensor(fm.skip_b, device=dev), 6:] = 0.0
    inv_m = 0.5 + 1.5 * torch.rand((n_bodies, 6, n_envs), generator=g, device=dev)
    ia = torch.as_tensor(fm.idx6_a // 6, dtype=torch.int64, device=dev)
    ib = torch.as_tensor(fm.idx6_b // 6, dtype=torch.int64, device=dev)
    dv = torch.cat([inv_m[ia] * j[:, :6], inv_m[ib] * j[:, 6:]], 1)
    normal = torch.as_tensor(fm.kind == sp.KIND_NORMAL, device=dev)
    rows = torch.zeros((nr_pad, se.ROW_FP, n_envs), device=dev)
    rows[:n, 0:12], rows[:n, 12:24] = j, dv
    rows[:n, 24] = randn(n, n_envs)
    rows[:n, 25] = -randn(n, n_envs).abs() * 2
    rows[:n, 26] = randn(n, n_envs).abs() * 2
    rows[:n, 27] = 1.0 / (j * dv).sum(1)
    rows[:n, 28] = randn(n, n_envs).abs() * normal[:, None]
    return rows, randn(n_bodies * 6, n_envs), randn(nr_pad, n_envs).abs() * 0.1


def envlast_inputs(seed, n_envs, dev):
    """Phase 12's inputs at ``prof_step``'s shape: its model (the shipped
    spider, pallas solver, member contacts on), the env-last meta of its
    full sweep, and two input sets, ``prof_step``'s own (rows N(0, 1) *
    0.01, zero velocities and impulses) and rows at O(1) scale
    (:func:`o1_envlast_rows`). Returns (model, meta, sets)."""
    import numpy as np
    import torch

    from evomotion_tpu_torch.envs.robot import RobotWalk
    from evomotion_tpu_torch.kernels import sweep_envlast as se
    from evomotion_tpu_torch.physics import engine as E

    m = dataclasses.replace(RobotWalk(device="cpu").model, solver="pallas",
                            member_contacts=True)
    fm = E._solver_meta(m, "full", E.n_manifold_pairs(m), E._n_dyn_contacts(m))
    n_full = len(fm.idx6_a)
    nr_pad = -(-n_full // 32) * 32
    meta = se.make_envlast_meta(fm.idx6_a, fm.idx6_b, fm.parent, fm.mu, fm.kind, fm.skip_b,
                                n_full, dev)
    rng = np.random.default_rng(seed + 1)
    rows = torch.as_tensor(
        rng.standard_normal((nr_pad, se.ROW_FP, n_envs)).astype(np.float32) * 0.01, device=dev)
    sets = {
        "prof_step rows": (rows, torch.zeros((m.n_bodies * 6, n_envs), device=dev),
                           torch.zeros((nr_pad, n_envs), device=dev)),
        "O(1) rows": o1_envlast_rows(fm, m.n_bodies, nr_pad, n_envs, dev, seed + 4),
    }
    return m, meta, sets


def envlast_errors(out, ref):
    """Per output of the env-last sweep: (name, max |kernel - plain|,
    max |plain|, whether it is within TOL and within REL_TOL x max |plain|)."""
    res = []
    for name, a, b in zip(("vel6", "lam", "push"), out, ref):
        err, mag = float((a - b).abs().max()), float(b.abs().max())
        res.append((name, err, mag, err <= TOL and err <= REL_TOL * mag))  # NaN fails
    return res


def envlast_kernel_check(args, dev, cpu, n_envs, card, clock_mhz):
    """Phase 12: the env-last fat-row sweep against its plain version on
    all envs of both input sets of :func:`envlast_inputs` (the first also
    timed, CUDA events); each output must pass :func:`envlast_errors`,
    padding rows keep their impulses and the push pass moves bodies. Prints
    the launch plan and the chain estimate beside the bound."""
    import torch

    from evomotion_tpu_torch.kernels import sweep_envlast as se

    t0 = phase("envlast kernel check")
    m, meta, sets = envlast_inputs(args.seed, n_envs, dev)
    n_iters = m.n_iterations
    n_full = len(meta.rows)
    rows = sets["prof_step rows"][0]
    print(f"rows {tuple(rows.shape)} ({n_full} visited), vel6 ({m.n_bodies * 6}, {n_envs}), "
          f"iters {n_iters}", flush=True)
    times, errs, rel = {}, [], []
    for label, inp in sets.items():
        if cpu:
            out = ref = se.sweep_envlast_plain(*inp, meta, n_iters)
        else:
            out = se.solver_sweep_envlast(*inp, meta, n_iters)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            ref = se.sweep_envlast_plain(*inp, meta, n_iters)
            end.record()
            torch.cuda.synchronize()
            if not times:
                times["plain_ms"] = start.elapsed_time(end)
                times["ms"] = cuda_ms(lambda: se.solver_sweep_envlast(*inp, meta, n_iters), 10)
        for name, err, mag, ok in envlast_errors(out, ref):
            print(f"{label}: {name}: max |kernel - plain| {err:.3e}, max |plain| {mag:.3e} "
                  f"(tol {TOL:g} and {REL_TOL:g} x max |plain|)", flush=True)
            if not ok:
                fail(f"envlast sweep kernel disagrees with its plain version on {label}, "
                     f"{name}: {err} against max |plain| {mag}")
            errs.append(err)
            rel.append(err / mag if mag else 0.0)
        if not torch.equal(out[1][n_full:], inp[2][n_full:]) or not float(out[2].abs().max()) > 0:
            fail(f"envlast sweep ({label}): padding rows changed or the push pass did nothing")
    inp = sets["prof_step rows"]
    out = (inp[1], inp[2], inp[1])  # the outputs' shapes, for the bytes written
    flops = sweep_flops(rows_with_push(meta), FAT_OPS, n_iters, n_envs)
    bound_ms, bound_by, nbytes = bound((*inp, meta.table, *out), flops)
    print(f"bound: {nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP -> {bound_ms:.4f} ms "
          f"({bound_by})", flush=True)
    print_chain(sweep_visits(meta, n_iters), clock_mhz, bound_ms)
    launch = None
    if not cpu:
        pl = se.KERNEL.plan_for(rows, inp[1], meta)
        launch = launch_info(se.KERNEL, pl, n_envs,
                             torch.cuda.get_device_properties(dev).multi_processor_count,
                             f"kernelILi{pl.envs}E", "envlast kernel")
        print(f"envlast kernel {times['ms']:.3f} ms/call, plain version {times['plain_ms']:.1f} "
              f"ms/call, at B={n_envs} on prof_step's rows (CUDA events) [{card}]", flush=True)
    done("envlast kernel check", t0)
    return {"err": max(errs), "rel_err": max(rel), "times": times, "bound_ms": bound_ms,
            "bound_by": bound_by, "launch": launch}


def run_tool(module, argv, label, **kw):
    """Runs a tool's ``main(argv, **kw)``, prints its output, returns its
    JSON line."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = module.main(argv, **kw)
    lines = buf.getvalue().splitlines()
    for line in lines[:-1]:
        print(f"{label}: {line}", flush=True)
    if rc != 0 or not lines:
        fail(f"{label} returned {rc}")
    return json.loads(lines[-1])


def profilers(dev, cpu):
    """Phase 13: both profilers once; the env-last sweep's launch count is
    set to 0 just before each and read just after, and must equal the sweep
    calls the tool reports."""
    import torch

    from evomotion_tpu_torch.kernels import sweep_envlast as se
    from evomotion_tpu_torch.tools import prof_kernel, prof_step

    t0 = phase("profilers")
    tiny = ["--device", "cpu"] if cpu else []
    runs = (
        (prof_kernel, "prof_kernel", tiny + (["--envs", "4", "--sizes", "16,32",
                                               "--size", "32"] if cpu else [])),
        (prof_step, "prof_step", tiny + (["--envs", "2", "--reps", "1", "--reset-frames",
                                          "1", "--iterations", "1"] if cpu else [])),
    )
    out = {}
    for module, label, argv in runs:
        se.KERNEL.launches = 0
        res = run_tool(module, argv, label)
        if not cpu:
            torch.cuda.synchronize()
        launches, calls = se.KERNEL.launches, res["sweep_calls"]
        print(f"{label}: envlast sweep calls {calls}, kernel launches {launches}", flush=True)
        if calls < 1 or (not cpu and launches != calls):
            fail(f"{label}: expected one envlast sweep launch per call, got {launches} "
                 f"launches of {calls} calls")
        out[label] = {"res": res, "launches": launches}
    done("profilers", t0)
    return out


def small_walker(cpu):
    """For the CPU rehearsal only: the walker tools' envs and eval horizons
    shrunk (``tools.rehearsal.small_walker``); on the card, nothing."""
    from evomotion_tpu_torch.tools.rehearsal import small_walker as shrink

    return shrink(3) if cpu else contextlib.nullcontext()


def walker_eval(args, dev, cpu, card, cap):
    """Phase 14, the serving path: ``tools.eval_walk.main`` on the port's
    copy of the committed walker (``ppo`` tier, its meta.json's row order,
    64 envs, the 1800-step win horizon, the tool's default seed 999). Gate
    1: the actor's (mu, sigma) on the card against the CPU actor on the
    eval's first observations (the same seeded reset) within POLICY_TOL.
    Gate 2: the mean valid steps within the first 400 env steps above
    WALKER_EARLY_FLOOR. Before the eval, the slim sweep's inputs of the
    eval's first step (this path's shapes: its env count and row order,
    with its groups) go through the kernel and its plain version, which
    must agree within TOL. The slim sweep's counts are set to 0 just before
    the eval and read just after: one launch per physics step."""
    import torch

    from evomotion_tpu_torch.envs.robot import RobotWalkFactory
    from evomotion_tpu_torch.kernels import sweep as sp
    from evomotion_tpu_torch.tools import eval_walk as ew

    t0 = phase("walker eval")
    n_envs = 2 if cpu else WALKER_ENVS
    with open(os.path.join(ew.WALKER_DIR, "meta.json")) as f:
        meta = json.load(f)
    with small_walker(cpu):
        env = RobotWalkFactory({}).make(WALKER_SEED, mt_parity=False, device=dev,
                                        per_env_step=False)
        env.model = dataclasses.replace(env.model, row_order=meta["eval_order"])
        gen = torch.Generator(device=dev).manual_seed(WALKER_SEED)
        est, first = env.reset(n_envs, gen)
        card_pol = ew.load_policy("ppo", ew.WALKER_DIR, env.observation_size,
                                  env.action_size, 256, dev)
        cpu_pol = ew.load_policy("ppo", ew.WALKER_DIR, env.observation_size,
                                 env.action_size, 256, "cpu")
        with torch.no_grad():
            got = card_pol.actor(card_pol.normalize(first.obs))
            ref = cpu_pol.actor(cpu_pol.normalize(first.obs.cpu()))
        pol_err = max(float((a.cpu() - b).abs().max()) for a, b in zip(got, ref))
        print(f"walker actor on the card vs the CPU on the eval's first observations "
              f"({n_envs} envs): max |diff| of (mu, sigma) {pol_err:.3e} (tol {POLICY_TOL:g}; "
              f"matmul precision {torch.get_float32_matmul_precision()}, TF32 "
              f"{torch.backends.cuda.matmul.allow_tf32})", flush=True)
        if not pol_err <= POLICY_TOL:
            fail(f"walker actor on the card disagrees with the CPU: {pol_err}")
        cap.arm(limit=1)
        env.step(est, card_pol(first.obs), gen)
        cap.armed = False
        kern_err = captured_check(cap.inputs, cpu, f"walker eval sweep, B={n_envs} "
                                  f"{meta['eval_order']}")
        want = env.settle_total + ew.WIN  # physics steps of the eval
        del env, est, first
        sp.KERNEL.launches = 0
        cap.calls = 0
        res = run_tool(ew, ["ppo", ew.WALKER_DIR, "--episodes", str(n_envs),
                            "--seed", str(WALKER_SEED)], "eval_walk", device=dev)
        launches, calls = sp.KERNEL.launches, cap.calls
    print(f"walker eval: sweep calls {calls}, kernel launches {launches}, physics steps "
          f"{want}", flush=True)
    if calls != want or (not cpu and launches != want):
        fail(f"walker eval: expected {want} slim sweep launches, got {launches} launches "
             f"of {calls} calls")
    if res["row_order"] != meta["eval_order"] or res["envs"] != n_envs:
        fail(f"walker eval ran {res['envs']} envs under {res['row_order']}")
    nums = [res[k] for k in ("win_rate", "mean_len", "median_len", "mean_return",
                             "early_steps_mean", "ms_per_step")]
    if not all(math.isfinite(x) for x in nums):
        fail(f"walker eval: non-finite result {nums}")
    print(f"walker eval [{card}]: win rate {res['win_rate']:.4f} ({res['wins']}/{n_envs}) over "
          f"the {res['win_horizon']}-step win horizon; episode length mean "
          f"{res['mean_len']:.2f}, median {res['median_len']:.1f}, max {res['max_len']}; "
          f"mean return {res['mean_return']:.3f}; {res['ms_per_step']:.3f} ms per env step "
          f"at B={n_envs} (host clock); reset {res['reset_s']:.2f} s", flush=True)
    print(f"walker eval: mean valid steps within the first {res['early_horizon']}: "
          f"{res['early_steps_mean']:.2f} (gate: > {WALKER_EARLY_FLOOR}; the JAX package's "
          f"bar for the primary order, 250, is a reading here: JAX's own median at seed "
          f"999 is 139)", flush=True)
    if not cpu and not res["early_steps_mean"] > WALKER_EARLY_FLOOR:
        fail(f"walker eval: mean valid steps within the first 400 "
             f"{res['early_steps_mean']} <= {WALKER_EARLY_FLOOR}")
    done("walker eval", t0)
    return {"launches": launches, "res": res, "policy_err": pol_err, "err": kern_err}


PROGRESS = re.compile(r"save 0 actor=(\S+) critic=(\S+) r/step=(\S+) ([\d,]+) env-steps/s "
                      r"\[(\d+)/(\d+)\]")
PROFILE = re.compile(r"(\w+): ([\d.]+)s/(\d+)x")


def ppo_train(args, dev, cpu, card, cap):
    """Phase 15, the CLI's batched ``train``: ``cli.main(["cli",
    "robot_walk", "ppo_gae", "--num_envs", ..., "train", out, "-e", "3",
    "-n", "1"])`` with the walker's recipe (hidden 256, horizon 64, epoch 8,
    lr 1e-3) and ``EVOMOTION_PROFILE=1``. The losses must be finite, every
    actor tensor must have moved from its seeded init, and ``save_0``'s
    components must load back equal (on the card). The slim sweep's counts
    are set to 0 just before and read just after: one launch per physics
    step; the first call's inputs are kept and, after the run, go through
    the kernel and its plain version, which must agree within TOL. Then a
    200-step greedy eval of the saved actor at 16 envs."""
    import tempfile

    import numpy as np
    import torch

    from evomotion_tpu_torch import cli, convert
    from evomotion_tpu_torch.envs.robot import RobotWalkFactory
    from evomotion_tpu_torch.kernels import sweep as sp
    from evomotion_tpu_torch.networks.modules import Actor, Critic
    from evomotion_tpu_torch.tools import eval_walk as ew
    from evomotion_tpu_torch.train.checkpoint import load_component

    t0 = phase("ppo train")
    n_envs, hidden, horizon, epoch = (2, 16, 2, 1) if cpu else (2048, 256, 64, 8)
    iters = 3
    with tempfile.TemporaryDirectory() as out, small_walker(cpu):
        # the env the smoke eval below uses is the one the CLI builds
        env = RobotWalkFactory({}).make(args.seed, mt_parity=False, device=dev,
                                        per_env_step=False)
        argv = ["cli", "robot_walk", "ppo_gae", "--num_envs", str(n_envs), "--env_seed",
                str(args.seed), "--agent_parameters", f"hidden_size={hidden}",
                f"horizon={horizon}", f"epoch={epoch}", "learning_rate=1e-3", "train", out,
                "-e", str(iters), "-n", "1"]
        print("ppo train: " + " ".join(argv), flush=True)
        old = os.environ.get("EVOMOTION_PROFILE")
        os.environ["EVOMOTION_PROFILE"] = "1"
        buf = io.StringIO()
        sp.KERNEL.launches = 0
        cap.calls = 0
        cap.arm(limit=1)
        try:
            with contextlib.redirect_stdout(buf):
                rc = cli.main(argv, device=dev)
            if not cpu:
                torch.cuda.synchronize()
        finally:
            cap.armed = False
            if old is None:
                del os.environ["EVOMOTION_PROFILE"]
            else:
                os.environ["EVOMOTION_PROFILE"] = old
        launches, calls = sp.KERNEL.launches, cap.calls
        kern_err = captured_check(cap.inputs, cpu, f"ppo train sweep, B={n_envs} "
                                  f"{env.model.row_order}")
        text = buf.getvalue()
        for line in text.replace("\r", "\n").splitlines():
            if line.strip():
                print(f"ppo train: {line.strip()}", flush=True)
        want = env.settle_total + iters * horizon
        print(f"ppo train: sweep calls {calls}, kernel launches {launches}, physics steps "
              f"{want}", flush=True)
        if rc != 0:
            fail(f"ppo train: cli returned {rc}")
        if calls != want or (not cpu and launches != want):
            fail(f"ppo train: expected {want} slim sweep launches, got {launches} launches "
                 f"of {calls} calls")
        prog = PROGRESS.findall(text)
        losses = [float(x) for m in prog for x in m[:3]]
        if not prog or prog[-1][4] != str(iters) or not all(map(math.isfinite, losses)):
            fail(f"ppo train: progress lines {prog}")
        prof = {k: (float(sec), int(n)) for k, sec, n in PROFILE.findall(
            text[text.index("[profile]"):])}
        rate = float(re.search(r"\(([\d,]+) env-steps/s incl\. update\)", text)
                     .group(1).replace(",", ""))
        if {k: n for k, (_, n) in prof.items()} != dict.fromkeys(
                ("rollout", "train_iter", "update"), iters):
            fail(f"ppo train: profile {prof}")
        ms = {k: sec / n * 1e3 for k, (sec, n) in prof.items()}
        print(f"ppo train [{card}]: per iteration ({horizon} steps x {n_envs} envs, "
              f"{epoch} epochs): rollout {ms['rollout']:.0f} ms, update {ms['update']:.0f} ms, "
              f"iteration {ms['train_iter']:.0f} ms (StepTimer, 10 ms resolution); "
              f"{rate:.0f} env-steps/s incl. the update; last actor loss {prog[-1][0]}, "
              f"critic loss {prog[-1][1]}", flush=True)

        save = os.path.join(out, "save_0")
        s, a = env.observation_size, env.action_size
        init = Actor(s, a, hidden, torch.Generator().manual_seed(args.seed))
        actor = load_component(save, "actor", Actor(s, a, hidden).to(dev))
        critic = load_component(save, "critic", Critic(s, hidden).to(dev))
        moved = {n: float((p.detach().cpu() - q.detach()).abs().max())
                 for (n, p), q in zip(actor.named_parameters(), init.parameters())}
        if not all(x > 0 and math.isfinite(x) for x in moved.values()):
            fail(f"ppo train: actor params did not all move from their init: {moved}")
        print(f"ppo train: actor params moved from their init by max |diff| "
              f"{min(moved.values()):.3e} (least tensor) to {max(moved.values()):.3e}",
              flush=True)
        for name, module in (("actor", actor), ("critic", critic)):
            opt = torch.optim.Adam(module.parameters())
            convert.load_adam(opt, module, load_component(
                save, f"{name}_optimizer", convert.adam_tree(opt, module)))
            with np.load(os.path.join(save, f"{name}.npz")) as p_raw, \
                    np.load(os.path.join(save, f"{name}_optimizer.npz")) as o_raw:
                for n, p in module.named_parameters():
                    key = n.replace(".", "/")
                    st = opt.state[p]
                    same = (np.array_equal(p.detach().cpu().numpy(), p_raw[key])
                            and np.array_equal(st["exp_avg"].cpu().numpy(), o_raw[f"1/0/mu/{key}"])
                            and np.array_equal(st["exp_avg_sq"].cpu().numpy(),
                                               o_raw[f"1/0/nu/{key}"])
                            and int(st["step"]) == int(o_raw["1/0/count"]) == iters * epoch)
                    if not same:
                        fail(f"ppo train: save_0 {name} {n} did not load back equal")
        print("ppo train: save_0 (actor, critic and their Adam states) loads back equal on "
              f"the card, Adam count {iters * epoch}", flush=True)

        n_smoke, h_smoke = (2, 3) if cpu else (16, 200)
        r = ew.greedy_eval(env, ew.GreedyPolicy(actor).eval(), n_smoke, h_smoke,
                           torch.Generator(device=dev).manual_seed(args.seed))
    steps = r.steps.float()
    if not (bool(torch.isfinite(r.ret).all()) and int(r.steps.max()) <= h_smoke):
        fail("ppo train: the greedy eval of the trained actor gave non-finite returns")
    print(f"ppo train: greedy eval of save_0's actor, {n_smoke} envs x {h_smoke} steps: mean "
          f"valid steps {float(steps.mean()):.2f}, mean return {float(r.ret.mean()):.3f}, "
          f"{r.steps_s / h_smoke * 1e3:.3f} ms per env step [{card}]", flush=True)
    done("ppo train", t0)
    return {"launches": launches, "ms": ms, "rate": rate, "err": kern_err}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="rehearse on the CPU (tiny batch, plain versions, no kernel)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    import torch

    if not args.cpu and not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; no card, no result",
              file=sys.stderr)
        return 2

    from evomotion_tpu_torch.envs.robot import RobotWalk, RobotWalkParams
    from evomotion_tpu_torch.kernels import sweep as sp
    from evomotion_tpu_torch.kernels import sweep_envlast as se
    from evomotion_tpu_torch.kernels import sweep_fat as sf
    from evomotion_tpu_torch.physics import batched, perenv

    cpu = args.cpu
    dev = torch.device("cpu" if cpu else "cuda")
    n_envs, n_cmp, n_steps = (4, 2, 3) if cpu else (2048, N_CMP, 120)
    params = RobotWalkParams(reset_frames=1) if cpu else RobotWalkParams()
    cap = SweepCapture(sp, batched, "sp", "solver_sweep_envlast_slim")
    fat_cap = SweepCapture(sf, perenv, "sf", "solver_sweep")

    # ---- 1. device ----
    t0 = phase("device")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    smi_line = None
    clock_mhz = None  # top SM clock as nvidia-smi reads it, for the chain estimate
    if not cpu:
        from evomotion_tpu_torch.device import resolve

        resolve(dev)  # as every entry point: f32 matmuls without TF32
        print(f"f32 matmul precision {torch.get_float32_matmul_precision()}, TF32 "
              f"{torch.backends.cuda.matmul.allow_tf32}", flush=True)
        name = torch.cuda.get_device_name(0)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        smi_line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unavailable"
        clk = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=60,
        )
        try:
            clock_mhz = float(clk.stdout.strip().splitlines()[0])
            print(f"max SM clock {clock_mhz:.0f} MHz", flush=True)
        except (ValueError, IndexError):
            print("max SM clock: no reading", flush=True)
        nvcc = subprocess.run(["nvcc", "--version"], capture_output=True, text=True, timeout=60)
        print(f"device {name} x{torch.cuda.device_count()}", flush=True)
        print(f"nvcc {nvcc.stdout.strip().splitlines()[-1] if nvcc.returncode == 0 else '?'}")
        print(smi_line, flush=True)
    card = (f"{torch.cuda.get_device_name(0)}, power limit {smi_line.split(',')[-1].strip()}"
            if not cpu else "cpu rehearsal")
    done("device", t0)

    # ---- 2. build ----
    t0 = phase("build")
    if not cpu:
        kernels = (sp.KERNEL, sf.KERNEL, se.KERNEL)
        with ThreadPoolExecutor(len(kernels)) as pool:  # one nvcc each, together
            built = list(pool.map(lambda k: k.build(), kernels))
        for k, so in zip(kernels, built):
            k.lib()
            print(f"built {so.name}", flush=True)
            for line in k.build_log.splitlines():
                if "registers" in line or "spill" in line:
                    print("ptxas:", line.strip(), flush=True)
    done("build", t0)

    # ---- 3. kernel check on real spider rows ----
    t0 = phase("kernel check")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    env = RobotWalk(params, device=dev)
    env32 = RobotWalk(params, device=dev)
    env32.model = dataclasses.replace(env32.model, row_dtype="f32")
    state, _ = env.reset(n_envs, gen)
    action = torch.rand((n_envs, env.action_size), generator=gen, device=dev) * 2 - 1
    captured = {}
    for label, e in (("bf16", env), ("f32", env32)):
        cap.arm()
        e.step(state, action, gen)
        cap.armed = False
        captured[label] = cap.inputs
    errs, times, plans = {}, {}, {}
    n_sms = None if cpu else torch.cuda.get_device_properties(dev).multi_processor_count
    for label, inp in captured.items():
        row_j, row_s, vel6, lam0, iinv9, meta, n_iters = inp
        print(f"{label}: rows {tuple(row_j.shape)} {row_j.dtype}, vel6 {tuple(vel6.shape)}, "
              f"iters {n_iters}", flush=True)
        if cpu:
            out = sp.sweep_plain(*inp)
        else:
            out = sp.solver_sweep_envlast_slim(*inp)
            torch.cuda.synchronize()
        errs[label] = slim_check(inp, out, n_cmp, label)
        if not cpu:
            pl = sp.KERNEL.plan_for(row_j, vel6, meta)
            jt = "13__nv_bfloat16" if label == "bf16" else "f"
            plans[label] = launch_info(sp.KERNEL, pl, row_j.shape[-1], n_sms,
                                       f"kernelI{jt}Li{pl.envs}E", f"sweep kernel ({label} J)")
        if label != "bf16":
            continue
        flops = sweep_flops(rows_with_push(meta), SLIM_OPS, n_iters, row_j.shape[-1])
        bound_ms, bound_by, nbytes = bound(
            (row_j, row_s, vel6, lam0, iinv9, meta.table, *out), flops)
        print(f"bound: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP -> "
              f"{bound_ms:.4f} ms ({bound_by})", flush=True)
        print_chain(sweep_visits(meta, n_iters), clock_mhz, bound_ms)
        if cpu:
            continue
        # kernel time: CUDA events around repeated launches (warm)
        times["ms"] = cuda_ms(lambda: sp.solver_sweep_envlast_slim(*inp), 10)
        # plain version at the same full-width inputs, once
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        full = sp.sweep_plain(*inp)
        end.record()
        torch.cuda.synchronize()
        times["plain_ms"] = start.elapsed_time(end)
        full_err = max_err(out, full)
        print(f"bf16: kernel {times['ms']:.3f} ms/call, plain version "
              f"{times['plain_ms']:.1f} ms/call, at B={row_j.shape[-1]}; "
              f"max |kernel - plain| over all envs {full_err:.3e}", flush=True)
        if not full_err <= TOL:
            fail(f"sweep kernel disagrees with its plain version on all envs: {full_err}")
        errs["bf16_all"] = full_err
    done("kernel check", t0)

    # ---- 4. one step on the card against the same step on the CPU ----
    t0 = phase("step check")
    if not cpu:
        batched_step_check(env32, state, action, 4, dev, "f32 rows")
    done("step check", t0)

    # ---- 5. the scheduled order: groups of the slim sweep ----
    sched_err = groups_check(env, env32, state, action, cap, n_cmp, dev, cpu)

    # ---- 6. main path ----
    t0 = phase("main path")
    main_run = batched_rollout(env, n_envs, n_steps, args.seed + 1, cap, dev, cpu, card,
                               "canonical")
    if not cpu:
        step_ms = main_run["step_ms"]
        print(f"sweep ms/call {times['ms']:.3f} (CUDA events, B={n_envs}) [{card}]", flush=True)
        print(f"env step {step_ms:.3f} ms (host clock, synchronised at the end), of which "
              f"the sweep kernel alone takes {times['ms']:.3f} ms "
              f"({100 * times['ms'] / step_ms:.1f}%) [{card}]", flush=True)
    done("main path", t0)

    # ---- 7. scheduled rollout ----
    t0 = phase("scheduled rollout")
    sched = RobotWalk(params, device=dev)
    sched.model = dataclasses.replace(env.model, row_order="scheduled")
    n_sched = n_steps if cpu else SCHEDULED_STEPS
    sched_run = batched_rollout(sched, n_envs, n_sched, args.seed + 1, cap, dev, cpu, card,
                                "scheduled")
    print(f"env-steps/s at B={n_envs}: canonical {main_run['sps']:.1f} ({n_steps} steps), "
          f"scheduled {sched_run['sps']:.1f} ({n_sched} steps); a reading, not a claim "
          f"[{card}]", flush=True)
    done("scheduled rollout", t0)

    del env, env32, state, captured, sched
    fat = fat_kernel_check(args, dev, cpu, params, fat_cap, clock_mhz, card)
    perenv_step_check(fat, dev, cpu)
    sched_fat_err, sched_fat_ms = perenv_groups_check(args, dev, cpu, params, fat_cap, fat, card)
    seq = sequential_run(args, dev, cpu, card, cap, fat_cap)
    envlast = envlast_kernel_check(args, dev, cpu, n_envs, card, clock_mhz)
    prof = profilers(dev, cpu)
    walker = walker_eval(args, dev, cpu, card, cap)
    train = ppo_train(args, dev, cpu, card, cap)

    # ---- 16. kernels line and last line ----
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    kern = {
        "name": "sweep_envlast_slim",
        "route": "cuda",
        "source": "evomotion_tpu_torch/kernels/csrc/sweep_envlast_slim.cu",
        "replaces": REPLACES,
        "tpu_kernel": TPU_KERNEL,
        "launches": (main_run["launches"] + sched_run["launches"] + walker["launches"]
                     + train["launches"]),
        "launches_by_path": {"batched canonical": main_run["launches"],
                             "batched scheduled": sched_run["launches"],
                             "walker eval": walker["launches"],
                             "ppo train": train["launches"]},
        "max_abs_err": max(*errs.values(), sched_err, walker["err"], train["err"]),
        "groups_checked": True,
        "tol": TOL,
        "ms": times.get("ms"),
        "plain_ms": times.get("plain_ms"),
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "launch": plans.get("bf16"),
        "launch_f32": plans.get("f32"),
    }
    fat_kern = {
        "name": "solver_sweep",
        "route": "cuda",
        "source": "evomotion_tpu_torch/kernels/csrc/solver_sweep.cu",
        "replaces": FAT_REPLACES,
        "tpu_kernel": FAT_TPU_KERNEL,
        "launches": seq["launches"],
        "launches_by_path": {"sequential run": seq["launches"]},
        "max_abs_err": max(*fat["errs"].values(), *seq["errs"].values(), sched_fat_err),
        "groups_checked": True,
        "tol": TOL,
        "ms": fat["times"].get("ms"),
        "push_ms": fat["times"].get("push_ms"),
        "scheduled_ms": sched_fat_ms,
        "plain_ms": fat["times"].get("plain_ms"),
        "bound_ms": fat["bound_ms"],
        "bound_by": fat["bound_by"],
        "library_ms": None,
        "launch": fat["launch"],
    }
    envlast_kern = {
        "name": "solver_sweep_envlast",
        "route": "cuda",
        "source": "evomotion_tpu_torch/kernels/csrc/solver_sweep_envlast.cu",
        "replaces": ENVLAST_REPLACES,
        "tpu_kernel": ENVLAST_TPU_KERNEL,
        "launches": sum(p["launches"] for p in prof.values()),
        "launches_by_path": {k: p["launches"] for k, p in prof.items()},
        "max_abs_err": envlast["err"],
        "max_rel_err": envlast["rel_err"],
        "tol": TOL,
        "rel_tol": REL_TOL,
        "ms": envlast["times"].get("ms"),
        "plain_ms": envlast["times"].get("plain_ms"),
        "bound_ms": envlast["bound_ms"],
        "bound_by": envlast["bound_by"],
        "library_ms": None,
        "launch": envlast["launch"],
    }
    print(json.dumps({"kernels": [kern, fat_kern, envlast_kern]}), flush=True)
    if cpu:
        print(json.dumps({"ok": True, "device": {"platform": "cpu", "kind": "cpu",
                                                 "count": 0}}), flush=True)
    else:
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # on a machine with a CUDA card and nvcc
    python3 chip_smoke.py --cpu      # rehearsal on the CPU: tiny batch, plain versions

Two paths run, each with its kernel: the batched spider ``robot_walk``
rollout (the fused slim sweep, ``kernels/csrc/sweep_envlast_slim.cu``) and
the CLI's sequential ``run`` (one world, the per-env physics step, the
fat-row sweep ``kernels/csrc/solver_sweep.cu`` twice per spider step).
Phases, each printed with its seconds:

1. device: the card's name, power limit and top SM clock (nvidia-smi),
   torch and nvcc versions;
2. build: nvcc builds both kernels, one process each, started together, and
   prints their registers and spills;
3. kernel check: the slim sweep's inputs are captured at B=2048 from the
   first step after a reset of the spider, for bf16 rows (the shipped
   default) and f32 rows; the kernel runs on all envs, its plain PyTorch
   version on the card on 256 of them, and the outputs must agree within TOL;
4. step check: one batched physics step of 4 of those envs on the card
   (kernel) against the same step on the CPU (plain version), f32 rows;
5. main path: ``RobotWalk`` at B=2048, ``reset`` (60 settle steps) and 120
   steps of uniform random actions from a seeded ``torch.Generator``; the
   outputs must be finite, the spider on the floor, and the slim sweep
   launched exactly once per physics step (launch counts set to 0 just
   before, read just after);
6. fat kernel check: the fat-row sweep's inputs (push pass and velocity
   sweep) are captured from the first per-env spider step after a seeded
   reset; kernel and plain version on the card must agree within TOL at B=1,
   and on 64 slightly perturbed copies (the batched call shape); the push
   pass must leave some push velocity non-zero;
7. per-env step check: that per-env spider step on the card (kernel)
   against the same step on the CPU (plain version);
8. sequential run path: ``cli.main([... "run" ...])`` on cartpole and
   cartpole3d (3 episodes each) and the spider robot_walk (1 episode), random
   agent; episode lines printed, returns finite, the fat-row sweep launched
   exactly once (cartpoles) or twice (spider) per physics step and the slim
   sweep never (counts set to 0 just before each env's run, read just after);
   each cartpole run's first fat-row sweep call is held against its plain
   version within TOL;
9. the kernels line and the last line (one JSON object each).

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
FAT_TPU_KERNEL = ("solver_sweep -> _sweep_kernel "
                  "(evomotion_tpu/physics/solver_pallas.py:191, pallas_call :276)")
# An estimate, not a measurement, printed apart from the kernels line: the
# fat-row sweep at B=1 is a chain of dependent row visits, each reading
# velocities the previous visit may have written. Its dependent fp32
# operations per visit, as counted here: a 12-term dot product (one
# multiply, then four levels of adds), rhs - jv, x inv_eff, + lam, the
# two-sided clamp (2), the impulse delta, and the velocity update (one FMA):
# 12. At an assumed 4-cycle fp32 latency a visit takes 48 cycles at the SM
# clock that nvidia-smi reports; the shared-memory round trips that every
# visit also pays are left out, so the true floor is higher.
CHAIN_OPS = 12
FP32_LATENCY_CYCLES = 4
SEQ_EPISODES = {"cartpole": 3, "cartpole3d": 3, "robot_walk": 1}
EPISODE_LINE = re.compile(r"^episode (\d+): (\d+) steps, return (\S+)$")


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


def sweep_flops(meta, n_iters, b):
    """fp32 operations of one sweep call, counted row by row as the kernel
    does them (csrc/sweep_envlast_slim.cu): body-A dv, eff and J.v (61 with
    the impulse update), body B (+56), the clamp by kind, and the push pass
    of normal rows (+29, +25 with body B)."""
    per_env_iter = 0
    for _ia6, _ib6, kind, _parent, skip_b, pslot, *_ in meta.rows:
        ops = 61 + (2, 1, 4)[kind]
        if not skip_b:
            ops += 56
        if pslot >= 0:
            ops += 29 + (0 if skip_b else 25)
        per_env_iter += ops
    return per_env_iter * n_iters * b


def sweep_bound(inputs, outputs, n_iters):
    """Least time for one call: each input read once and each output written
    once over HBM bandwidth, or the fp32 operations over the fp32 peak."""
    row_j, row_s, vel6, lam0, iinv9, meta, _ = inputs
    nbytes = sum(t.numel() * t.element_size()
                 for t in (row_j, row_s, vel6, lam0, iinv9, meta.meta_i, meta.meta_f, *outputs))
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = sweep_flops(meta, n_iters, row_j.shape[-1]) / H100_FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes


def max_err(a_list, b_list):
    return max(float((a - b).abs().max()) for a, b in zip(a_list, b_list))


def fat_sweep_flops(meta, n_iters, b):
    """fp32 operations of one fat-row sweep call, counted row by row as the
    kernel does them (csrc/solver_sweep.cu): J_a.v_a (12), the impulse
    update (3) and delta (1), the velocity update of body A (12), the clamp
    by kind (joint 2, normal 1, friction 4), and body B's J.v (13) and
    update (12) unless it is static."""
    per_env_iter = 0
    for _ia6, ib6, kind, _parent, _mu in meta.rows:
        per_env_iter += 28 + (2, 1, 4)[kind] + (25 if ib6 >= 0 else 0)
    return per_env_iter * n_iters * b


def fat_sweep_bound(inputs, outputs, n_iters):
    """Least time for one fat-row sweep call: each input read once and each
    output written once over HBM bandwidth, or its fp32 operations over the
    fp32 peak."""
    rows, vel6, lam0, meta, _ = inputs
    nbytes = sum(t.numel() * t.element_size()
                 for t in (rows, vel6, lam0, meta.meta_i, meta.mu, *outputs))
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = fat_sweep_flops(meta, n_iters, rows.shape[0]) / H100_FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations", nbytes


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
    """Phase 6: the fat-row sweep against its plain version on real spider
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

    bound_ms, bound_by, nbytes = fat_sweep_bound(full_in, outs["full"], n_iters)
    print(f"bound: {nbytes / 1e3:.1f} kB, "
          f"{fat_sweep_flops(meta, n_iters, rows.shape[0]) / 1e6:.3f} MFLOP -> "
          f"{bound_ms * 1e3:.4f} us ({bound_by})", flush=True)
    visits = n_iters * rows.shape[1]
    if clock_mhz:
        print(f"estimate, not measured: a chain of {visits} dependent row visits x "
              f"{CHAIN_OPS * FP32_LATENCY_CYCLES} cycles (assumed fp32 latency, shared-memory "
              f"round trips left out) at the reported {clock_mhz:.0f} MHz -> "
              f"{visits * CHAIN_OPS * FP32_LATENCY_CYCLES / (clock_mhz * 1e3):.4f} ms",
              flush=True)
    else:
        print("estimate of the row-visit chain: not computed (no SM clock reading)", flush=True)
    if not cpu:
        times["ms"] = cuda_ms(lambda: sf.solver_sweep(*full_in), 20)
        times["push_ms"] = cuda_ms(lambda: sf.solver_sweep(*push_in), 20)
        print(f"fat sweep kernel ms/call at B=1 (CUDA events): full {times['ms']:.4f} "
              f"({n_iters * rows.shape[1]} row visits, "
              f"{times['ms'] * 1e6 / (n_iters * rows.shape[1]):.1f} ns each), push "
              f"{times['push_ms']:.4f}; plain version full {times['plain_ms']:.1f} [{card}]",
              flush=True)
    done("fat kernel check", t0)
    return {"env": env, "state": state, "action": action, "errs": errs, "times": times,
            "bound_ms": bound_ms, "bound_by": bound_by}


def perenv_step_check(fat, dev, cpu):
    """Phase 7: one per-env spider step on the card (kernels) against the
    same step on the CPU (plain versions)."""
    import torch

    from evomotion_tpu_torch.physics.perenv import PerEnvStep

    t0 = phase("per-env step check")
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
        print(f"max |card - cpu| after one per-env spider step: {err:.3e} (tol {STEP_TOL:g})",
              flush=True)
        if not err <= STEP_TOL:
            fail(f"per-env card step disagrees with the CPU step: {err}")
    done("per-env step check", t0)


def sequential_run(args, dev, cpu, card, cap, fat_cap):
    """Phase 8: the CLI's sequential ``run`` on each env, random agent. The
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
    from evomotion_tpu_torch.kernels import sweep_fat as sf
    from evomotion_tpu_torch.physics import batched, perenv

    cpu = args.cpu
    dev = torch.device("cpu" if cpu else "cuda")
    n_envs, n_cmp, n_steps = (4, 2, 3) if cpu else (2048, 256, 120)
    params = RobotWalkParams(reset_frames=1) if cpu else RobotWalkParams()
    cap = SweepCapture(sp, batched, "sp", "solver_sweep_envlast_slim")
    fat_cap = SweepCapture(sf, perenv, "sf", "solver_sweep")

    # ---- 1. device ----
    t0 = phase("device")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    smi_line = None
    clock_mhz = None  # top SM clock as nvidia-smi reads it, for the chain estimate
    if not cpu:
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
    done("device", t0)

    # ---- 2. build ----
    t0 = phase("build")
    if not cpu:
        kernels = (sp.KERNEL, sf.KERNEL)
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
    errs, times = {}, {}
    for label, inp in captured.items():
        row_j, row_s, vel6, lam0, iinv9, meta, n_iters = inp
        print(f"{label}: rows {tuple(row_j.shape)} {row_j.dtype}, vel6 {tuple(vel6.shape)}, "
              f"iters {n_iters}", flush=True)
        if cpu:
            out = sp.sweep_plain(*inp)
        else:
            out = sp.solver_sweep_envlast_slim(*inp)
            torch.cuda.synchronize()
        sub = [x[..., :n_cmp].contiguous() if torch.is_tensor(x) else x for x in inp]
        ts = time.perf_counter()
        ref = sp.sweep_plain(*sub)
        if not cpu:
            torch.cuda.synchronize()
        print(f"{label}: plain version on {n_cmp} envs {time.perf_counter() - ts:.2f} s",
              flush=True)
        err = [float((a[..., :n_cmp] - b).abs().max()) for a, b in zip(out, ref)]
        print(f"{label}: max |kernel - plain| vel6 {err[0]:.3e} lam {err[1]:.3e} "
              f"push {err[2]:.3e} (tol {TOL:g})", flush=True)
        if not all(x <= TOL for x in err):  # NaN fails too
            fail(f"{label} sweep kernel disagrees with its plain version: {err}")
        errs[label] = max(err)
        if label == "bf16":
            bound_ms, bound_by, nbytes = sweep_bound(inp, out, n_iters)
            print(f"bound: {nbytes / 1e6:.1f} MB, "
                  f"{sweep_flops(meta, n_iters, row_j.shape[-1]) / 1e9:.2f} GFLOP -> "
                  f"{bound_ms:.4f} ms ({bound_by})", flush=True)
            if not cpu:
                # kernel time: CUDA events around repeated launches (warm)
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                    enable_timing=True)
                reps = 10
                start.record()
                for _ in range(reps):
                    sp.solver_sweep_envlast_slim(*inp)
                end.record()
                torch.cuda.synchronize()
                times["ms"] = start.elapsed_time(end) / reps
                # plain version at the same full-width inputs, once
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
        cpu_env = RobotWalk(params, device="cpu")
        cpu_env.model = env32.model
        few = type(state.physics)(*(x[:4] for x in state.physics))
        tgt = action[:4] * env._speed
        on = torch.ones((4, env.model.n_slider), dtype=torch.bool, device=dev)
        card, _ = env32.physics_step(few, tgt, on)
        host, _ = cpu_env.physics_step(
            type(few)(*(x.cpu() for x in few)), tgt.cpu(), on.cpu())
        step_err = max(float((getattr(card, f).cpu() - getattr(host, f)).abs().max())
                       for f in ("pos", "quat", "lin_vel", "ang_vel"))
        print(f"max |card - cpu| after one step, f32 rows, 4 envs: {step_err:.3e} "
              f"(tol {STEP_TOL:g})", flush=True)
        if not step_err <= STEP_TOL:
            fail(f"card step disagrees with the CPU step: {step_err}")
    done("step check", t0)

    # ---- 5. main path ----
    t0 = phase("main path")
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
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
    print(f"sweep calls {calls}, kernel launches {launches}, physics steps {want}", flush=True)
    if calls != want or (not cpu and launches != want):
        fail(f"expected {want} sweep kernel launches (one per physics step), "
             f"got {launches} launches of {calls} calls")
    rewards = torch.stack(rewards)
    finite = all(torch.isfinite(x.float()).all() for x in (res.obs, rewards, *state.physics))
    if not finite:
        fail("non-finite obs, rewards or physics state")
    if tuple(res.obs.shape) != (n_envs, env.observation_size):
        fail(f"obs shape {tuple(res.obs.shape)}")
    y_lo, y_hi = float(torch.stack(y_lo).min()), float(torch.stack(y_hi).max())
    drift = float((state.physics.pos[:, root] - torch.tensor([1.0, 0.25, 2.0], device=dev))
                  [:, [0, 2]].abs().max())
    q = torch.quantile(root_y0.float().cpu(), torch.tensor([0.0, 0.05, 0.5, 0.95, 1.0]))
    print("after reset: root y min/5%/50%/95%/max "
          + " ".join(f"{x:.3f}" for x in q.tolist()), flush=True)
    print(f"over {n_steps} steps: body y in [{y_lo:.3f}, {y_hi:.3f}], root xz drift max "
          f"{drift:.3f}, episodes ended {int(torch.stack(ended).sum())} of {n_envs} envs, "
          f"mean reward {float(rewards.mean()):.4f}", flush=True)
    # The floor is the 2 m thick cube between y=-3 and y=-1. Random muscle
    # actions press members some way into it (split-impulse correction is
    # soft) but a body that went through would fall on below y=-1.5 within
    # the run; nothing the muscles do flings a body 5 m up or 20 m away.
    if not (y_lo > -1.5 and y_hi < 5.0):
        fail("spider through the floor or flown off")
    if drift > 20.0:
        fail("spider root drifted impossibly far")
    # spawned at y=0.25 with a random tilt, the spider has come down onto the
    # floor after the 60 settle steps (1 s) of a full reset; some land propped
    # on their legs, so the check is on the median and the extremes
    if not cpu and not (q[0] > -1.0 and q[2] < 0.0 and q[4] < 1.5):
        fail("spider did not settle on the floor during reset")
    sps = n_envs * n_steps / t_steps
    card = (f"{torch.cuda.get_device_name(0)}, power limit {smi_line.split(',')[-1].strip()}"
            if not cpu else "cpu rehearsal")
    print(f"reset ({env.settle_total} settle steps) {t_reset:.2f} s; {n_steps} steps "
          f"{t_steps:.2f} s", flush=True)
    print(f"env-steps/s {sps:.1f} at B={n_envs} [{card}]", flush=True)
    if not cpu:
        step_ms = t_steps / n_steps * 1e3
        print(f"sweep ms/call {times['ms']:.3f} (CUDA events, B={n_envs}) [{card}]", flush=True)
        print(f"env step {step_ms:.3f} ms (host clock, synchronised at the end), of which "
              f"the sweep kernel alone takes {times['ms']:.3f} ms "
              f"({100 * times['ms'] / step_ms:.1f}%) [{card}]", flush=True)
    done("main path", t0)

    del env, env32, state, res, captured
    fat = fat_kernel_check(args, dev, cpu, params, fat_cap, clock_mhz, card)
    perenv_step_check(fat, dev, cpu)
    seq = sequential_run(args, dev, cpu, card, cap, fat_cap)

    # ---- 9. kernels line and last line ----
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    kern = {
        "name": "sweep_envlast_slim",
        "route": "cuda",
        "source": "evomotion_tpu_torch/kernels/csrc/sweep_envlast_slim.cu",
        "replaces": REPLACES,
        "tpu_kernel": TPU_KERNEL,
        "launches": launches,
        "max_abs_err": max(errs.values()),
        "tol": TOL,
        "ms": times.get("ms"),
        "plain_ms": times.get("plain_ms"),
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }
    fat_kern = {
        "name": "solver_sweep",
        "route": "cuda",
        "source": "evomotion_tpu_torch/kernels/csrc/solver_sweep.cu",
        "replaces": FAT_REPLACES,
        "tpu_kernel": FAT_TPU_KERNEL,
        "launches": seq["launches"],
        "max_abs_err": max(*fat["errs"].values(), *seq["errs"].values()),
        "tol": TOL,
        "ms": fat["times"].get("ms"),
        "push_ms": fat["times"].get("push_ms"),
        "plain_ms": fat["times"].get("plain_ms"),
        "bound_ms": fat["bound_ms"],
        "bound_by": fat["bound_by"],
        "library_ms": None,
    }
    print(json.dumps({"kernels": [kern, fat_kern]}), flush=True)
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

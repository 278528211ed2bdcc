#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # on a machine with a CUDA card and nvcc
    python3 chip_smoke.py --cpu      # rehearsal on the CPU: tiny batch, plain versions

These paths run, each with its kernel where it has one: the batched spider ``robot_walk``
rollout (the fused slim sweep, ``kernels/csrc/sweep_envlast_slim.cu``), in
the canonical and in the ``scheduled`` row order (the slim sweep's groups
mode); the CLI's sequential ``run`` (one world, the per-env physics step,
the fat-row sweep ``kernels/csrc/solver_sweep.cu`` twice per spider step);
the two profilers of ``evomotion_tpu_torch.tools`` (the env-last fat-row
sweep ``kernels/csrc/solver_sweep_envlast.cu``); the greedy eval of the
committed walker (``tools.eval_walk``) and the CLI's batched PPO ``train``,
both on the batched step and the slim sweep; the CLI's batched CrossQ and
SAC ``train`` (the slim sweep) and their sequential ``train`` then ``run``
on cartpole (the fat-row sweep); the on-policy tier: batched A2C and
PPO-vanilla ``train`` (the slim sweep), the batched ``robot_jump`` rollout
(the slim sweep) and its sequential ``run``, and the sequential A2C,
PPO-vanilla and PPO-GAE ``train`` then ``run`` (the fat-row sweep); the
liquid (LTC) tier: batched liquid PPO-GAE and liquid SAC ``train`` (the
slim sweep) and the sequential ``train`` then ``run`` of the three liquid
agents (the fat-row sweep); the colored-phase ``solver="xla"`` step and
the strict-Bullet replay (plain PyTorch: the JAX branch reaches no
kernel); the viewer's ``run --record/--html/--live`` and ``eval_walk
--out``'s re-run, and the web robot builder's infer tab (``cli gui``), all
on the fat-row sweep; data-parallel PPO and CrossQ training over the env
batch (``tools.multihost_worker`` under ``torch.distributed.run``, the
slim sweep in every rank). Phases, each printed with its seconds:

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
    envs, the first 400 steps of the 1800-step win horizon, seed 999); the
    actor on the card
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
    first call against its plain version within TOL; then a 100-step
    greedy eval of the saved actor at 16 envs;
16. offpolicy update check: CrossQ and SAC updates at the walker config's
    widths (obs 371, action 12, actor 256, critics 1,024, batch 256) on the
    card and on the CPU from the same seeded init, batches and uniforms: a
    first update (the losses and every tensor of the agent's carry but the
    parameters within UPDATE_TOL, the parameters within 2 lr: Adam's first
    step is the sign of each gradient, and a few are at f32 noise), then a
    second from one shared state (everything within UPDATE_TOL: params, Adam
    moments and counts, BatchRenorm statistics, target critics, log_alpha);
    the card's ms, device launches and device time per update;
17. cross_q train: ``cli.main([... "robot_walk", "cross_q", "--num_envs",
    "256", ... "train", ...])`` for 1 iteration with the JAX tier's walker
    config (``runs/walk_r4_crossq_s1234/config.json``: 64 steps per
    iteration, actor 256, BatchRenorm critics 1,024, batch 256, 4 updates
    per env step, a 2^20 ring, the nan guard) and ``EVOMOTION_PROFILE=1``:
    finite losses, the ring filled with 16,384 transitions, moved actor
    tensors, ``save_0`` loading back equal into a fresh agent on the card;
    rollout and update ms per iteration, env-steps/s and gradient steps/s
    printed; the slim sweep counted as in 15 and held against its plain
    version on the run's first call; then a 100-step greedy eval of the
    saved actor at 16 envs through ``tools.eval_walk``'s ``crossq`` tier;
18. soft_actor_critic train: the same with SAC (no eval);
19. offpolicy sequential: ``cli cartpole soft_actor_critic ... train -e 2
    -n 1`` (one env, the per-env step) then ``run`` of ``save_0``, and the
    same with ``cross_q``: finite meters and returns; the fat-row sweep
    launched once per physics step (counts set to 0 just before each
    command, read just after), each command's first call held against its
    plain version;
20. c2 reading (not a gate but for the resume): one seeded batched state at
    B=256 stepped twice, by default and under
    ``torch.use_deterministic_algorithms(True)`` (largest difference,
    bit-equal or not, the op it raises on); then the full-state resume of
    one CrossQ iteration (walker widths, 16 steps, ring cut to 4 blocks)
    in the deterministic mode where it made the step bit-equal: the loaded state
    equal to the saved one, and one more iteration from each within
    UPDATE_TOL;
21. onpolicy update check: an update of A2C (batch 256), PPO-vanilla (a
    16,384-step block, 8 epochs) and the sequential PPO-GAE (8 padded
    trajectories of up to 1,800 steps) at the walker's widths (obs 371,
    action 12, hidden 256) on the card and on the CPU from one seeded
    init and the same numpy-made inputs: update 1 (the losses, the
    parameters within 2 lr per epoch, A2C's Adam moments), then update 2
    from one shared state (the losses and the parameters within
    UPDATE_TOL, and A2C's whole carry); ms, device launches and device ms
    per update;
22. robot_jump: one batched jump step of 4 envs, card against CPU, f32
    rows; ``RobotJump`` at B=2048, reset (10 settle steps) and 60 steps of
    uniform random actions (finite, on the floor, the slim sweep once per
    physics step and its first call against its plain version,
    env-steps/s); the CLI's sequential ``run`` of one episode, the fat-row
    sweep twice per physics step;
23. actor_critic and ppo_vanilla train: ``cli.main([... "robot_walk",
    algo, "--num_envs", "2048", ... "train", ... "-e", "1", "-n", "1"])``
    with hidden 256, horizon 64, batch 256, epoch 8 and
    ``EVOMOTION_PROFILE=1``: finite losses, moved parameters, ``save_0``
    loading back equal on the card; the slim sweep counted and held as in
    15; rollout and update ms per iteration and env-steps/s printed;
24. onpolicy sequential: ``cli cartpole actor_critic|ppo_vanilla|ppo_gae
    ... train -e 2 -n 1`` then ``run`` of ``save_0``; ``cli robot_jump
    ppo_gae ... train -e 3 -n 1`` at hidden 256 then ``run``; ``cli
    robot_walk ppo_gae ... run`` of phase 15's batched ``save_0``: the
    fat-row sweep once per cartpole and twice per spider physics step,
    each command's first call against its plain version;
25. liquid update check: an update of the liquid A2C and SAC (batch 256,
    stored hidden states) and the liquid PPO-GAE (8 padded trajectories of
    up to 1,800 steps, 8 epochs) at full width (64 neurons, 6 unfoldings,
    obs 371, action 12) on the card and on the CPU from one seeded init
    and the same numpy-made inputs (SAC's uniforms too): update 1's losses
    within UPDATE_TOL and its parameters' error printed beside 2 lr per
    epoch; update 2 from one shared state, the losses and the parameters
    within UPDATE_TOL (A2C's and SAC's whole carry); ms, device launches
    and device ms per update;
26. ppo_gae_liquid train: ``cli.main([... "robot_walk", "ppo_gae_liquid",
    "--num_envs", "2048", ... "train", ... "-e", "1", "-n", "1"])`` with
    the JAX driver's liquid defaults (64 neurons, 6 unfoldings, horizon
    64, 8 epochs) and ``EVOMOTION_PROFILE=1``: the slim sweep launched 60
    + 64 = 124 times and held as in 15, finite losses, moved actor
    tensors, ``save_0`` loading back equal on the card; rollout and update
    ms per iteration and env-steps/s printed;
27. soft_actor_critic_liquid train: the same at 256 envs, batch 256, an
    update per env step and a 65,536-entry ring: ``updates_done`` 64 per
    iteration, the ring's fill and bytes, env-steps/s and gradient steps/s;
28. liquid sequential: ``cli cartpole <liquid agent> ... train -e 2 -n 1``
    then ``run`` of ``save_0`` for the three agents; ``cli robot_walk
    ppo_gae_liquid ... run`` of phase 26's batched ``save_0``; ``run`` of
    the port's copy of the JAX package's liquid-SAC cartpole checkpoint
    (3 episodes, their lengths beside phase 11's random agent's): the
    fat-row sweep once per cartpole and twice per spider physics step,
    each command's first call against its plain version;
29. xla on the card: the strict replay (``tools.strict_trajectory``'s
    env, the 30-frame reset and the first 8 artifact actions), its
    distance from ``tests/goldens/strict_walk.npz`` printed as a reading
    (the settle is chaotic in f32, ROADMAP trap 14) and no sweep kernel
    launched during it (the xla branch reaches none); from replay states,
    one card xla spider step against the CPU's within STEP_TOL, strict and
    non-strict; a B=4 batch of xla worlds against 4 per-env calls; ms,
    CUDA launches and device busy share per xla physics step
    (``torch.profiler``);
30. viewer: ``cli cartpole random run --record --html`` and one
    ``robot_walk`` episode with ``--record`` (recordings checked, ms per
    env step of ``run --record``), ``run --live`` on the spider serving 3
    frames to a client thread on 127.0.0.1, and ``tools.eval_walk --out``
    on the committed walker (4 envs, a 120-step horizon) with its re-run
    of the best episode on one world: the fat-row sweep once per cartpole
    and twice per spider physics step on each (counts set to 0 just
    before, read just after), the first calls against the plain version;
31. gui: ``cli gui --max-requests N`` with a client thread: the page, the
    robot, builder ops, and the infer tab on the spider with a port CrossQ
    checkpoint at the tab's default config, 3 frames polled; the fat-row
    sweep twice per physics step;
32. data parallel: ``tools.multihost_worker`` process groups over the env
    batch (``parallel.mesh``), each rank's slim sweep counts (set to 0 just
    before its trainer's init) returned in its JSON line: ppo train's
    workload (B=2048, 2 iterations) in one process and on one NCCL rank
    under the deterministic mode, bit-equal; on two gloo ranks of 1,024
    envs on the one card, the replicas bit-equal and the second update
    within DP_UPDATE_TOL of the one-process update of the same gathered
    trajectory; CrossQ at the walker config on two gloo ranks of 128 envs;
    env-steps/s, the update's ms and one update's broadcasts printed; the
    slim sweep's kernel on the first call at each rank's batch against its
    plain version;
33. the off-policy, on-policy, liquid, xla/viewer/gui and data-parallel
    readings lines, the kernels line and the last line (one JSON object
    each).

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
import tempfile
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
# the walker eval: the JAX tool's defaults (64 envs, seed 999), over the
# first 400 env steps of the 1,800-step win horizon, the early gate's (cut
# for the script's time limit: the env's win comes at step 1,800, so the
# win rate reads 0 here and the early-steps gate is what holds the gait)
WALKER_ENVS, WALKER_SEED, WALKER_HORIZON = 64, 999, 400
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
    total, errs, lengths = 0, {}, {}
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
            lengths[env_name] = [int(m.group(2)) for m in lines]
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
    return {"launches": total, "errs": errs, "lengths": lengths}


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

    cpu_env = type(env)(env.params, device="cpu")
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


def batched_rollout(env, n_envs, n_steps, seed, cap, dev, cpu, card, label,
                    settled_after_reset=True):
    """A batched path: reset (settle steps) then ``n_steps`` steps of
    uniform random actions. The slim sweep's counts are set to 0 just before
    and read just after; it must have launched once per physics step. The
    outputs must be finite and the spider on the floor: after the reset, or
    (``settled_after_reset=False``: robot_jump's reset settles 10 steps, not
    60) after the steps. Returns the readings."""
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
    probs = torch.tensor([0.0, 0.05, 0.5, 0.95, 1.0])
    q = torch.quantile(root_y0.float().cpu(), probs)
    print(f"{label}: after reset: root y min/5%/50%/95%/max "
          + " ".join(f"{x:.3f}" for x in q.tolist()), flush=True)
    if not settled_after_reset:
        q = torch.quantile(state.physics.pos[:, root, 1].float().cpu(), probs)
        print(f"{label}: after the steps: root y min/5%/50%/95%/max "
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
    # floor after the 60 settle steps (1 s) of a full reset (robot_jump: after
    # its 10 settle steps and the run's); some land propped on their legs, so
    # the check is on the median and the extremes
    if not cpu and not (q[0] > -1.0 and q[2] < 0.0 and q[4] < 1.5):
        fail(f"{label}: spider did not settle on the floor")
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
    64 envs, the tool's default seed 999, over WALKER_HORIZON of the
    1800-step win horizon: ``eval_walk.WIN`` is cut for the run). Gate
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
        env_settle = env.settle_total
        kern_err = captured_check(cap.inputs, cpu, f"walker eval sweep, B={n_envs} "
                                  f"{meta['eval_order']}")
        del env, est, first
        saved_win = ew.WIN
        if not cpu:
            ew.WIN = WALKER_HORIZON
        want = env_settle + ew.WIN  # physics steps of the eval
        sp.KERNEL.launches = 0
        cap.calls = 0
        try:
            res = run_tool(ew, ["ppo", ew.WALKER_DIR, "--episodes", str(n_envs),
                                "--seed", str(WALKER_SEED)], "eval_walk", device=dev)
        finally:
            ew.WIN = saved_win
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


def profiled_train(argv, label, env, iters, horizon, dev, cpu, cap):
    """Runs the CLI's batched ``train`` (``argv``, ``iters`` iterations of
    ``horizon`` steps on ``env``'s model) with ``EVOMOTION_PROFILE=1`` and
    prints its output. The slim sweep's counts are set to 0 just before and
    read just after: one launch per physics step (the reset's settle steps
    and the rollouts'); the first call's inputs go through the kernel and
    its plain version after the run, which must agree within TOL. The
    progress lines' losses must be finite and each StepTimer phase must have
    run once per iteration. Returns (progress lines, ms per iteration by
    phase, env-steps/s incl. the update, launches, largest kernel error)."""
    import torch

    from evomotion_tpu_torch import cli
    from evomotion_tpu_torch.kernels import sweep as sp

    print(f"{label}: " + " ".join(argv), flush=True)
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
    n_envs = argv[argv.index("--num_envs") + 1]
    kern_err = captured_check(cap.inputs, cpu, f"{label} sweep, B={n_envs} {env.model.row_order}")
    text = buf.getvalue()
    for line in text.replace("\r", "\n").splitlines():
        if line.strip():
            print(f"{label}: {line.strip()}", flush=True)
    want = env.settle_total + iters * horizon
    print(f"{label}: sweep calls {calls}, kernel launches {launches}, physics steps {want}",
          flush=True)
    if rc != 0:
        fail(f"{label}: cli returned {rc}")
    if calls != want or (not cpu and launches != want):
        fail(f"{label}: expected {want} slim sweep launches, got {launches} launches of "
             f"{calls} calls")
    prog = PROGRESS.findall(text)
    losses = [float(x) for m in prog for x in m[:3]]
    if not prog or prog[-1][4] != str(iters) or not all(map(math.isfinite, losses)):
        fail(f"{label}: progress lines {prog}")
    prof = {k: (float(sec), int(n)) for k, sec, n in PROFILE.findall(
        text[text.index("[profile]"):])}
    rate = float(re.search(r"\(([\d,]+) env-steps/s incl\. update\)", text)
                 .group(1).replace(",", ""))
    if {k: n for k, (_, n) in prof.items()} != dict.fromkeys(
            ("rollout", "train_iter", "update"), iters):
        fail(f"{label}: profile {prof}")
    ms = {k: sec / n * 1e3 for k, (sec, n) in prof.items()}
    return prog, ms, rate, launches, kern_err


def ppo_train(args, dev, cpu, card, cap, keep):
    """Phase 15, the CLI's batched ``train``: ``cli.main(["cli",
    "robot_walk", "ppo_gae", "--num_envs", ..., "train", out, "-e", "3",
    "-n", "1"])`` with the walker's recipe (hidden 256, horizon 64, epoch 8,
    lr 1e-3) and ``EVOMOTION_PROFILE=1``. The losses must be finite, every
    actor tensor must have moved from its seeded init, and ``save_0``'s
    components must load back equal (on the card). The slim sweep's counts
    are set to 0 just before and read just after: one launch per physics
    step; the first call's inputs are kept and, after the run, go through
    the kernel and its plain version, which must agree within TOL. Then a
    100-step greedy eval of the saved actor at 16 envs. ``save_0`` is
    copied to ``keep`` (phase 24 runs it on the sequential agent)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from evomotion_tpu_torch import convert
    from evomotion_tpu_torch.envs.robot import RobotWalkFactory
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
        prog, ms, rate, launches, kern_err = profiled_train(argv, "ppo train", env, iters,
                                                            horizon, dev, cpu, cap)
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
        shutil.copytree(save, keep, dirs_exist_ok=True)

        n_smoke, h_smoke = (2, 3) if cpu else (OFF_EVAL_ENVS, OFF_EVAL_STEPS)
        r = ew.greedy_eval(env, ew.GreedyPolicy(actor).eval(), n_smoke, h_smoke,
                           torch.Generator(device=dev).manual_seed(args.seed))
    steps = r.steps.float()
    if not (bool(torch.isfinite(r.ret).all()) and int(r.steps.max()) <= h_smoke):
        fail("ppo train: the greedy eval of the trained actor gave non-finite returns")
    print(f"ppo train: greedy eval of save_0's actor, {n_smoke} envs x {h_smoke} steps: mean "
          f"valid steps {float(steps.mean()):.2f}, mean return {float(r.ret.mean()):.3f}, "
          f"{r.steps_s / h_smoke * 1e3:.3f} ms per env step [{card}]", flush=True)
    done("ppo train", t0)
    return {"launches": launches, "ms": ms, "rate": rate, "err": kern_err, "hidden": hidden}


# |card - CPU| bound on one off-policy update at full width: the four losses
# and every tensor the update moves (params, Adam moments and counts,
# BatchRenorm statistics, target critics, log_alpha); f32 matmuls on both
# (no TF32), summed in another order, as for the walker's actor (POLICY_TOL)
UPDATE_TOL = 1e-4
# the off-policy walker config, runs/walk_r4_crossq_s1234/config.json (the
# defaults of tools/train_walk_offpolicy.py): 256 envs x 64 steps, actor 256,
# BatchRenorm critics 1,024, batch 256, 4 updates per env step, a 2^20 ring,
# the nan guard on. Only the iteration count is cut: 1 against 12,000 (the
# script's time limit).
OFF_ENVS, OFF_ACTOR, OFF_CRITIC, OFF_BATCH, OFF_EPOCH, OFF_RING = 256, 256, 1024, 256, 4, 1 << 20
OFF_ITERS = 1
# the smoke evals of a trained actor (phases 15 and 17)
OFF_EVAL_ENVS, OFF_EVAL_STEPS = 16, 100
# the C2 resume's iteration length: an eighth of the walker config's 64
C2_HORIZON = 8
# agent parameters of the sequential cartpole train (strict keys, no
# defaults); episodes capped at 300 steps
SEQ_TRAIN_PARAMS = ["actor_hidden_size=64", "critic_hidden_size=64", "batch_size=64", "epoch=1",
                    "learning_rate=1e-3", "gamma=0.99", "replay_buffer_size=100000",
                    "train_every=1"]


def _offpolicy_agent(algo, seed, s, a, actor, critic, batch, device):
    from evomotion_tpu_torch.agents.cross_q import CrossQAgent
    from evomotion_tpu_torch.agents.soft_actor_critic import SoftActorCriticAgent

    args = (seed, s, a, actor, critic, batch, 1, 3e-4, 0.99)
    if algo == "soft_actor_critic":
        return SoftActorCriticAgent(*args, 0.005, 1, 1, device=device)
    return CrossQAgent(*args, 1, 1, device=device)


def _tree_errs(a, b):
    """{key: max |a - b|} over two flattened carries."""
    import numpy as np

    return {k: float(np.abs(a[k].astype(np.float64) - b[k]).max()) for k in b}


def offpolicy_update_check(args, dev, cpu, card):
    """Phase 16: CrossQ and SAC updates at the walker config's widths (obs
    371, action 12, actor 256, critics 1,024, batch 256) on the card and on
    the CPU from the same seeded init, batches and uniforms.

    Update 1, from the fresh init: the losses and every tensor of the
    agent's carry but the parameters within UPDATE_TOL (Adam moments and
    counts, BatchRenorm statistics, log_alpha's moments). Adam's first step
    is lr * g / (|g| + eps), the sign of g, for every element whose gradient
    is above 1e-8; among 5 million gradients a few dozen are that small by
    chance (1e-9 to 1e-7 against a largest of ~1 to 60) and differ between
    the card and the CPU by their f32 rounding (~1e-7), so such an element
    steps up to lr either way: the parameters are held within 2 lr after
    update 1. Update 2, from one state (the CPU's after update 1, loaded
    into the card's agent) on a second batch: Adam's moments now hold the
    first gradients, a tiny second gradient is no longer amplified, and the
    losses and every tensor of the carry, parameters included, must agree
    within UPDATE_TOL. Then the card's ms per update (CUDA events over 5 more
    updates), and its device launches and device time per update
    (``torch.profiler`` over 3 more)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from evomotion_tpu_torch.envs.robot import RobotWalkFactory
    from evomotion_tpu_torch.tools._profile import device_events
    from evomotion_tpu_torch.train.checkpoint import _flatten

    t0 = phase("offpolicy update check")
    env = RobotWalkFactory({}).make(args.seed, mt_parity=False, device=dev, per_env_step=False)
    s, a = env.observation_size, env.action_size
    actor, critic, b = (16, 16, 8) if cpu else (OFF_ACTOR, OFF_CRITIC, OFF_BATCH)
    lr = 3e-4
    rng = np.random.default_rng(args.seed)

    def make_batch():
        x = [rng.standard_normal((b, s)), rng.uniform(-1, 1, (b, a)),
             rng.standard_normal((b, 1)), rng.uniform(size=(b, 1)) < 0.05,
             rng.standard_normal((b, s)), rng.uniform(size=(b, a)), rng.uniform(size=(b, a))]
        return [torch.tensor(np.asarray(y, np.float32)) for y in x]

    batches = [make_batch(), make_batch()]
    out = {}
    for algo in ("cross_q", "soft_actor_critic"):
        agents = [_offpolicy_agent(algo, args.seed, s, a, actor, critic, b, d)
                  for d in (dev, "cpu")]
        params = {str(i) for i, c in enumerate(agents[0].CARRY)
                  if not c.endswith(("_optimizer", "_state"))}
        res = {}
        for n_upd, batch in enumerate(batches, 1):
            if n_upd == 2:
                agents[0].load_carry_tree(agents[1].carry_tree())
            losses = [ag.update([x.to(ag.device) for x in batch[:5]],
                                *(x.to(ag.device) for x in batch[5:])).cpu() for ag in agents]
            loss_err = float((losses[0] - losses[1]).abs().max())
            errs = _tree_errs(_flatten(agents[0].carry_tree()), _flatten(agents[1].carry_tree()))
            p_errs = {k: v for k, v in errs.items() if k.split("/")[0] in params}
            rest = {k: v for k, v in errs.items() if k not in p_errs}
            held = rest if n_upd == 1 else errs
            worst, p_worst = max(held, key=held.get), max(p_errs, key=p_errs.get)
            print(f"{algo} update {n_upd}, card vs CPU ({agents[0].count_parameters():,} "
                  f"parameters, batch {b}): losses {[round(x, 6) for x in losses[1].tolist()]},"
                  f" max |diff| {loss_err:.3e}; carry max |diff| {held[worst]:.3e} at {worst} "
                  f"over {len(held)} tensors (tol {UPDATE_TOL:g}); parameters {p_errs[p_worst]:.3e}"
                  f" at {p_worst}" + (f" (held within 2 lr = {2 * lr:g})" if n_upd == 1 else ""),
                  flush=True)
            p_tol = 2 * lr * (1 + 1e-3) if n_upd == 1 else UPDATE_TOL
            if not (loss_err <= UPDATE_TOL and held[worst] <= UPDATE_TOL
                    and p_errs[p_worst] <= p_tol):
                fail(f"{algo} update {n_upd} on the card disagrees with the CPU: losses "
                     f"{loss_err}, {worst} {held[worst]}, {p_worst} {p_errs[p_worst]}")
            res[f"update_{n_upd}"] = {"loss_err": loss_err, "carry_err": held[worst],
                                      "param_err": p_errs[p_worst]}
        ms = launches = busy = None
        if not cpu:
            card_batch = [x.to(dev) for x in batches[1]]

            def one_update(ag=agents[0]):
                ag.update(card_batch[:5], *card_batch[5:])

            ms = cuda_ms(one_update, 5)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    one_update()
                torch.cuda.synchronize()
            events = device_events(prof)
            launches, busy = len(events) / 3, sum(d for _, d in events) / 3e3
            print(f"{algo}: {ms:.3f} ms per update on the card (CUDA events, 5 updates); "
                  f"{launches:.0f} device launches (kernels, copies, fills) and {busy:.3f} ms "
                  f"of device time per update (torch.profiler, 3 updates): the device busy "
                  f"{100 * busy / ms:.1f}% [{card}]", flush=True)
        out[algo] = {**res, "ms_per_update": ms, "launches_per_update": launches,
                     "device_ms_per_update": busy}
    done("offpolicy update check", t0)
    return out


def _saved_equal(label, agent, save):
    """``save``'s components, loaded into ``agent``, come back equal."""
    import numpy as np

    from evomotion_tpu_torch.train.checkpoint import _flatten

    agent.load(save)
    for c in agent.SAVE:
        with np.load(os.path.join(save, f"{c}.npz")) as raw:
            got = _flatten(agent.tree(c))
            if got.keys() != set(raw.keys()) or not all(
                    np.array_equal(got[k], raw[k]) for k in got):
                fail(f"{label}: save_0 {c} did not load back equal")


def offpolicy_train(args, dev, cpu, card, cap, algo):
    """Phases 17-18, the CLI's batched off-policy ``train``: ``cli.main(["cli",
    "robot_walk", algo, "--num_envs", "256", ..., "train", out, "-e", "1",
    "-n", "1"])`` with the walker config (OFF_*) and ``EVOMOTION_PROFILE=1``.
    The losses must be finite, the ring must hold 16,384 transitions,
    every actor tensor must have moved from its seeded init, and ``save_0``
    must load back equal into a fresh agent on the card. The slim sweep's
    counts are set to 0 just before and read just after: one launch per
    physics step; the first call's inputs go through the kernel and its
    plain version after the run. For CrossQ, a 100-step greedy eval of the
    saved actor at 16 envs through ``tools.eval_walk``'s ``crossq`` tier."""
    import tempfile

    import numpy as np
    import torch

    from evomotion_tpu_torch.envs.robot import RobotWalkFactory
    from evomotion_tpu_torch.networks.modules import Actor
    from evomotion_tpu_torch.tools import eval_walk as ew
    from evomotion_tpu_torch.train import offpolicy_batched as ob

    label = f"{algo} train"
    t0 = phase(label)
    n_envs, actor, critic, batch, epoch, horizon, ring = (
        (2, 16, 16, 4, 1, 2, 64) if cpu
        else (OFF_ENVS, OFF_ACTOR, OFF_CRITIC, OFF_BATCH, OFF_EPOCH, 64, OFF_RING))
    iters = 2 if cpu else OFF_ITERS  # the rehearsal's tiny ring fills in its second
    kv = {"hidden_size": actor, "critic_hidden_size": critic, "batch_size": batch,
          "epoch": epoch, "learning_rate": 3e-4, "gamma": 0.99, "tau": 0.005, "train_every": 1,
          "horizon": horizon, "replay_buffer_size": ring, "nan_guard": "true"}
    states = []
    init = ob.BatchedOffPolicy.init

    def kept_init(self):
        states.append(init(self))
        return states[-1]

    with tempfile.TemporaryDirectory() as out, small_walker(cpu):
        env = RobotWalkFactory({}).make(args.seed, mt_parity=False, device=dev,
                                        per_env_step=False)
        argv = ["cli", "robot_walk", algo, "--num_envs", str(n_envs), "--env_seed",
                str(args.seed), "--agent_parameters", *(f"{k}={v}" for k, v in kv.items()),
                "train", out, "-e", str(iters), "-n", "1"]
        ob.BatchedOffPolicy.init = kept_init
        try:
            prog, ms, rate, launches, kern_err = profiled_train(argv, label, env, iters,
                                                                horizon, dev, cpu, cap)
        finally:
            ob.BatchedOffPolicy.init = init
        state = states[0]
        if state.ring.filled != iters * horizon * n_envs or state.iteration != iters:
            fail(f"{label}: ring filled {state.ring.filled} after {state.iteration} iterations")
        grads = horizon * epoch  # updates per iteration (train_every 1)
        grad_rate = grads / (ms["train_iter"] / 1e3)
        grad_rate_update = grads / (ms["update"] / 1e3)
        print(f"{label} [{card}]: per iteration ({horizon} steps x {n_envs} envs, {grads} "
              f"gradient steps of batch {batch}): rollout {ms['rollout']:.0f} ms, update "
              f"{ms['update']:.0f} ms, iteration {ms['train_iter']:.0f} ms (StepTimer, 10 ms "
              f"resolution); {rate:.0f} env-steps/s incl. the update; {grad_rate:.1f} "
              f"gradient steps/s ({grad_rate_update:.1f} within the update phase); ring "
              f"filled {state.ring.filled} of {state.ring.obs.shape[0]}; last actor loss "
              f"{prog[-1][0]}, critic loss {prog[-1][1]}", flush=True)
        del states[:], state

        save = os.path.join(out, "save_0")
        s, a = env.observation_size, env.action_size
        start = Actor(s, a, actor, torch.Generator().manual_seed(args.seed))
        agent = _offpolicy_agent(algo, 123, s, a, actor, critic, batch, dev)
        _saved_equal(label, agent, save)
        moved = {n: float((p.detach().cpu() - q.detach()).abs().max())
                 for (n, p), q in zip(agent.actor.named_parameters(), start.parameters())}
        if not all(x > 0 and math.isfinite(x) for x in moved.values()):
            fail(f"{label}: actor params did not all move from their init: {moved}")
        print(f"{label}: actor params moved from their init by max |diff| "
              f"{min(moved.values()):.3e} (least tensor) to {max(moved.values()):.3e}",
              flush=True)
        count = int(np.load(os.path.join(save, "actor_optimizer.npz"))["0/count"])
        print(f"{label}: save_0 ({len(agent.SAVE)} components) loads back equal on the card, "
              f"Adam count {count}", flush=True)
        if algo == "cross_q":
            n_smoke, h_smoke = (2, 3) if cpu else (OFF_EVAL_ENVS, OFF_EVAL_STEPS)
            policy = ew.load_policy("crossq", save, s, a, actor, dev)
            r = ew.greedy_eval(env, policy, n_smoke, h_smoke,
                               torch.Generator(device=dev).manual_seed(args.seed))
            if not (bool(torch.isfinite(r.ret).all()) and int(r.steps.max()) <= h_smoke):
                fail(f"{label}: the greedy eval of the trained actor gave non-finite returns")
            print(f"{label}: greedy eval of save_0's actor (eval_walk crossq tier), {n_smoke} "
                  f"envs x {h_smoke} steps: mean valid steps {float(r.steps.float().mean()):.2f}"
                  f", mean return {float(r.ret.mean()):.3f}, "
                  f"{r.steps_s / h_smoke * 1e3:.3f} ms per env step [{card}]", flush=True)
    done(label, t0)
    return {"launches": launches, "ms": ms, "rate": rate, "grad_rate": grad_rate,
            "err": kern_err}


def offpolicy_sequential(args, dev, cpu, card, fat_cap):
    """Phase 19, the sequential tier with learning agents: for SAC and then
    CrossQ, ``cli.main(["cli", "cartpole", algo, ..., "train", out, "-e",
    "2", "-n", "1"])`` (one env on the per-env step, an update per env step
    once the buffer holds a batch), then ``run`` of ``save_0``, one
    episode, each through :func:`seq_command`: the fat-row sweep once per
    physics step, each command's first call held against its plain
    version."""
    import tempfile

    t0 = phase("offpolicy sequential")
    total, errs = 0, []
    with perenv_steps() as steps:
        for algo in ("soft_actor_critic", "cross_q"):
            params = [f"seed={args.seed}", *SEQ_TRAIN_PARAMS] + (
                ["tau=0.005"] if algo == "soft_actor_critic" else [])
            base = ["cli", "cartpole", algo, "--env_seed", str(args.seed), "--agent_parameters",
                    *params, "--env_parameters", "mas_steps=300"]
            with tempfile.TemporaryDirectory() as out:
                for what, argv in (("train", base + ["train", out, "-e", "2", "-n", "1"]),
                                   ("run", base + ["run", os.path.join(out, "save_0"),
                                                   "--episodes", "1"])):
                    r = seq_command(argv, f"cartpole {algo} {what}", 1, dev, cpu, card, fat_cap,
                                    steps)
                    if what == "train" and not os.path.exists(
                            os.path.join(out, "save_0", "actor.npz")):
                        fail(f"cartpole {algo} train: no save_0")
                    total += r["launches"]
                    errs.append(r["err"])
    done("offpolicy sequential", t0)
    return {"launches": total, "err": max(errs)}


def _all_tensors(x):
    if isinstance(x, tuple):
        return [t for y in x for t in _all_tensors(y)]
    return [x]


def _max_diff(xs, ys):
    return max(float((x.detach().double() - y.detach().double()).abs().max())
               for x, y in zip(xs, ys))


@contextlib.contextmanager
def deterministic(on):
    """While open, ``torch.use_deterministic_algorithms(True)`` with the
    cuBLAS workspace setting that mode asks for, when ``on``."""
    import torch

    if not on:
        yield
        return
    old = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        if old is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = old


def c2_reading(args, dev, cpu, card):
    """Phase 20, a reading (ROADMAP C2): is the card's batched step
    reproducible? One seeded batched state at B=256 stepped twice with the
    same action, by default and under torch.use_deterministic_algorithms
    (the op it raises on, if any); then the full-state resume of one CrossQ
    iteration at the walker widths (16 steps per iteration, ring cut to 4
    blocks), in the deterministic mode where that mode made the step
    bit-equal (by default,
    the spider's chaos carries the step's rounding to O(10) differences over
    an iteration): the state loaded by ``load_full`` must equal the saved
    one, and one iteration from each must agree within UPDATE_TOL."""
    import tempfile

    import torch

    from evomotion_tpu_torch.envs.robot import RobotWalkFactory
    from evomotion_tpu_torch.train.offpolicy_batched import BatchedOffPolicy, OffPolicyConfig

    t0 = phase("c2 reading")
    n = 2 if cpu else OFF_ENVS
    out = {}
    with small_walker(cpu):
        env = RobotWalkFactory({}).make(args.seed, mt_parity=False, device=dev,
                                        per_env_step=False)
        state, _ = env.reset(n, torch.Generator(device=dev).manual_seed(args.seed))
        action = torch.rand((n, env.action_size), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(args.seed)) * 2 - 1

        def twice():
            runs = [_all_tensors(env.step(state, action, torch.Generator(device=dev)
                                          .manual_seed(1))) for _ in range(2)]
            return _max_diff(*runs), all(torch.equal(x, y) for x, y in zip(*runs))

        for mode in ("default", "deterministic"):
            try:
                with deterministic(mode == "deterministic"):
                    diff, same = twice()
                out[mode] = {"max_diff": diff, "bit_equal": same, "raised": None}
            except RuntimeError as e:  # the op the deterministic mode refuses
                out[mode] = {"max_diff": None, "bit_equal": False,
                             "raised": str(e).splitlines()[0][:300]}
            print(f"c2: one batched step at B={n}, twice from one state, {mode} mode: "
                  f"{out[mode]} [{card}]", flush=True)
        del state

        horizon = 2 if cpu else C2_HORIZON
        actor, critic, batch, epoch = (16, 16, 4, 1) if cpu else (
            OFF_ACTOR, OFF_CRITIC, OFF_BATCH, OFF_EPOCH)
        cfg = OffPolicyConfig(
            actor_hidden_size=actor, critic_hidden_size=critic, batch_size=batch, epoch=epoch,
            steps_per_iter=horizon, n_envs=n, buffer_capacity=4 * horizon * n, nan_guard=True)

        def everything(st, metrics=()):
            return _all_tensors(tuple(st.agent.tensors()) + tuple(st.ring[:6]) + (
                st.env_state, st.obs, st.prev_valid, st.ep_steps) + tuple(metrics))

        mode = "deterministic" if out["deterministic"]["bit_equal"] else "default"
        trainer = BatchedOffPolicy(env, "cross_q", cfg, seed=args.seed)
        step = trainer.train_step_fn()
        with deterministic(mode == "deterministic"):
            a = trainer.init()
            a, _ = step(a)
            with tempfile.TemporaryDirectory() as d:
                trainer.save_full(d, a)
                b = trainer.load_full(d, BatchedOffPolicy(env, "cross_q", cfg,
                                                          seed=args.seed + 1).init())
            ta, tb = everything(a), everything(b)
            loaded_equal = len(ta) == len(tb) and all(torch.equal(x, y) for x, y in zip(ta, tb))
            a, ma = step(a)
            b, mb = step(b)
            ta, tb = everything(a, ma), everything(b, mb)
            diff = _max_diff(ta, tb)
            agent_diff = _max_diff(a.agent.tensors(), b.agent.tensors())
        print(f"c2: full-state resume of one CrossQ iteration ({n} envs x {horizon} steps, ring "
              f"{trainer.capacity}), {mode} mode: loaded state equal to the saved one "
              f"{loaded_equal}; after one more iteration from each, max |diff| {diff:.3e} over "
              f"{len(ta)} tensors (agent alone {agent_diff:.3e}) [{card}]", flush=True)
        out["resume"] = {"mode": mode, "loaded_equal": loaded_equal, "max_diff": diff,
                         "agent_max_diff": agent_diff}
        if not loaded_equal:
            fail(f"c2: the state load_full read back differs from the saved one ({mode})")
        if not diff <= UPDATE_TOL:
            fail(f"c2: the resumed iteration ({mode} mode) differs by {diff} > {UPDATE_TOL}")
    done("c2 reading", t0)
    return out


# ---- the on-policy tier and robot_jump (phases 21-24) --------------------------

# phase 21's widths: the walker's (obs 371, action 12, hidden 256); A2C at its
# batch, PPO-vanilla on one 256-env x 64-step block with 8 epochs, the
# sequential PPO-GAE on 8 trajectories of up to the 1800-step win horizon
ON_HIDDEN, ON_LR, ON_EPOCH = 256, 1e-3, 8
A2C_BATCH, VANILLA_BATCH, GAE_TRAJ, GAE_MAX_LEN = 256, 256 * 64, 8, 1800
ON_ALGOS = ("actor_critic", "ppo_vanilla", "ppo_gae")
# phase 22: the batched jump rollout after its reset (10 settle steps)
JUMP_ENVS, JUMP_STEPS = 2048, 60
# phase 23: the CLI's batched A2C and PPO-vanilla train, iterations (cut
# for the script's time limit)
ON_TRAIN_ITERS = 1
# phase 24: agent parameters of the sequential cartpole train (strict keys)
ON_SEQ_PARAMS = {
    "actor_critic": ["hidden_size=64", "batch_size=64", "lr=1e-3", "gamma=0.99",
                     "entropy_start_factor=0.01", "entropy_end_factor=0.0001",
                     "entropy_steps=100000", "replay_buffer_size=100000", "train_every=1"],
    "ppo_vanilla": ["hidden_size=64", "gamma=0.99", "epsilon=0.2", "entropy_factor=0.01",
                    "critic_loss_factor=0.5", "epoch=8", "batch_size=64",
                    "learning_rate=1e-3"],
    "ppo_gae": ["hidden_size=64", "gamma=0.99", "lambda=0.95", "epsilon=0.2",
                "entropy_factor=0.01", "critic_loss_factor=0.5", "epoch=8", "batch_size=2",
                "train_every=1", "replay_buffer_size=64", "learning_rate=1e-3",
                "clip_grad_norm=0.5"],
}


def _onpolicy_agent(algo, seed, s, a, hidden, batch, epoch, device):
    from evomotion_tpu_torch.agents.actor_critic import ActorCriticAgent
    from evomotion_tpu_torch.agents.ppo_gae import PpoGaeAgent
    from evomotion_tpu_torch.agents.ppo_vanilla import PpoVanillaAgent

    if algo == "actor_critic":
        return ActorCriticAgent(seed, s, a, hidden, batch, ON_LR, 0.99, 0.01, 1e-4, 100000, 1,
                                1, device=device)
    if algo == "ppo_vanilla":
        return PpoVanillaAgent(seed, s, a, hidden, 0.99, 0.2, 0.01, 0.5, epoch, batch, ON_LR,
                               device=device)
    return PpoGaeAgent(seed, s, a, hidden, 0.99, 0.95, 0.2, 0.01, 0.5, epoch, batch, 1, 8,
                       ON_LR, 0.5, device=device)


def _onpolicy_batch(algo, rng, s, a, sizes, agent):
    """One update's inputs, numpy-made on the CPU: a step batch (A2C,
    PPO-vanilla) or padded trajectories (PPO-GAE) built by the agent's own
    ``pack`` from episode steps, with log-probs near the actor's own."""
    import numpy as np
    import torch

    from evomotion_tpu_torch.buffers.replay import PpoEpisodeStep
    from evomotion_tpu_torch.networks import distributions as D

    def f32(x):
        return torch.tensor(np.asarray(x, np.float32))

    if algo != "ppo_gae":
        b = sizes[algo]
        return [f32(rng.standard_normal((b, s))), f32(rng.uniform(-1, 1, (b, a))),
                f32(rng.standard_normal((b, 1))), f32(rng.uniform(size=(b, 1)) < 0.05),
                f32(rng.standard_normal((b, s)))]
    n_traj, max_len = sizes["ppo_gae"]
    lens = rng.integers(max_len // 2, max_len + 1, n_traj)
    lens[0] = max_len
    episodes = []
    for n in lens:
        states, actions = f32(rng.standard_normal((n, s))), f32(rng.uniform(-1, 1, (n, a)))
        with torch.no_grad():
            lp = D.truncated_normal_log_pdf(actions, *agent.actor(states))
        lp = lp + f32(0.05 * rng.standard_normal((n, a)))
        v = f32(0.3 * rng.standard_normal((n + 1, 1)))
        episodes.append([PpoEpisodeStep(states[t], actions[t], float(rng.standard_normal()),
                                        t == n - 1, lp[t], v[t], v[t + 1]) for t in range(n)])
    return list(agent.pack(episodes))


def onpolicy_update_check(args, dev, cpu, card):
    """Phase 21: an update of each on-policy agent (A2C at batch 256,
    PPO-vanilla on a 16,384-step block with 8 epochs, the sequential PPO-GAE
    on 8 padded trajectories of up to 1800 steps) at the walker's widths on
    the card and on the CPU, from the same seeded init, inputs and entropy
    factor. None of these updates draws a random number.

    Update 1, from the fresh init: the losses within UPDATE_TOL, every
    parameter within 2 lr per epoch (Adam's first step is the sign of each
    gradient, and at these widths a few are at f32 noise by chance, ROADMAP
    Queue C trap 11; the PPO critics' output-bias and last LayerNorm-bias
    gradients are zero in exact arithmetic at the first epoch), and A2C's
    Adam moments (its one step) within UPDATE_TOL. The PPOs' Adam moments
    after update 1 are printed, not held: their first epoch leaves the
    card's and the CPU's parameters up to lr apart in those elements, and
    each of the 7 later epochs' gradients inherits that (the actor's moments
    read 1.0e-4 apart on an H100). Update 2, from one state (the CPU's after
    update 1, loaded into the card's agent) on a second input, where Adam's
    moments hold real gradients and no noise is amplified: the losses and
    every parameter within UPDATE_TOL, and A2C's whole carry. The PPOs'
    Adam moments are printed again: their clipped surrogate is not smooth,
    and from the second epoch on a sample whose probability ratio lies
    within f32 rounding of the clip edge 1 +- epsilon enters one device's
    gradient and not the other's, moving a moment by that sample's share of
    the batch gradient (PPO-vanilla's actor moments read 1.3e-4 apart on an
    H100, its parameters 6.0e-5). Then the card's ms per update
    (CUDA events), and its device launches and device time per update
    (``torch.profiler``)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from evomotion_tpu_torch.tools._profile import device_events
    from evomotion_tpu_torch.train.checkpoint import _flatten

    t0 = phase("onpolicy update check")
    s, a = 371, 12
    hidden, epoch = (16, 2) if cpu else (ON_HIDDEN, ON_EPOCH)
    sizes = ({"actor_critic": 8, "ppo_vanilla": 64, "ppo_gae": (3, 40)} if cpu else
             {"actor_critic": A2C_BATCH, "ppo_vanilla": VANILLA_BATCH,
              "ppo_gae": (GAE_TRAJ, GAE_MAX_LEN)})
    rng = np.random.default_rng(args.seed)
    out = {}
    for algo in ON_ALGOS:
        n_epochs = 1 if algo == "actor_critic" else epoch
        b = sizes[algo][0] if algo == "ppo_gae" else sizes[algo]
        agents = [_onpolicy_agent(algo, args.seed, s, a, hidden, b, epoch, d)
                  for d in (dev, "cpu")]
        inputs = [_onpolicy_batch(algo, rng, s, a, sizes, agents[1]) for _ in range(2)]
        shape = tuple(inputs[0][0].shape)

        def update(ag, batch):
            batch = [x.to(ag.device) for x in batch]
            return ag.update(batch, 0.01) if algo == "actor_critic" else ag.update(batch)

        res = {}
        for n_upd, batch in enumerate(inputs, 1):
            if n_upd == 2:
                agents[0].load_carry_tree(agents[1].carry_tree())
            losses = [update(ag, batch).cpu() for ag in agents]
            loss_err = float((losses[0] - losses[1]).abs().max())
            errs = _tree_errs(_flatten(agents[0].carry_tree()), _flatten(agents[1].carry_tree()))
            params = {k: v for k, v in errs.items() if k.split("/")[0] in ("0", "2")}
            actor_adam = {k: v for k, v in errs.items() if k.split("/")[0] == "1"}
            critic_adam = {k: v for k, v in errs.items() if k.split("/")[0] == "3"}
            if algo == "actor_critic":
                held = errs if n_upd == 2 else {**actor_adam, **critic_adam}
            else:
                held = params if n_upd == 2 else {}
            p_tol = 2 * ON_LR * n_epochs * (1 + 1e-3) if n_upd == 1 else UPDATE_TOL
            p_worst = max(params, key=params.get)
            adam = {**actor_adam, **critic_adam}
            a_worst = max(adam, key=adam.get)
            worst = max(held, key=held.get) if held else None
            held_err = held[worst] if held else 0.0
            print(f"{algo} update {n_upd}, card vs CPU ({agents[0].count_parameters():,} "
                  f"parameters, input {shape}, {n_epochs} epoch(s)): losses max |diff| "
                  f"{loss_err:.3e}; parameters {params[p_worst]:.3e} at {p_worst} (tol "
                  f"{p_tol:.3g}); Adam moments {adam[a_worst]:.3e} at {a_worst} "
                  f"({'held' if a_worst in held else 'printed'}); held tensors {len(held)}, "
                  f"max |diff| "
                  f"{held_err:.3e} (tol {UPDATE_TOL:g})", flush=True)
            if not (loss_err <= UPDATE_TOL and held_err <= UPDATE_TOL
                    and params[p_worst] <= p_tol):
                fail(f"{algo} update {n_upd} on the card disagrees with the CPU: losses "
                     f"{loss_err}, {worst} {held_err}, {p_worst} {params[p_worst]}")
            res[f"update_{n_upd}"] = {"loss_err": loss_err, "held_err": held_err,
                                      "param_err": params[p_worst], "adam_err": adam[a_worst]}
        ms = launches = busy = None
        if not cpu:
            card_batch = [x.to(dev) for x in inputs[1]]
            reps = {"actor_critic": 10, "ppo_vanilla": 3, "ppo_gae": 2}[algo]
            ms = cuda_ms(lambda: update(agents[0], card_batch), reps)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                update(agents[0], card_batch)
                torch.cuda.synchronize()
            events = device_events(prof)
            launches, busy = len(events), sum(d for _, d in events) / 1e3
            print(f"{algo}: {ms:.3f} ms per update on the card (CUDA events, {reps} updates); "
                  f"{launches} device launches (kernels, copies, fills) and {busy:.3f} ms of "
                  f"device time per update (torch.profiler): the device busy "
                  f"{100 * busy / ms:.1f}% [{card}]", flush=True)
        out[algo] = {**res, "ms_per_update": ms, "launches_per_update": launches,
                     "device_ms_per_update": busy}
    done("onpolicy update check", t0)
    return out


@contextlib.contextmanager
def perenv_steps():
    """While open, counts the per-env physics steps (``PerEnvStep._run``
    calls) in the one-element list it yields."""
    from evomotion_tpu_torch.physics import perenv

    steps = [0]
    run_once = perenv.PerEnvStep._run

    def counted(self, *a):
        steps[0] += 1
        return run_once(self, *a)

    perenv.PerEnvStep._run = counted
    try:
        yield steps
    finally:
        perenv.PerEnvStep._run = run_once


def seq_command(argv, label, per_step, dev, cpu, card, fat_cap, steps):
    """One sequential CLI command (``train`` with one env, or ``run``): the
    fat-row sweep's counts and the per-env physics steps (``steps``, from
    :func:`perenv_steps`) are set to 0 just before and read just after, and
    the sweep must have launched ``per_step`` times per physics step; its
    first call is then held against its plain version. A ``train`` must
    print finite meters, a ``run`` a finite episode line. Returns the
    readings."""
    import torch

    from evomotion_tpu_torch import cli
    from evomotion_tpu_torch.kernels import sweep_fat as sf

    buf = io.StringIO()
    fat_cap.arm(limit=1)
    sf.KERNEL.launches = fat_cap.calls = steps[0] = 0
    ts = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv, device=dev)
        if not cpu:
            torch.cuda.synchronize()
    finally:
        fat_cap.armed = False
    wall = time.perf_counter() - ts
    n_phys, launches, calls = steps[0], sf.KERNEL.launches, fat_cap.calls
    text = buf.getvalue().replace("\r", "\n")
    lines = [x.strip() for x in text.splitlines() if x.strip()]
    print(f"{label}: {lines[-1] if lines else '(no output)'}", flush=True)
    print(f"{label}: {n_phys} physics steps, fat sweep calls {calls}, kernel launches "
          f"{launches}, {wall:.2f} s, {wall / max(n_phys, 1) * 1e3:.2f} ms per physics step "
          f"(host clock) [{card}]", flush=True)
    if rc != 0:
        fail(f"{label}: cli returned {rc}")
    if n_phys < 1 or calls != per_step * n_phys or (not cpu and launches != calls):
        fail(f"{label}: expected {per_step} fat sweep launches per physics step, got "
             f"{launches} launches / {calls} calls in {n_phys} physics steps")
    if "train" in argv:
        meters = dict(re.findall(r"(\w+) = (\S+)", lines[-1] if lines else ""))
        if not meters or not all(math.isfinite(float(v)) for v in meters.values()):
            fail(f"{label}: meters {meters}")
    else:
        eps = [m for m in map(EPISODE_LINE.match, lines) if m]  # --record prints after
        if not eps or not math.isfinite(float(eps[-1].group(3))):
            fail(f"{label}: episode line {lines[-3:]}")
    inp, fat_cap.captured = fat_cap.inputs, []
    _, err, _ = fat_check(inp, cpu, f"{label}: first sweep call")
    episodes = [int(m.group(2)) for m in map(EPISODE_LINE.match, lines) if m]
    return {"physics_steps": n_phys, "launches": launches, "s": wall, "err": err,
            "episode_steps": episodes}


def robot_jump(args, dev, cpu, card, cap, fat_cap):
    """Phase 22, robot_jump: one batched jump physics step of 4 envs on the
    card (kernel) against the CPU (plain version), f32 rows; ``RobotJump``
    at B=2048, reset (10 settle steps) and 60 steps of uniform random
    actions (finite outputs, the spider down on the floor after the steps,
    the slim sweep launched once per physics step with its counts set to 0
    just before and read just after, its first call held against its plain
    version); then the CLI's sequential ``run`` of one episode, the fat-row
    sweep launched twice per physics step."""
    import torch

    from evomotion_tpu_torch.envs.robot import RobotJump, RobotJumpParams

    t0 = phase("robot_jump")
    n_envs, n_steps = (4, 3) if cpu else (JUMP_ENVS, JUMP_STEPS)
    env = RobotJump(RobotJumpParams(), device=dev)
    if not cpu:
        env32 = RobotJump(RobotJumpParams(), device=dev)
        env32.model = dataclasses.replace(env32.model, row_dtype="f32")
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        state, _ = env32.reset(4, gen)
        action = torch.rand((4, env.action_size), generator=gen, device=dev) * 2 - 1
        step_err = batched_step_check(env32, state, action, 4, dev, "robot_jump, f32 rows")
        del env32, state
    cap.arm(limit=1)
    try:
        run = batched_rollout(env, n_envs, n_steps, args.seed + 2, cap, dev, cpu, card,
                              "robot_jump batched", settled_after_reset=False)
    finally:
        cap.armed = False
    kern_err = captured_check(cap.inputs, cpu, f"robot_jump batched sweep, B={n_envs}")
    argv = ["cli", "robot_jump", "random", "--env_seed", str(args.seed)]
    if cpu:  # rehearsal: a 1-frame settle and a 3-step bank
        argv += ["--env_parameters", "reset_seconds=0.02", "initial_seconds=0.05"]
    with perenv_steps() as steps:
        seq = seq_command(argv + ["run", ".", "--episodes", "1"], "robot_jump run", 2, dev,
                          cpu, card, fat_cap, steps)
    done("robot_jump", t0)
    return {"batched": run, "kernel_err": kern_err, "run": seq,
            "step_err": None if cpu else step_err}


def onpolicy_train(args, dev, cpu, card, cap, algo):
    """Phase 23, the CLI's batched A2C or PPO-vanilla ``train``: ``cli.main([
    "cli", "robot_walk", algo, "--num_envs", "2048", ..., "train", out, "-e",
    "1", "-n", "1"])`` with hidden 256, horizon 64, batch 256, 8 epochs and
    ``EVOMOTION_PROFILE=1`` (``profiled_train``: the slim sweep once per
    physics step, its first call against its plain version). The losses
    must be finite, every actor tensor must have moved from its seeded init,
    and ``save_0`` must load back equal into a fresh agent on the card."""
    import tempfile

    import numpy as np
    import torch

    from evomotion_tpu_torch.envs.robot import RobotWalkFactory
    from evomotion_tpu_torch.networks.modules import Actor

    label = f"{algo} train"
    t0 = phase(label)
    n_envs, hidden, horizon, batch, epoch = (2, 16, 2, 4, 1) if cpu else (
        2048, ON_HIDDEN, 64, 256, ON_EPOCH)
    iters = 2 if cpu else ON_TRAIN_ITERS  # the rehearsal's tiny ring fills in its second
    with tempfile.TemporaryDirectory() as out, small_walker(cpu):
        env = RobotWalkFactory({}).make(args.seed, mt_parity=False, device=dev,
                                        per_env_step=False)
        argv = ["cli", "robot_walk", algo, "--num_envs", str(n_envs), "--env_seed",
                str(args.seed), "--agent_parameters", f"hidden_size={hidden}",
                f"horizon={horizon}", f"batch_size={batch}", f"epoch={epoch}",
                "learning_rate=1e-3", "train", out, "-e", str(iters), "-n", "1"]
        prog, ms, rate, launches, kern_err = profiled_train(argv, label, env, iters,
                                                            horizon, dev, cpu, cap)
        updates = horizon if algo == "actor_critic" else epoch
        print(f"{label} [{card}]: per iteration ({horizon} steps x {n_envs} envs, {updates} "
              f"{'update events of batch ' + str(batch) if algo == 'actor_critic' else 'epochs over the block'}"
              f"): rollout {ms['rollout']:.0f} ms, update {ms['update']:.0f} ms, iteration "
              f"{ms['train_iter']:.0f} ms (StepTimer, 10 ms resolution); {rate:.0f} "
              f"env-steps/s incl. the update; last actor loss {prog[-1][0]}, critic loss "
              f"{prog[-1][1]}", flush=True)
        save = os.path.join(out, "save_0")
        s, a = env.observation_size, env.action_size
        start = Actor(s, a, hidden, torch.Generator().manual_seed(args.seed))
        agent = _onpolicy_agent(algo, 123, s, a, hidden, batch, epoch, dev)
        _saved_equal(label, agent, save)
        moved = {n: float((p.detach().cpu() - q.detach()).abs().max())
                 for (n, p), q in zip(agent.actor.named_parameters(), start.parameters())}
        if not all(x > 0 and math.isfinite(x) for x in moved.values()):
            fail(f"{label}: actor params did not all move from their init: {moved}")
        print(f"{label}: actor params moved from their init by max |diff| "
              f"{min(moved.values()):.3e} (least tensor) to {max(moved.values()):.3e}",
              flush=True)
        count = int(np.load(os.path.join(save, "actor_optimizer.npz"))["0/count"])
        # A2C's events wait for a batch of trainable transitions in the ring:
        # at 2048 envs the first block holds one, in the rehearsal not yet
        want = iters * updates
        if not (count == want or (cpu and 0 < count < want)):
            fail(f"{label}: Adam count {count}, expected {want}")
        print(f"{label}: save_0 ({len(agent.SAVE)} components) loads back equal on the card, "
              f"Adam count {count}", flush=True)
    done(label, t0)
    return {"launches": launches, "ms": ms, "rate": rate, "err": kern_err}


def onpolicy_sequential(args, dev, cpu, card, fat_cap, ppo_save, ppo_hidden):
    """Phase 24, the sequential tier with the on-policy agents: ``cli
    cartpole <agent> ... train -e 2 -n 1`` then ``run`` of ``save_0`` for
    A2C, PPO-vanilla and PPO-GAE (the fat-row sweep once per physics step);
    ``cli robot_jump ppo_gae ... train -e 3 -n 1`` at hidden 256 (batch 2
    trajectories: updates after episodes 2 and 3) then ``run``, and ``cli
    robot_walk ppo_gae ... run`` of phase 15's batched ``save_0``, the
    full-width spider on the sequential PPO-GAE (twice per physics step).
    Each command through :func:`seq_command`."""
    import tempfile

    t0 = phase("onpolicy sequential")
    gae = [f"seed={args.seed}", *ON_SEQ_PARAMS["ppo_gae"]]
    jump_env = (["--env_parameters", "reset_seconds=0.02", "initial_seconds=0.05"] if cpu
                else [])
    total, errs, ms = 0, [], {}
    with perenv_steps() as steps, tempfile.TemporaryDirectory() as tmp, small_walker(cpu):
        cases = []
        for agent in ON_ALGOS:
            base = ["cli", "cartpole", agent, "--env_seed", str(args.seed), "--agent_parameters",
                    f"seed={args.seed}", *ON_SEQ_PARAMS[agent], "--env_parameters",
                    "mas_steps=300"]
            out = os.path.join(tmp, agent)
            cases += [(f"cartpole {agent} train", base + ["train", out, "-e", "2", "-n", "1"], 1),
                      (f"cartpole {agent} run", base + ["run", os.path.join(out, "save_0"),
                                                        "--episodes", "1"], 1)]
        hid = "hidden_size=16" if cpu else f"hidden_size={ON_HIDDEN}"
        jump = ["cli", "robot_jump", "ppo_gae", "--env_seed", str(args.seed), "--agent_parameters",
                *gae, hid, *jump_env]
        out = os.path.join(tmp, "jump")
        cases += [("robot_jump ppo_gae train", jump + ["train", out, "-e", "3", "-n", "1"], 2),
                  ("robot_jump ppo_gae run", jump + ["run", os.path.join(out, "save_0"),
                                                     "--episodes", "1"], 2)]
        walk = ["cli", "robot_walk", "ppo_gae", "--env_seed", str(args.seed),
                "--agent_parameters", *gae, f"hidden_size={ppo_hidden}"]
        if cpu:
            walk += ["--env_parameters", "initial_remaining_seconds=0.05"]
        cases.append(("robot_walk ppo_gae run of the batched save_0",
                      walk + ["run", ppo_save, "--episodes", "1"], 2))
        for label, argv, per_step in cases:
            r = seq_command(argv, label, per_step, dev, cpu, card, fat_cap, steps)
            total += r["launches"]
            errs.append(r["err"])
            ms[label] = r["s"] / r["physics_steps"] * 1e3
    done("onpolicy sequential", t0)
    return {"launches": total, "err": max(errs), "ms_per_physics_step": ms}


# ---- the liquid tier (phases 25-28) -------------------------------------------

# the JAX driver's liquid defaults (evomotion_tpu/train/driver.py:114-118,
# 260-265): 64 neurons, 6 unfoldings; at the walker's obs 371 and action 12
LIQ_NEURONS, LIQ_STEPS = 64, 6
LIQ_ALGOS = ("actor_critic_liquid", "ppo_gae_liquid", "soft_actor_critic_liquid")
# phase 25: A2C and SAC at batch 256, PPO-GAE on 8 trajectories of up to the
# 1800-step win horizon (padded to 1,824 as the JAX agent pads them), 8
# epochs; lr 1e-3 (A2C, PPO-GAE) and 3e-4 (SAC), the driver's
LIQ_BATCH, LIQ_GAE_TRAJ, LIQ_GAE_MAX_LEN, LIQ_EPOCH = 256, 8, 1800, 8
LIQ_LR = {"actor_critic_liquid": 1e-3, "ppo_gae_liquid": 1e-3, "soft_actor_critic_liquid": 3e-4}
# phases 26-27: the CLI's batched liquid PPO-GAE at B=2048 and liquid SAC at
# B=256 (horizon 64, SAC batch 256 with an update per env step and a
# 65,536-entry ring), each 1 iteration (cut for the script's time limit)
LIQ_PPO_ENVS, LIQ_SAC_ENVS, LIQ_ITERS = 2048, 256, 1
# phase 28: agent parameters of the sequential cartpole train (strict keys)
LIQ_SEQ_PARAMS = {
    "actor_critic_liquid": ["neuron_number=64", "batch_size=64", "lr=1e-3", "gamma=0.99",
                            "entropy_start_factor=0.01", "entropy_end_factor=0.0001",
                            "entropy_steps=100000", "unfolding_steps=6",
                            "replay_buffer_size=100000", "train_every=1"],
    "ppo_gae_liquid": ["neuron_number=64", "unfolding_steps=6", "gamma=0.99", "lambda=0.95",
                       "epsilon=0.2", "entropy_factor=0.01", "critic_loss_factor=0.5",
                       "epoch=8", "batch_size=2", "train_every=1", "replay_buffer_size=64",
                       "learning_rate=1e-3", "clip_grad_norm=0.5"],
    "soft_actor_critic_liquid": ["neuron_number=64", "batch_size=64", "epoch=1",
                                 "learning_rate=1e-3", "gamma=0.99", "tau=0.005",
                                 "unfolding_steps=6", "replay_buffer_size=100000",
                                 "train_every=1"],
}
# the port's copy of the JAX package's liquid-SAC cartpole checkpoint
# (tools/train_offpolicy_cartpole.py: 32 neurons, 6 unfoldings); run with
# train_every beyond the run's steps, so that its agent, which trains inside
# act as the reference's does, plays the checkpoint's own policy throughout
LIQ_CARTPOLE_SAVE = os.path.join("evomotion_tpu_torch", "resources", "cartpole_sac_liquid")
LIQ_CARTPOLE_PARAMS = ["neuron_number=32", "batch_size=128", "epoch=1", "learning_rate=1e-3",
                       "gamma=0.99", "tau=0.005", "unfolding_steps=6",
                       "replay_buffer_size=8192", "train_every=1000000"]


def _liquid_agent(algo, seed, s, a, neurons, steps, batch, epoch, device):
    from evomotion_tpu_torch.agents import liquid_agents as la

    lr = LIQ_LR[algo]
    if algo == "actor_critic_liquid":
        return la.ActorCriticLiquidAgent(seed, s, a, neurons, batch, lr, 0.99, 0.01, 1e-4,
                                         100000, steps, 1, 1, device=device)
    if algo == "ppo_gae_liquid":
        return la.PpoGaeLiquidAgent(seed, s, a, neurons, steps, 0.99, 0.95, 0.2, 0.01, 0.5,
                                    epoch, batch, 1, 8, lr, 0.5, device=device)
    return la.SoftActorCriticLiquidAgent(seed, s, a, neurons, batch, 1, lr, 0.99, 0.005, steps,
                                         1, 1, device=device)


def _liquid_batch(algo, rng, s, a, sizes, agent):
    """One update's inputs, numpy-made on the CPU, hidden states N(0, 1): a
    step batch with its stored in and out states {net: [B, n]} (A2C; SAC
    with its two [B, A] uniforms last), or padded trajectories with their
    stored states built by the agent's own ``pack`` (PPO-GAE), log-probs
    near the actor's own."""
    import numpy as np
    import torch

    from evomotion_tpu_torch.buffers.replay import LiquidPpoEpisodeStep, PpoEpisodeStep
    from evomotion_tpu_torch.networks import distributions as D

    def f32(x):
        return torch.tensor(np.asarray(x, np.float32))

    n = agent.neurons
    if algo != "ppo_gae_liquid":
        b = sizes[algo]
        xs = [{k: f32(rng.standard_normal((b, n))) for k in agent.NETS} for _ in range(2)]
        out = [f32(rng.standard_normal((b, s))), f32(rng.uniform(-1, 1, (b, a))),
               f32(rng.standard_normal((b, 1))), f32(rng.uniform(size=(b, 1)) < 0.05),
               f32(rng.standard_normal((b, s))), *xs]
        if algo == "soft_actor_critic_liquid":
            out += [f32(rng.uniform(size=(b, a))), f32(rng.uniform(size=(b, a)))]
        return out
    n_traj, max_len = sizes[algo]
    lens = rng.integers(max_len // 2, max_len + 1, n_traj)
    lens[0] = max_len
    episodes = []
    for m in lens:
        states, actions = f32(rng.standard_normal((m, s))), f32(rng.uniform(-1, 1, (m, a)))
        ax, cx = f32(rng.standard_normal((m, n))), f32(rng.standard_normal((m, n)))
        with torch.no_grad():
            lp = D.truncated_normal_log_pdf(actions, *agent.actor(ax, states)[:2])
        lp = lp + f32(0.05 * rng.standard_normal((m, a)))
        v = f32(0.3 * rng.standard_normal((m + 1, 1)))
        episodes.append([LiquidPpoEpisodeStep(
            PpoEpisodeStep(states[t], actions[t], float(rng.standard_normal()), t == m - 1, lp[t],
                           v[t], v[t + 1]), {"actor": ax[t], "critic": cx[t]})
            for t in range(m)])
    return list(agent.pack(episodes))


def _liquid_update(algo, agent, batch):
    """One update of ``agent`` on ``batch`` (moved to its device); returns
    its losses."""
    dev = agent.device
    batch = [{k: v.to(dev) for k, v in x.items()} if isinstance(x, dict) else x.to(dev)
             for x in batch]
    if algo == "actor_critic_liquid":
        return agent.update(batch, 0.01)
    if algo == "soft_actor_critic_liquid":
        return agent.update(batch[:7], *batch[7:])
    return agent.update(batch)


def liquid_update_check(args, dev, cpu, card):
    """Phase 25: an update of each liquid agent at full width (64 neurons, 6
    unfoldings, obs 371, action 12; A2C and SAC at batch 256 with their
    stored hidden states, PPO-GAE on 8 padded trajectories of up to 1800
    steps, 8 epochs) on N(0, 1) inputs and states, on the card and on the
    CPU from the same seeded init (SAC with the same uniforms).

    Update 1, from the fresh init: the losses within UPDATE_TOL; the
    parameters' error printed beside 2 lr per epoch (Adam's first step is
    the sign of each gradient, and a gradient at f32 noise steps up to lr
    either way: ROADMAP Queue C trap 11). Update 2, from one state (the
    CPU's after update 1, loaded into the card's agent) on a second input:
    the losses and the parameters within UPDATE_TOL, and A2C's and SAC's
    whole carry (PPO-GAE's Adam moments printed: its clipped surrogate is
    not smooth, trap 13). Then the card's ms per update (CUDA events), and
    its device launches and device time per update (``torch.profiler``)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from evomotion_tpu_torch.tools._profile import device_events
    from evomotion_tpu_torch.train.checkpoint import _flatten

    t0 = phase("liquid update check")
    s, a = 371, 12
    neurons, steps, epoch = (8, 2, 2) if cpu else (LIQ_NEURONS, LIQ_STEPS, LIQ_EPOCH)
    sizes = ({"actor_critic_liquid": 8, "soft_actor_critic_liquid": 8,
              "ppo_gae_liquid": (3, 40)} if cpu else
             {"actor_critic_liquid": LIQ_BATCH, "soft_actor_critic_liquid": LIQ_BATCH,
              "ppo_gae_liquid": (LIQ_GAE_TRAJ, LIQ_GAE_MAX_LEN)})
    rng = np.random.default_rng(args.seed)
    out = {}
    for algo in LIQ_ALGOS:
        gae = algo == "ppo_gae_liquid"
        n_epochs = epoch if gae else 1
        b = sizes[algo][0] if gae else sizes[algo]
        agents = [_liquid_agent(algo, args.seed, s, a, neurons, steps, b, epoch, d)
                  for d in (dev, "cpu")]
        inputs = [_liquid_batch(algo, rng, s, a, sizes, agents[1]) for _ in range(2)]
        shape = tuple(inputs[0][0].shape)
        params = {str(i) for i, c in enumerate(agents[0].CARRY)
                  if not c.endswith(("_optimizer", "_state"))}
        lr = LIQ_LR[algo]
        res = {}
        for n_upd, batch in enumerate(inputs, 1):
            if n_upd == 2:
                agents[0].load_carry_tree(agents[1].carry_tree())
            losses = [_liquid_update(algo, ag, batch).cpu() for ag in agents]
            loss_err = float((losses[0] - losses[1]).abs().max())
            errs = _tree_errs(_flatten(agents[0].carry_tree()), _flatten(agents[1].carry_tree()))
            p_errs = {k: v for k, v in errs.items() if k.split("/")[0] in params}
            adam = {k: v for k, v in errs.items() if k not in p_errs}
            held = {} if n_upd == 1 else (p_errs if gae else errs)
            p_worst, a_worst = max(p_errs, key=p_errs.get), max(adam, key=adam.get)
            worst = max(held, key=held.get) if held else None
            held_err = held[worst] if held else 0.0
            two_lr = 2 * lr * n_epochs
            print(f"{algo} update {n_upd}, card vs CPU ({agents[0].count_parameters():,} "
                  f"parameters, input {shape}, {n_epochs} epoch(s)): losses max |diff| "
                  f"{loss_err:.3e}; parameters {p_errs[p_worst]:.3e} at {p_worst}"
                  + (f" (2 lr per epoch = {two_lr:g})" if n_upd == 1 else "")
                  + f"; Adam moments {adam[a_worst]:.3e} at {a_worst} "
                  f"({'held' if a_worst in held else 'printed'}); held tensors {len(held)}, "
                  f"max |diff| {held_err:.3e} (tol {UPDATE_TOL:g})", flush=True)
            if not (loss_err <= UPDATE_TOL and held_err <= UPDATE_TOL):
                fail(f"{algo} update {n_upd} on the card disagrees with the CPU: losses "
                     f"{loss_err}, {worst} {held_err}")
            res[f"update_{n_upd}"] = {"loss_err": loss_err, "held_err": held_err,
                                      "param_err": p_errs[p_worst], "adam_err": adam[a_worst],
                                      "two_lr": two_lr}
        ms = launches = busy = None
        if not cpu:
            reps = {"actor_critic_liquid": 10, "soft_actor_critic_liquid": 10,
                    "ppo_gae_liquid": 2}[algo]
            ms = cuda_ms(lambda: _liquid_update(algo, agents[0], inputs[1]), reps)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                _liquid_update(algo, agents[0], inputs[1])
                torch.cuda.synchronize()
            events = device_events(prof)
            launches, busy = len(events), sum(d for _, d in events) / 1e3
            print(f"{algo}: {ms:.3f} ms per update on the card (CUDA events, {reps} updates); "
                  f"{launches} device launches (kernels, copies, fills) and {busy:.3f} ms of "
                  f"device time per update (torch.profiler): the device busy "
                  f"{100 * busy / ms:.1f}% [{card}]", flush=True)
        out[algo] = {**res, "ms_per_update": ms, "launches_per_update": launches,
                     "device_ms_per_update": busy}
    done("liquid update check", t0)
    return out


def liquid_train(args, dev, cpu, card, cap, algo, keep=None):
    """Phases 26-27, the CLI's batched liquid ``train``: ``cli.main(["cli",
    "robot_walk", algo, "--num_envs", ..., "train", out, "-e", "1", "-n",
    "1"])`` with the JAX driver's liquid defaults (64 neurons, 6
    unfoldings, horizon 64; PPO-GAE at 2048 envs and 8 epochs, SAC at 256
    envs, batch 256, an update per env step and a 65,536-entry ring) and
    ``EVOMOTION_PROFILE=1`` (``profiled_train``: the slim sweep once per
    physics step, 60 + 64 = 124, its first call against its plain
    version). The losses must be finite, every actor tensor must have moved
    from its seeded init, and ``save_0`` must load back equal into a fresh
    agent on the card. SAC: each iteration's ``updates_done`` (64), the
    ring's fill and bytes, gradient steps/s. ``save_0`` is copied to
    ``keep`` (phase 28 runs it on the sequential agent)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from evomotion_tpu_torch.envs.robot import RobotWalkFactory
    from evomotion_tpu_torch.networks.liquid import LiquidActor
    from evomotion_tpu_torch.train import offpolicy_batched as ob

    label = f"{algo} train"
    t0 = phase(label)
    sac = algo == "soft_actor_critic_liquid"
    neurons, steps, horizon = (8, 2, 2) if cpu else (LIQ_NEURONS, LIQ_STEPS, 64)
    n_envs = 2 if cpu else (LIQ_SAC_ENVS if sac else LIQ_PPO_ENVS)
    kv = {"neuron_number": neurons, "unfolding_steps": steps, "horizon": horizon}
    if sac:
        kv.update(batch_size=4 if cpu else 256, learning_rate=3e-4, train_every=1,
                  replay_buffer_size=64 if cpu else 65536)
    else:
        kv.update(epoch=1 if cpu else LIQ_EPOCH, learning_rate=1e-3)
    iters = 2 if cpu else LIQ_ITERS  # the rehearsal's tiny ring fills in its second
    kept, own = [], ob.BatchedOffPolicyLiquid.train_step_fn

    def recording(self, *a, **k):
        step = own(self, *a, **k)

        def run(state, *x):
            state, m = step(state, *x)
            kept.append((state, m))
            return state, m
        return run

    with tempfile.TemporaryDirectory() as out, small_walker(cpu):
        env = RobotWalkFactory({}).make(args.seed, mt_parity=False, device=dev,
                                        per_env_step=False)
        argv = ["cli", "robot_walk", algo, "--num_envs", str(n_envs), "--env_seed",
                str(args.seed), "--agent_parameters", *(f"{k}={v}" for k, v in kv.items()),
                "train", out, "-e", str(iters), "-n", "1"]
        ob.BatchedOffPolicyLiquid.train_step_fn = recording
        try:
            prog, ms, rate, launches, kern_err = profiled_train(argv, label, env, iters,
                                                                horizon, dev, cpu, cap)
        finally:
            ob.BatchedOffPolicyLiquid.train_step_fn = own
        extra = {}
        if sac:
            updates = [int(m.updates_done) for _, m in kept]
            ring = kept[-1][0].ring
            ring_bytes = sum(t.numel() * t.element_size() for f in ring[:-2]
                             for t in (f.values() if isinstance(f, dict) else [f]))
            per_iter = horizon  # train_every 1, epoch 1
            # the rehearsal's 2 envs fill no batch of 4 trainable transitions at first
            if updates != [per_iter] * iters and not (cpu and len(updates) == iters):
                fail(f"{label}: updates_done {updates}, expected {per_iter} per iteration")
            grad_rate = per_iter / (ms["train_iter"] / 1e3)
            extra = {"updates_done": updates, "ring_bytes": ring_bytes, "grad_rate": grad_rate}
            print(f"{label}: updates_done per iteration {updates}; ring filled "
                  f"{ring.filled} of {ring.obs.shape[0]} ({ring_bytes / 2**20:.1f} MiB, hidden "
                  f"states of 5 nets in and out included); {grad_rate:.1f} gradient steps/s "
                  f"incl. the rollout ({per_iter / (ms['update'] / 1e3):.1f} within the update "
                  f"phase) [{card}]", flush=True)
            del kept[:], ring
        print(f"{label} [{card}]: per iteration ({horizon} steps x {n_envs} envs): rollout "
              f"{ms['rollout']:.0f} ms, update {ms['update']:.0f} ms, iteration "
              f"{ms['train_iter']:.0f} ms (StepTimer, 10 ms resolution); {rate:.0f} env-steps/s "
              f"incl. the update; last actor loss {prog[-1][0]}, critic loss {prog[-1][1]}",
              flush=True)
        save = os.path.join(out, "save_0")
        s, a = env.observation_size, env.action_size
        start = LiquidActor(s, a, neurons, steps, torch.Generator().manual_seed(args.seed))
        agent = _liquid_agent(algo, 123, s, a, neurons, steps, kv.get("batch_size", 2),
                              kv.get("epoch", 1), dev)
        _saved_equal(label, agent, save)
        moved = {n: float((p.detach().cpu() - q.detach()).abs().max())
                 for (n, p), q in zip(agent.actor.named_parameters(), start.parameters())}
        if not all(x > 0 and math.isfinite(x) for x in moved.values()):
            fail(f"{label}: actor params did not all move from their init: {moved}")
        count = int(np.load(os.path.join(save, "actor_optimizer.npz"))[
            "0/count" if sac else "1/0/count"])
        print(f"{label}: actor params moved from their init by max |diff| "
              f"{min(moved.values()):.3e} (least tensor) to {max(moved.values()):.3e}; save_0 "
              f"({len(agent.SAVE)} components) loads back equal on the card, Adam count "
              f"{count}", flush=True)
        if keep is not None:
            shutil.copytree(save, keep, dirs_exist_ok=True)
    done(label, t0)
    return {"launches": launches, "ms": ms, "rate": rate, "err": kern_err, **extra}


def liquid_sequential(args, dev, cpu, card, fat_cap, ppo_save, random_lengths):
    """Phase 28, the sequential tier with the liquid agents: ``cli cartpole
    <agent> ... train -e 2 -n 1`` then ``run`` of ``save_0`` for the three
    liquid agents (the fat-row sweep once per physics step); ``cli
    robot_walk ppo_gae_liquid ... run`` of phase 26's batched ``save_0``
    (twice per physics step); ``cli cartpole soft_actor_critic_liquid ...
    run`` of the port's copy of the JAX package's liquid-SAC cartpole
    checkpoint, 3 episodes, its lengths printed beside phase 11's random
    agent's (a reading). Each command through :func:`seq_command`."""
    import tempfile

    t0 = phase("liquid sequential")
    total, errs, ms = 0, [], {}
    small = ["neuron_number=8", "unfolding_steps=2"]

    def params(algo):  # the rehearsal's narrow cells
        kv = [f"seed={args.seed}", *LIQ_SEQ_PARAMS[algo]]
        return kv + small if cpu else kv

    with perenv_steps() as steps, tempfile.TemporaryDirectory() as tmp, small_walker(cpu):
        cases = []
        for algo in LIQ_ALGOS:
            base = ["cli", "cartpole", algo, "--env_seed", str(args.seed), "--agent_parameters",
                    *params(algo), "--env_parameters", "mas_steps=300"]
            out = os.path.join(tmp, algo)
            cases += [(f"cartpole {algo} train", base + ["train", out, "-e", "2", "-n", "1"], 1),
                      (f"cartpole {algo} run", base + ["run", os.path.join(out, "save_0"),
                                                       "--episodes", "1"], 1)]
        walk = ["cli", "robot_walk", "ppo_gae_liquid", "--env_seed", str(args.seed),
                "--agent_parameters", *params("ppo_gae_liquid")]
        if cpu:
            walk += ["--env_parameters", "initial_remaining_seconds=0.05"]
        cases.append(("robot_walk ppo_gae_liquid run of the batched save_0",
                      walk + ["run", ppo_save, "--episodes", "1"], 2))
        committed = ["cli", "cartpole", "soft_actor_critic_liquid", "--env_seed", str(args.seed),
                     "--agent_parameters", f"seed={args.seed}", *LIQ_CARTPOLE_PARAMS, "run",
                     LIQ_CARTPOLE_SAVE, "--episodes", str(len(random_lengths))]
        cases.append(("cartpole soft_actor_critic_liquid run of the committed checkpoint",
                      committed, 1))
        for label, argv, per_step in cases:
            r = seq_command(argv, label, per_step, dev, cpu, card, fat_cap, steps)
            total += r["launches"]
            errs.append(r["err"])
            ms[label] = r["s"] / r["physics_steps"] * 1e3
        lengths = r["episode_steps"]
    print(f"liquid sequential: the committed liquid SAC's cartpole episodes {lengths} steps "
          f"(mean {sum(lengths) / len(lengths):.1f}) against the random agent's "
          f"{random_lengths} (phase 11, same env seed); a reading [{card}]", flush=True)
    done("liquid sequential", t0)
    return {"launches": total, "err": max(errs), "ms_per_physics_step": ms,
            "committed_sac_lengths": lengths, "random_lengths": random_lengths}


# ---- the xla solver, the viewer and the builder (phases 29-31) -----------------

# the strict replay on the card: the artifact's 30-frame reset, then its
# first 8 env steps (tests/goldens/strict_walk.npz; cut for the script's
# time limit)
XLA_REPLAY_STEPS = 8
# replay steps from whose card state one card step is held against the CPU
# step (the CPU's xla spider step takes ~0.3-0.5 s)
XLA_CHECK_AT = (0, 4, 7)
XLA_PROFILE_STEPS = 2
# eval_walk --out in phase 30: the committed walker at 4 envs over a
# 120-step horizon (phase 14 runs 64 over the full 1,800), then the best
# episode's re-run on one world
VIEWER_EVAL_ENVS, VIEWER_EVAL_HORIZON = 4, 120
RECORDED = re.compile(r"^recorded (\d+) frames \(done=(\w+), win=(\w+)\) -> ")


def _cat_worlds(states):
    if isinstance(states[0], tuple):
        return type(states[0])(*(_cat_worlds(list(xs)) for xs in zip(*states)))
    import torch

    return torch.cat(states)


def _state_err(a, b):
    return max(float((getattr(a, f).cpu() - getattr(b, f).cpu()).abs().max())
               for f in ("pos", "quat", "lin_vel", "ang_vel"))


def xla_on_card(args, dev, cpu, card):
    """Phase 29, the colored-phase ``solver="xla"`` step (plain PyTorch, no
    hand-written kernel: its groups of rows are a dozen small ops each).
    The strict replay: ``tools.strict_trajectory``'s env (robot_walk, 30
    reset frames, the mt19937 stream, strict Bullet, xla) reset and stepped
    with the artifact's first 8 actions; its distance from
    ``tests/goldens/strict_walk.npz`` is printed as a reading (the settle is
    chaotic in f32: JAX's own two programs part by ~0.4, ROADMAP trap 14).
    Gates: the replay finite, with no sweep kernel launched (counts set to 0
    just before, read just after); from the card's replay states at
    XLA_CHECK_AT, one card physics step against the CPU's within STEP_TOL,
    strict and, from the last state, non-strict; a B=4 batch of xla worlds
    (the batched call) against 4 per-env calls on the card. ms, CUDA
    launches and device busy share per xla physics step from
    ``torch.profiler`` over XLA_PROFILE_STEPS steps."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from evomotion_tpu_torch.envs.base import pick
    from evomotion_tpu_torch.kernels import sweep as sp
    from evomotion_tpu_torch.kernels import sweep_envlast as se
    from evomotion_tpu_torch.kernels import sweep_fat as sf
    from evomotion_tpu_torch.physics.batched import BatchedStep
    from evomotion_tpu_torch.physics.perenv import PerEnvStep
    from evomotion_tpu_torch.tools import strict_trajectory as stool
    from evomotion_tpu_torch.tools._profile import device_events

    t0 = phase("xla on the card")
    n = 2 if cpu else XLA_REPLAY_STEPS
    env = stool.strict_env(dev)
    actions = torch.as_tensor(np.load(stool.ACTIONS)[:n], device=dev)
    kernels = (sp.KERNEL, sf.KERNEL, se.KERNEL)
    for k in kernels:
        k.launches = 0
    ts = time.perf_counter()
    state, _ = env.reset(1)
    states, pos, rew = [state], [], []
    for t in range(n):
        state, res = env.step(state, actions[t][None])
        states.append(state)
        pos.append(state.physics.pos[0])
        rew.append(res.reward[0])
    pos = torch.stack(pos).cpu().numpy()
    rew = torch.stack(rew).cpu().numpy()
    wall = time.perf_counter() - ts
    n_phys = env.settle_total + n
    launched = [k.launches for k in kernels]
    if any(launched):
        fail(f"strict replay on the xla step launched sweep kernels: {launched}")
    err_pos, err_rew, first = stool.compare(pos, rew)
    print(f"strict replay: reset ({env.settle_total} physics steps) + {n} artifact steps, "
          f"{wall:.2f} s, {wall / n_phys * 1e3:.1f} ms per xla physics step incl. env logic "
          f"(host clock), sweep kernel launches {launched} [{card}]", flush=True)
    print(f"strict replay vs the artifact (a reading, the settle is chaotic in f32): max "
          f"|pos| {err_pos:.3e}, max |reward| {err_rew:.3e}, first step over {stool.TOL:g}: "
          f"{first}", flush=True)
    if not (np.isfinite(pos).all() and np.isfinite(rew).all()):
        fail("strict replay: non-finite state or reward")

    # card step against the CPU step from shared states
    host = PerEnvStep(env.model, env.physics_step.dt, device="cpu")
    model_ns = dataclasses.replace(env.model, strict_bullet=False)
    host_ns = PerEnvStep(model_ns, env.physics_step.dt, device="cpu")
    card_ns = PerEnvStep(model_ns, env.physics_step.dt, device=dev)
    on = torch.ones((1, env.model.n_slider), dtype=torch.bool, device=dev)
    errs = {}
    checks = [(f"strict, replay step {i}", env.physics_step, host, i)
              for i in XLA_CHECK_AT if i < n] + [("non-strict", card_ns, host_ns, n - 1)]
    for label, card_step, host_step, i in checks:
        phys = states[i].physics
        tgt = actions[i][None] * env._speed
        got, _ = card_step(phys, tgt, on)
        ref, _ = host_step(type(phys)(*(x.cpu() for x in phys)), tgt.cpu(), on.cpu())
        errs[label] = _state_err(got, ref)
        print(f"xla spider step, {label}: max |card - cpu| {errs[label]:.3e} "
              f"(tol {STEP_TOL:g})", flush=True)
        if not errs[label] <= STEP_TOL:
            fail(f"xla card step disagrees with the CPU step ({label}): {errs[label]}")

    # a batch of 4 xla worlds (the batched call) against 4 per-env calls
    picks = [states[n - k].physics for k in range(4)]
    batch = _cat_worlds(picks)
    tgt4 = torch.cat([actions[n - 1 - k][None] for k in range(4)]) * env._speed
    on4 = torch.ones((4, env.model.n_slider), dtype=torch.bool, device=dev)
    both, _ = BatchedStep(env.model, env.physics_step.dt, device=dev)(batch, tgt4, on4)
    batch_err = 0.0
    for k in range(4):
        one, _ = env.physics_step(picks[k], tgt4[k:k + 1], on4[k:k + 1])
        batch_err = max(batch_err, _state_err(one, pick(both, k)))
    print(f"xla B=4 batched call vs 4 per-env calls on the card: max |diff| {batch_err:.3e} "
          f"(tol {STEP_TOL:g})", flush=True)
    if not batch_err <= STEP_TOL:
        fail(f"xla batched call disagrees with the per-env calls: {batch_err}")

    # ms, launches and device busy per xla physics step
    phys, tgt = states[-1].physics, actions[n - 1][None] * env._speed
    reading = {}
    if not cpu:
        torch.cuda.synchronize()
        ts = time.perf_counter()
        for _ in range(XLA_PROFILE_STEPS):
            phys, _ = env.physics_step(phys, tgt, on)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - ts) / XLA_PROFILE_STEPS * 1e3
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            ts = time.perf_counter()
            for _ in range(XLA_PROFILE_STEPS):
                phys, _ = env.physics_step(phys, tgt, on)
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - ts
        events = device_events(prof)
        busy = sum(us for _, us in events) / 1e3
        launches = len(events) / XLA_PROFILE_STEPS
        push, full = env.physics_step.solve_push, env.physics_step.solve_full
        reading = {"step_ms": step_ms, "launches_per_step": launches,
                   "device_busy": busy / (prof_wall * 1e3),
                   "device_ms_per_step": busy / XLA_PROFILE_STEPS,
                   "groups_per_step": push.n_groups + full.n_groups}
        print(f"xla spider physics step (strict, B=1) [{card}]: {step_ms:.1f} ms (host clock, "
              f"synchronised), {launches:.0f} CUDA launches, device busy "
              f"{100 * reading['device_busy']:.1f}% ({reading['device_ms_per_step']:.2f} ms "
              f"per step, profiler on), {reading['groups_per_step']} Gauss-Seidel groups",
              flush=True)
    done("xla on the card", t0)
    return {"replay_max_pos_err": err_pos, "replay_max_reward_err": err_rew,
            "replay_first_over_tol": first, "replay_ms_per_physics_step": wall / n_phys * 1e3,
            "card_vs_cpu": errs, "batch_err": batch_err, **reading}


def _serve_with_client(argv, dev, client):
    """``cli.main(argv)`` (a server) with ``client`` in a thread; returns
    what the client stored."""
    import threading

    from evomotion_tpu_torch import cli

    got = {}

    def run():
        try:
            client(got)
        except Exception as e:  # noqa: BLE001 - reported below
            got["error"] = repr(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv, device=dev)
    t.join(timeout=120)
    if rc != 0 or t.is_alive() or "error" in got:
        fail(f"{argv[:2]}: server returned {rc}, client {got.get('error', 'hung')}")
    return got


def _free_port():
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _get(url, data=None):
    """GET (or POST ``data``) ``url`` on 127.0.0.1, retrying while the
    server comes up."""
    import urllib.request

    t0 = time.time()
    while True:
        try:
            req = urllib.request.Request(url, data=data, method="POST" if data else "GET")
            return urllib.request.urlopen(req, timeout=120).read()
        except OSError:
            if time.time() - t0 > 60:
                raise
            time.sleep(0.2)


def viewer_paths(args, dev, cpu, card, fat_cap, cap):
    """Phase 30, the viewer: ``cli cartpole random run --record x.npz --html
    x.html`` (1 episode) and one ``robot_walk`` episode with ``--record``
    (through :func:`seq_command`: the fat-row sweep once per cartpole and
    twice per spider physics step, the first call against its plain
    version); ``run --live`` on the spider served for 3 frames to a client
    thread on 127.0.0.1 (the sweep counted the same way); ``tools.eval_walk
    --out`` on the committed walker (VIEWER_EVAL_ENVS envs over a
    VIEWER_EVAL_HORIZON-step horizon: the slim sweep once per physics step
    of its batched eval), whose re-run of the best episode on one world
    launches the fat-row sweep twice per physics step (counts set to 0 just
    before the eval and the re-run, read just after each)."""
    import numpy as np
    import torch

    from evomotion_tpu_torch.kernels import sweep as sp
    from evomotion_tpu_torch.kernels import sweep_fat as sf
    from evomotion_tpu_torch.tools import eval_walk as ew
    from evomotion_tpu_torch.viewer import live

    t0 = phase("viewer")
    out, total, errs = {}, 0, []
    walk_env = (["--env_parameters", "reset_frames=1", "initial_remaining_seconds=0.05"]
                if cpu else [])
    with perenv_steps() as steps, tempfile.TemporaryDirectory() as tmp:
        npz, html = os.path.join(tmp, "x.npz"), os.path.join(tmp, "x.html")
        r = seq_command(["cli", "cartpole", "random", "--env_seed", str(args.seed), "run", tmp,
                         "--episodes", "1", "--record", npz, "--html", html],
                        "cartpole run --record --html", 1, dev, cpu, card, fat_cap, steps)
        with np.load(npz) as rec:
            shapes = (rec["pos"].shape, rec["quat"].shape)
        page = open(html).read()
        if shapes[0] != (r["episode_steps"][0], 3, 3) or "FRAMES_POS" not in page:
            fail(f"cartpole recording: {shapes}, {r['episode_steps']}, html {len(page)} B")
        total += r["launches"]
        errs.append(r["err"])
        walk_npz = os.path.join(tmp, "walk.npz")
        r = seq_command(["cli", "robot_walk", "random", "--env_seed", str(args.seed), *walk_env,
                         "run", tmp, "--episodes", "1", "--record", walk_npz],
                        "robot_walk run --record", 2, dev, cpu, card, fat_cap, steps)
        with np.load(walk_npz) as rec:
            if rec["pos"].shape != (r["episode_steps"][0], 42, 3) or not np.isfinite(
                    rec["pos"]).all():
                fail(f"robot_walk recording: {rec['pos'].shape}")
        total += r["launches"]
        errs.append(r["err"])
        out["record_ms_per_env_step"] = r["s"] / r["episode_steps"][0] * 1e3
        print(f"robot_walk run --record: {out['record_ms_per_env_step']:.2f} ms per env step "
              f"({r['episode_steps'][0]} env steps, {r['physics_steps']} physics steps incl. "
              f"the reset, host clock) [{card}]", flush=True)

        # --live: 3 frames to a client thread
        port = _free_port()
        serve = live.serve_live
        live.serve_live = lambda *a, **kw: serve(*a, **kw, max_frames=3)

        def client(got):
            got["page"] = _get(f"http://127.0.0.1:{port}/").decode()
            got["frames"] = [json.loads(_get(f"http://127.0.0.1:{port}/state"))
                             for _ in range(3)]

        sf.KERNEL.launches = steps[0] = 0
        ts = time.perf_counter()
        try:
            got = _serve_with_client(["cli", "robot_walk", "random", "--env_seed",
                                      str(args.seed), *walk_env, "run", tmp, "--live",
                                      "--port", str(port)], dev, client)
        finally:
            live.serve_live = serve
        if not cpu:
            torch.cuda.synchronize()
        n_phys, launches = steps[0], sf.KERNEL.launches
        frames = got["frames"]
        print(f"run --live: 3 frames served on 127.0.0.1 ({time.perf_counter() - ts:.2f} s incl. "
              f"the reset), steps {[f['step'] for f in frames]}, {n_phys} physics steps, "
              f"fat sweep launches {launches}", flush=True)
        if (len(frames) != 3 or "drawGround" not in got["page"]
                or np.asarray(frames[-1]["pos"]).shape != (42, 3)
                or not np.isfinite(np.asarray(frames[-1]["pos"])).all()):
            fail("run --live: bad frames")
        if not cpu and launches != 2 * n_phys:
            fail(f"run --live: {launches} fat sweep launches in {n_phys} physics steps")
        total += launches
        out["live_launches"] = launches

        # eval_walk --out: the re-run of the best episode on the per-env step
        best = os.path.join(tmp, "best")
        saved, rec_ep = ew.WIN, ew.record_episode
        horizon = 3 if cpu else VIEWER_EVAL_HORIZON
        ew.WIN = horizon
        counts = {}

        def counted(*a, **kw):
            if not cpu:
                torch.cuda.synchronize()
            counts.update(slim_launches=sp.KERNEL.launches, slim_calls=cap.calls)
            sf.KERNEL.launches = steps[0] = 0
            fat_cap.calls = 0
            res = rec_ep(*a, **kw)
            if not cpu:
                torch.cuda.synchronize()
            counts.update(launches=sf.KERNEL.launches, calls=fat_cap.calls, steps=steps[0])
            return res

        ew.record_episode = counted
        buf = io.StringIO()
        sp.KERNEL.launches = cap.calls = 0
        ts = time.perf_counter()
        try:
            with small_walker(cpu), contextlib.redirect_stdout(buf):
                rc = ew.main(["ppo", ew.WALKER_DIR, "--episodes",
                              str(2 if cpu else VIEWER_EVAL_ENVS), "--seed", str(WALKER_SEED),
                              "--out", best], device=dev)
        finally:
            ew.WIN, ew.record_episode = saved, rec_ep
        wall = time.perf_counter() - ts
        lines = buf.getvalue().splitlines()
        m = RECORDED.match(lines[-1]) if lines else None
        print(f"eval_walk --out: {lines[-1] if lines else '(no output)'} ({wall:.2f} s)",
              flush=True)
        if rc != 0 or not m:
            fail(f"eval_walk --out returned {rc}")
        with np.load(best + ".npz") as rec:
            if rec["pos"].shape != (int(m.group(1)), 42, 3):
                fail(f"eval_walk --out recording {rec['pos'].shape}")
        if "FRAMES_POS" not in open(best + ".html").read():
            fail("eval_walk --out: no viewer page")
        want = (2 if cpu else 60) + horizon  # physics steps of the batched eval: settle + steps
        print(f"eval_walk --out: batched eval {want} physics steps, slim sweep calls "
              f"{counts['slim_calls']}, kernel launches {counts['slim_launches']}; re-run "
              f"{counts['steps']} physics steps, fat sweep calls {counts['calls']}, kernel "
              f"launches {counts['launches']}", flush=True)
        if counts["slim_calls"] != want or (not cpu and counts["slim_launches"] != want):
            fail(f"eval_walk --out: expected {want} slim sweep launches, got {counts}")
        if counts["calls"] != 2 * counts["steps"] or (not cpu and counts["launches"] !=
                                                      counts["calls"]):
            fail(f"eval_walk --out re-run: expected 2 fat sweep launches per physics step, "
                 f"got {counts}")
        total += counts["launches"]
        out["eval_out_launches"] = counts["launches"]
        out["eval_out_slim_launches"] = counts["slim_launches"]
        out["eval_out_frames"] = int(m.group(1))
    done("viewer", t0)
    return {"launches": total, "err": max(errs), **out}


def gui_path(args, dev, cpu, card):
    """Phase 31, ``cli gui --max-requests N``: a client thread GETs the page
    and the robot, POSTs builder ops (load the spider, move a member, a ray
    cast, add a member, save) and starts the infer tab on the spider with a
    port CrossQ checkpoint at the tab's default config (actor 256, critics
    1,024, batch 128; the env's per-env step, the fat-row sweep twice per
    physics step), polls 3 frames and stops it. The fat-row sweep's counts
    are set to 0 just before and read just after."""
    import shutil

    import numpy as np
    import torch

    from evomotion_tpu_torch.agents.cross_q import CrossQAgent
    from evomotion_tpu_torch.envs.robot import DEFAULT_SKELETON
    from evomotion_tpu_torch.kernels import sweep_fat as sf

    t0 = phase("gui")
    with perenv_steps() as steps, tempfile.TemporaryDirectory() as tmp:
        shutil.copy(DEFAULT_SKELETON, os.path.join(tmp, "spider.json"))
        agent = CrossQAgent(12345, 371, 12, 256, 1024, 128, 1, 3e-4, 0.99, 1, 2, device=dev)
        os.makedirs(os.path.join(tmp, "ckpt"))
        agent.save(os.path.join(tmp, "ckpt"))
        del agent
        port = _free_port()
        base = f"http://127.0.0.1:{port}"
        env_params = {"reset_frames": "1", "initial_remaining_seconds": "0.05"} if cpu else {}
        ops = [
            {"op": "load_robot", "args": {"path": "spider.json"}},
            {"op": "update_member", "args": {"name": "body_legA", "pos": [1.2, 0.5, 0.3]}},
            {"op": "ray_cast_member", "args": {"from": [0, 0.3, -5], "to": [0, 0.3, 5]}},
            {"op": "save_robot", "args": {"path": "edited.json"}},
            {"op": "infer_start", "args": {"agent_dir": "ckpt", "robot_path": "spider.json",
                                           "env_params": env_params}},
            {"op": "infer_state"}, {"op": "infer_state"}, {"op": "infer_state"},
            {"op": "infer_stop"},
        ]

        def client(got):
            got["page"] = _get(base + "/").decode()
            got["robot"] = json.loads(_get(base + "/robot"))
            got["replies"] = [json.loads(_get(base + "/api", json.dumps(op).encode()))
                              for op in ops]

        sf.KERNEL.launches = steps[0] = 0
        ts = time.perf_counter()
        got = _serve_with_client(["gui", "--port", str(port), "--max-requests",
                                  str(2 + len(ops)), "--workspace", tmp], dev, client)
        if not cpu:
            torch.cuda.synchronize()
        wall = time.perf_counter() - ts
        n_phys, launches = steps[0], sf.KERNEL.launches
    replies = got["replies"]
    frames = [r for r in replies if "pos" in r]
    print(f"gui: page {len(got['page'])} B, robot {len(got['robot']['members'])} members; "
          f"replies {[r.get('ok') for r in replies]}; infer tab {len(frames)} frames, "
          f"{n_phys} physics steps, fat sweep launches {launches}; {wall:.2f} s [{card}]",
          flush=True)
    if (not all(r.get("ok") for r in replies) or len(frames) != 3
            or "robot builder" not in got["page"]
            or not all(np.isfinite(np.asarray(f["pos"])).all() for f in frames)):
        fail(f"gui: {replies}")
    if n_phys < 1 or (not cpu and launches != 2 * n_phys):
        fail(f"gui infer tab: {launches} fat sweep launches in {n_phys} physics steps")
    done("gui", t0)
    return {"launches": launches, "physics_steps": n_phys, "s": wall}


# ---- data parallelism over the env batch (phase 32) ----------------------------

# phase 32's workloads: ppo train's (phase 15: robot_walk, B=2048, hidden 256,
# horizon 64, 8 epochs, lr 1e-3) at 2 iterations, one process and one NCCL
# rank, then two gloo ranks of 1,024 envs on the one card; CrossQ at the
# walker config (phases 17-18) on two gloo ranks of 128 envs, 1 iteration
DP_PPO = ["--env", "robot_walk", "--algo", "ppo_gae", "--num_envs", "2048", "--iterations",
          "2", "--agent_parameters", "hidden_size=256", "horizon=64", "epoch=8",
          "learning_rate=1e-3"]
DP_CROSSQ = ["--env", "robot_walk", "--algo", "cross_q", "--num_envs", str(OFF_ENVS),
             "--iterations", "1", "--agent_parameters", f"hidden_size={OFF_ACTOR}",
             f"critic_hidden_size={OFF_CRITIC}", f"batch_size={OFF_BATCH}",
             f"epoch={OFF_EPOCH}", "learning_rate=3e-4", "train_every=1", "horizon=64",
             f"replay_buffer_size={OFF_RING}", "nan_guard=true"]
# the CPU rehearsal's: cartpole, 8 envs, small networks
DP_CPU = ["--env", "cartpole", "--num_envs", "8", "--device", "cpu", "--agent_parameters",
          "hidden_size=16", "horizon=4", "epoch=2", "batch_size=8", "replay_buffer_size=64"]
# |sharded - one-process| bound on the two-rank PPO update of one trajectory
# from a shared state (its second iteration): the same f32 sums, split over
# two ranks (trap 11 spares the second update, whose Adam moments are not
# noise)
DP_UPDATE_TOL = 1e-5


def dp_worker(argv, label, nproc=None, timeout=600):
    """Runs ``tools.multihost_worker`` with ``argv`` in a new process
    group: alone (``--no-mesh``) when ``nproc`` is None, else under
    ``torch.distributed.run --standalone --nproc_per_node nproc``. Returns
    its ranks' JSON lines, sorted by rank, and the wall seconds; fails
    unless it exits 0 with one line per rank. A run past ``timeout`` is
    killed with every process it started."""
    import signal

    root = os.path.dirname(os.path.abspath(__file__))
    mod = ["-m", "evomotion_tpu_torch.tools.multihost_worker"]
    if nproc is None:
        cmd = [sys.executable, *mod, "--no-mesh", *argv]
    else:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", str(nproc), *mod, *argv]
    print(f"{label}: " + " ".join(cmd[1:]), flush=True)
    # torchrun gives each rank one OpenMP thread; the one-process run gets
    # the same, so that the runs differ only by the process group
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    ts = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, stdin=subprocess.DEVNULL, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        fail(f"{label}: no end within {timeout} s")
    wall = time.perf_counter() - ts
    lines = sorted((json.loads(x) for x in out.splitlines() if x.startswith('{"rank"')),
                   key=lambda x: x["rank"])
    if proc.returncode != 0 or len(lines) != (nproc or 1):
        print(out[-4000:], err[-6000:], flush=True)
        fail(f"{label}: exit {proc.returncode}, {len(lines)} rank lines")
    for x in lines:
        short = {k: v for k, v in x.items() if k != "checksums"}
        print(f"{label}: {json.dumps(short)}", flush=True)
    return lines, wall


def data_parallel(args, dev, cpu, card, cap):
    """Phase 32, data parallelism over the env batch (``parallel.mesh``),
    each run a ``tools.multihost_worker`` process group started here
    (kernels built in phase 2): (i) ppo train's workload (DP_PPO) in one
    process without a mesh and on one NCCL rank, both under
    ``torch.use_deterministic_algorithms``: the parameters and Adam states
    after iteration 1 (and 2) bit-equal (sha256); (ii) the same on two gloo
    ranks of 1,024 envs on the one card, the ranks' checksums equal after
    every iteration and the second iteration's sharded update within
    DP_UPDATE_TOL of the one-process update of the gathered trajectory from
    the same state (``--check-update``); CrossQ at the walker config on two
    gloo ranks of 128 envs, 1 iteration, the checksums equal, with the ms
    that one update's broadcasts of gradients and buffers take alone. Each
    rank's slim sweep counts come back in its line: one launch per physics
    step (the full-batch reset's 60, then 64 per iteration). Before the
    runs, the slim sweep's kernel on the first call of a reset at each
    rank's batch (1,024 and 128 envs) against its plain version (one plain
    call on both calls' first envs side by side). On the CPU (``--cpu``),
    cartpole at 8 envs over gloo."""
    import torch

    from evomotion_tpu_torch.envs.robot import RobotWalkFactory
    from evomotion_tpu_torch.kernels import sweep as sp

    t0 = phase("data parallel")
    with small_walker(cpu):
        env = RobotWalkFactory({}).make(args.seed, mt_parity=False, device=dev,
                                        per_env_step=False)
        inputs = []
        for n in ((2, 1) if cpu else (1024, OFF_ENVS // 2)):
            cap.arm(limit=1)
            env.reset(n, torch.Generator(device=dev).manual_seed(args.seed))
            cap.armed = False
            inputs.append(cap.inputs)
    del env
    # each call through the kernel at its batch, then one plain call on both
    # calls' first envs side by side (env axis last; one model, one meta)
    outs = [sp.sweep_plain(*inp) if cpu else sp.solver_sweep_envlast_slim(*inp)
            for inp in inputs]
    keep = [min(N_CMP, inp[0].shape[-1]) for inp in inputs]
    if inputs[1][5] is not inputs[0][5] or inputs[1][6] != inputs[0][6]:
        fail("data parallel: the rank batches' sweep calls do not share one model")

    def side_by_side(xs):
        return [torch.cat([x[i][..., :k] for x, k in zip(xs, keep)], -1)
                if torch.is_tensor(xs[0][i]) else xs[0][i] for i in range(len(xs[0]))]

    err = slim_check(side_by_side(inputs), side_by_side(outs), sum(keep),
                     f"data parallel rank batches B={[x[0].shape[-1] for x in inputs]} "
                     f"(first {keep} envs)")
    if not cpu:
        torch.cuda.empty_cache()
    seed = ["--seed", str(args.seed)]
    ppo = (DP_CPU + ["--algo", "ppo_gae", "--iterations", "2"]) if cpu else DP_PPO
    crossq = (DP_CPU + ["--algo", "cross_q", "--iterations", "1"]) if cpu else DP_CROSSQ
    det = ["--deterministic"]
    plain, plain_s = dp_worker(ppo + seed + det, "dp ppo, one process")
    one, one_s = dp_worker(ppo + seed + det + (["--backend", "gloo"] if cpu else []),
                           f"dp ppo, 1 {'gloo' if cpu else 'nccl'} rank", nproc=1)
    two, two_s = dp_worker(ppo + seed + ["--check-update", "--backend", "gloo"],
                           "dp ppo, 2 gloo ranks", nproc=2)
    cq, cq_s = dp_worker(crossq + seed + ["--backend", "gloo"], "dp cross_q, 2 gloo ranks",
                         nproc=2)

    (p,), (o,) = plain, one
    if o["checksums"] != p["checksums"]:
        fail(f"dp ppo: one {o['backend']} rank is not bit-equal to one process: "
             f"{o['checksums']} vs {p['checksums']}")
    for label, ranks in (("dp ppo, 2 ranks", two), ("dp cross_q, 2 ranks", cq)):
        if len({tuple(x["checksums"]) for x in ranks}) != 1:
            fail(f"{label}: the replicas parted: {[x['checksums'] for x in ranks]}")
    for x in (*plain, *one, *two, *cq):
        if not all(math.isfinite(v) for it in x["losses"] for v in it):
            fail(f"dp {x['algo']} rank {x['rank']}: losses {x['losses']}")
    check = two[0]["update_check"]
    if not max(check.values()) <= DP_UPDATE_TOL:
        fail(f"dp ppo, 2 ranks: sharded update against one process {check}")
    settle = 2 if cpu else 60  # the walker's reset (cartpole's per-env step on the CPU)
    launches = {}
    for label, runs in (("ppo no mesh", plain), ("ppo 1 rank", one), ("ppo 2 ranks", two),
                        ("cross_q 2 ranks", cq)):
        n = [x["launches"]["sweep_envlast_slim"] for x in runs]
        want = settle + len(runs[0]["losses"]) * runs[0]["horizon"]
        if not cpu and n != [want] * len(runs):
            fail(f"dp {label}: slim sweep launches {n} per rank, want {want} each")
        launches[label] = sum(n)
    rate = {"no mesh": p["env_steps_s"], "1 rank": o["env_steps_s"],
            "2 ranks": two[0]["env_steps_s"]}
    print(f"data parallel [{card}]: ppo B={p['num_envs']} env-steps/s per iteration (incl. "
          f"update): "
          f"one process {p['env_steps_s']}, 1 {o['backend']} rank {o['env_steps_s']}, "
          f"2 gloo ranks on one card {two[0]['env_steps_s']} (their total; a reading); "
          f"bit-equal 1 rank vs one process; 2-rank update vs one process {check}; "
          f"cross_q 2 x {cq[0]['local_envs']}: {cq[0]['env_steps_s']} env-steps/s, phases "
          f"{cq[0]['phase_ms']} ms, gloo broadcasts of one update "
          f"{cq[0].get('replicate_ms_per_update')} ms; launches {launches}", flush=True)
    done("data parallel", t0)
    return {"launches": launches, "err": err, "env_steps_s": rate,
            "update_check": check, "phase_ms": {
                "ppo no mesh": p["phase_ms"], "ppo 1 rank": o["phase_ms"],
                "ppo 2 ranks": two[0]["phase_ms"], "cross_q 2 ranks": cq[0]["phase_ms"]},
            "replicate_ms_per_update": cq[0].get("replicate_ms_per_update"),
            "wall_s": {"ppo no mesh": plain_s, "ppo 1 rank": one_s, "ppo 2 ranks": two_s,
                       "cross_q 2 ranks": cq_s}}


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
    with tempfile.TemporaryDirectory() as ppo_save:
        train = ppo_train(args, dev, cpu, card, cap, ppo_save)
        off_update = offpolicy_update_check(args, dev, cpu, card)
        off_train = {algo: offpolicy_train(args, dev, cpu, card, cap, algo)
                     for algo in ("cross_q", "soft_actor_critic")}
        off_seq = offpolicy_sequential(args, dev, cpu, card, fat_cap)
        c2 = c2_reading(args, dev, cpu, card)
        on_update = onpolicy_update_check(args, dev, cpu, card)
        jump = robot_jump(args, dev, cpu, card, cap, fat_cap)
        on_train = {algo: onpolicy_train(args, dev, cpu, card, cap, algo)
                    for algo in ("actor_critic", "ppo_vanilla")}
        on_seq = onpolicy_sequential(args, dev, cpu, card, fat_cap, ppo_save, train["hidden"])
    liq_update = liquid_update_check(args, dev, cpu, card)
    with tempfile.TemporaryDirectory() as liq_save:
        liq_train = {"ppo_gae_liquid": liquid_train(args, dev, cpu, card, cap, "ppo_gae_liquid",
                                                    keep=liq_save),
                     "soft_actor_critic_liquid": liquid_train(args, dev, cpu, card, cap,
                                                              "soft_actor_critic_liquid")}
        liq_seq = liquid_sequential(args, dev, cpu, card, fat_cap, liq_save,
                                    seq["lengths"]["cartpole"])
    xla = xla_on_card(args, dev, cpu, card)
    view = viewer_paths(args, dev, cpu, card, fat_cap, cap)
    gui = gui_path(args, dev, cpu, card)
    dp = data_parallel(args, dev, cpu, card, cap)

    # ---- 33. readings lines, kernels line and last line ----
    print(json.dumps({"offpolicy": {
        "update_check": off_update,
        "train": {k: {x: v[x] for x in ("ms", "rate", "grad_rate")} for k, v in off_train.items()},
        "sequential_launches": off_seq["launches"], "c2": c2}}), flush=True)
    print(json.dumps({"onpolicy": {
        "update_check": on_update,
        "train": {k: {x: v[x] for x in ("ms", "rate")} for k, v in on_train.items()},
        "robot_jump": jump, "sequential": on_seq}}), flush=True)
    print(json.dumps({"liquid": {
        "update_check": liq_update,
        "train": {k: {x: v[x] for x in ("ms", "rate", "launches", "updates_done", "ring_bytes",
                                       "grad_rate") if x in v} for k, v in liq_train.items()},
        "sequential": liq_seq}}), flush=True)
    print(json.dumps({"xla": xla, "viewer": view, "gui": gui}), flush=True)
    print(json.dumps({"data_parallel": dp}), flush=True)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    kern = {
        "name": "sweep_envlast_slim",
        "route": "cuda",
        "source": "evomotion_tpu_torch/kernels/csrc/sweep_envlast_slim.cu",
        "replaces": REPLACES,
        "tpu_kernel": TPU_KERNEL,
        "launches": (main_run["launches"] + sched_run["launches"] + walker["launches"]
                     + train["launches"] + sum(t["launches"] for t in off_train.values())
                     + jump["batched"]["launches"]
                     + sum(t["launches"] for t in on_train.values())
                     + sum(t["launches"] for t in liq_train.values())
                     + view["eval_out_slim_launches"] + sum(dp["launches"].values())),
        "launches_by_path": {"batched canonical": main_run["launches"],
                             "batched scheduled": sched_run["launches"],
                             "walker eval": walker["launches"],
                             "ppo train": train["launches"],
                             **{f"{k} train": t["launches"] for k, t in off_train.items()},
                             "robot_jump batched": jump["batched"]["launches"],
                             **{f"{k} train": t["launches"] for k, t in on_train.items()},
                             **{f"{k} train": t["launches"] for k, t in liq_train.items()},
                             "eval_walk --out eval": view["eval_out_slim_launches"],
                             **{f"data parallel {k}": n for k, n in dp["launches"].items()}},
        "max_abs_err": max(*errs.values(), sched_err, walker["err"], train["err"],
                           *(t["err"] for t in off_train.values()), jump["kernel_err"],
                           *(t["err"] for t in on_train.values()),
                           *(t["err"] for t in liq_train.values()), dp["err"]),
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
        "launches": (seq["launches"] + off_seq["launches"] + jump["run"]["launches"]
                     + on_seq["launches"] + liq_seq["launches"] + view["launches"]
                     + gui["launches"]),
        "launches_by_path": {"sequential run": seq["launches"],
                             "offpolicy sequential train and run": off_seq["launches"],
                             "robot_jump run": jump["run"]["launches"],
                             "onpolicy sequential train and run": on_seq["launches"],
                             "liquid sequential train and run": liq_seq["launches"],
                             "viewer: run --record/--live, eval_walk --out re-run":
                                 view["launches"],
                             "gui infer tab": gui["launches"]},
        "max_abs_err": max(*fat["errs"].values(), *seq["errs"].values(), sched_fat_err,
                           off_seq["err"], jump["run"]["err"], on_seq["err"], liq_seq["err"],
                           view["err"]),
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

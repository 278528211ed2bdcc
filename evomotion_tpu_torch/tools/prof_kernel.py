"""Per-row-visit cost of the env-last fat-row sweep (TPU kernel #3's port).

    python -m evomotion_tpu_torch.tools.prof_kernel [--envs 2048]
    python -m evomotion_tpu_torch.tools.prof_kernel --device cpu --envs 3 --sizes 8,16 --size 16

The port of the repo's ``tools/prof_kernel.py``: the same five synthetic row
sets run through ``kernels.sweep_envlast.solver_sweep_envlast`` (joint rows
in blocks of 6 on one body pair at each of ``--sizes`` rows; all rows on one
body pair; round-robin body pairs; alternating contact normal and friction
rows, which turns the split-impulse pass on; the others at ``--size``
rows), 42 bodies, 10 solver iterations. Rows are N(0, 1) * 0.01 made with
numpy from seed 0; velocities and impulses start at zero. On the card each
case is timed with CUDA events over 5 calls after one warm-up call; on the
CPU (the plain version) with the host clock. The time
per row visit divides by ``rows * iterations`` only: all envs of a call run
in parallel on the card (the TPU tool also divided by the env tiles, which
its core runs one after another). Ends with one JSON line that also counts
the sweep calls made (``sweep_calls``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..device import resolve
from ..kernels import sweep as sp
from ..kernels import sweep_envlast as se

CASES = ("blocks6", "same", "roundrobin", "contact")
BODIES = 42
ITERS = 10
REPS = 5
LABELS = {
    "blocks6": "joint blocks-of-6",
    "same": "joint all-same-body",
    "roundrobin": "joint round-robin bodies",
    "contact": "normal+friction (split pass on)",
}


def case_meta(case: str, nr: int, nb: int):
    """Row metadata of one synthetic case, as the TPU tool builds it."""
    if case == "same":
        ia, ib = np.zeros(nr, np.int64), np.ones(nr, np.int64)
    elif case == "roundrobin":
        ia = (np.arange(nr) % (nb // 2)) * 2
        ib = ia + 1
    else:  # joint-like blocks of 6 consecutive rows on one body pair
        ia = ((np.arange(nr) // 6) % (nb // 2)) * 2
        ib = ia + 1
    if case == "contact":
        kind = np.where(np.arange(nr) % 3 == 0, sp.KIND_NORMAL, sp.KIND_FRICTION)
    else:
        kind = np.full(nr, sp.KIND_JOINT)
    parent = np.where(kind == sp.KIND_FRICTION, np.maximum(np.arange(nr) - 1, 0), -1)
    mu = np.where(kind == sp.KIND_FRICTION, 0.5, 0.0).astype(np.float32)
    return ia * 6, ib * 6, parent, mu, kind, np.zeros(nr, bool)


def time_case(case, nr, envs, dev):
    """(ms per call, calls made) of one case."""
    rng = np.random.default_rng(0)
    nr_pad = -(-nr // 32) * 32  # the TPU tool's padding: chunk 8 x 4 buffers
    meta = se.make_envlast_meta(*case_meta(case, nr, BODIES), nr, dev)
    rows = torch.as_tensor(
        rng.standard_normal((nr_pad, se.ROW_FP, envs)).astype(np.float32) * 0.01, device=dev)
    vel = torch.zeros((BODIES * 6, envs), device=dev)
    lam = torch.zeros((nr_pad, envs), device=dev)

    def call():
        return se.solver_sweep_envlast(rows, vel, lam, meta, ITERS)

    call()
    if dev.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            call()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / REPS
    else:
        t0 = time.perf_counter()
        for _ in range(REPS):
            call()
        ms = (time.perf_counter() - t0) / REPS * 1e3
    return ms, 1 + REPS


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--envs", type=int, default=2048)
    ap.add_argument("--sizes", default="512,1024,2048",
                    help="row counts of the blocks-of-6 case")
    ap.add_argument("--size", type=int, default=1024, help="row count of the other cases")
    args = ap.parse_args(argv)
    dev = resolve(args.device)

    runs = [("blocks6", int(n)) for n in args.sizes.split(",")]
    runs += [(c, args.size) for c in CASES[1:]]
    if dev.type == "cuda":
        clock = f"CUDA events on {torch.cuda.get_device_name(dev)}"
    else:
        clock = "host clock, CPU, plain version"
    print(f"env-last fat-row sweep: B={args.envs}, {BODIES} bodies, {ITERS} "
          f"iterations; ms per call ({clock}); per row visit = time / (rows x iterations), "
          "all envs of a call in parallel", flush=True)
    results, calls = [], 0
    for case, nr in runs:
        ms, n = time_case(case, nr, args.envs, dev)
        calls += n
        ns = ms * 1e6 / (nr * ITERS)
        print(f"{LABELS[case]:34s} nr={nr:5d} time={ms:8.2f}ms per-visit={ns:7.1f}ns",
              flush=True)
        results.append({"case": case, "rows": nr, "ms": ms, "ns_per_visit": ns})
    print(json.dumps({"device": str(dev), "clock": clock, "envs": args.envs,
                      "iters": ITERS, "results": results, "sweep_calls": calls}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

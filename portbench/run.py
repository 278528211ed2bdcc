"""Runs one cell of the port's benchmark once and prints its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout: ``BENCHMARK.json`` names the cells. The
last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared with its limit);
the numbers compared also end standard error. Without a CUDA card, or with
a JAX module loaded, it exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from portbench import harness  # noqa: E402


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None, device: str = "cuda", t0: float = T0) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    found = harness.banned_modules()
    if found:
        log(f"refusing to run: loaded modules {found}")
        return 3
    cell = harness.Cell(args.workload)
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.workload["chips"]:
            log(f"no CUDA card for {cell.name} (needs {cell.workload['chips']}): "
                "the benchmark does not run on the CPU")
            return 2
        torch.cuda.set_device(0)
    log(f"torch {torch.__version__}, intra-op threads {harness.THREADS}; "
        + (torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"))

    run, readings = harness.measure(cell, args.seed, args.seconds, bool(args.trace), dev, t0,
                                    log)
    correct, checks = harness.judge(readings, cell.limits)
    names = cell.per_layer if args.trace else cell.end_to_end
    metrics = harness.read_metrics(run, names)
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "kind": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
        "count": cell.workload["chips"],
        "memory_peak_bytes": run.memory_peak_bytes,
    }
    result = {"correct": correct, "attempted": run.iterations, "failed": run.failed,
              "metrics": metrics, "device": device_info}
    if args.trace and run.trace is not None:
        device_info["busy_s"] = run.trace.busy_s()
        device_info["window_s"] = run.trace.window_s()
        result["breakdown"] = {"device_ops": run.trace.top_device_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    found = harness.banned_modules()
    if found:
        log(f"loaded modules {found} after the window: no result")
        return 3
    result["checks"] = checks
    for name, row in checks.items():
        log(f"check {name}: {row['value']} (limit {row['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Readings that the limits of ``limits/<cell>.json`` are set from.

    python3 portbench/calibrate.py --workload <name> --seeds <a,b,...> [--out <file>]

For each seed, in one process: the program's set-up through its checked
iterations, then the cell's adapter's ``calibration()``: the numbers
compared for the program against the reference (``program``: sound runs,
the lower readings), for the control (the reference one precision below the
configuration's in the program's place) and for each planted fault the
family names (for PPO: ``control`` with TF32 matrix products and J columns
in fp8 e4m3, ``half_batch`` with half of the env batch left out).

Each seed prints one JSON line (also appended to ``--out``). The
benchmark's own runs never run this. Needs the card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from portbench import harness  # noqa: E402


def readings(cell: harness.Cell, seed: int, device) -> dict:
    adapter = harness.adapter_for(cell, seed, device)
    t0 = time.perf_counter()
    adapter.setup()
    t_setup = time.perf_counter() - t0
    adapter.release()
    return {"seed": seed, "setup_s": t_setup, **adapter.calibration()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(harness.THREADS)
    cell = harness.Cell(args.workload)
    dev = torch.device("cuda")
    for seed in (int(s) for s in args.seeds.split(",")):
        line = json.dumps({"workload": cell.name, **readings(cell, seed, dev)})
        print(line, flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

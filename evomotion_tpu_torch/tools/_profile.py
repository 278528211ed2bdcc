"""Helpers the port's profilers share (``profile_step``, ``tools.prof_step``)."""

from __future__ import annotations

import json
import os
import subprocess
import tempfile

from ..train.profiling import DEVICE_CATS


def card_name() -> str:
    """``name, power limit`` of the card as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown card"


def device_events(prof):
    """(name, microseconds) of every kernel, copy and fill the card ran,
    read from a ``torch.profiler`` run's chrome trace (stable across torch
    versions)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return [(e["name"], float(e.get("dur", 0.0))) for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]

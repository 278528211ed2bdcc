"""Profiling and step-timing utilities (port of
``evomotion_tpu/train/profiling.py``).

The reference has no tracing or profiling (SURVEY §5), only a progress bar.
As in the JAX package: a profiler trace around a training phase
(``torch.profiler``, a chrome trace), named regions inside it
(``record_function``), and wall-clock phase timers feeding the env-steps/s
metric, which wait for the card before they read the clock.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the host and, where there is
    one, the card; written to ``log_dir/trace.json`` (chrome://tracing or
    Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Named region inside a trace."""
    return torch.profiler.record_function(name)


def wait_for(x) -> None:
    """Waits for the card when ``x`` (a tensor or a ``torch.device``) is on
    one; returns at once on the CPU."""
    dev = x if isinstance(x, torch.device) else x.device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class StepTimer:
    """Wall-clock phase timer with per-phase totals and rates."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        """Times the block; with ``block_on`` (a tensor the block makes, or
        its device) it first waits for the card to finish."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                wait_for(block_on)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def rate(self, name: str, units_per_call: float) -> float:
        """units/s for a phase (e.g. env-steps/s with units = horizon*n_envs)."""
        total = self.totals.get(name, 0.0)
        if total <= 0:
            return 0.0
        return self.counts[name] * units_per_call / total

    def summary(self) -> str:
        parts = [
            f"{k}: {self.totals[k]:.2f}s/{self.counts[k]}x" for k in sorted(self.totals)
        ]
        return ", ".join(parts)

"""Profiling and step-timing utilities (port of
``evomotion_tpu/train/profiling.py``).

The reference has no tracing or profiling (SURVEY §5), only a progress bar.
As in the JAX package: a profiler trace around a training phase
(``torch.profiler``, a chrome trace), named regions inside it, and
wall-clock phase timers feeding the env-steps/s metric, which wait for the
card before they read the clock.

The named regions are the program's spans (:data:`SPANS`, opened with
:func:`span` in the trainers, the env step, the physics step, the trainer's
set-up and the kernel build). A span costs one check while neither a
``torch.profiler`` records nor a recorder (:func:`recording`) is installed.
Under a profiler it is a ``record_function`` range, on the trace's clock
with the card's events; :func:`span_table` charges each kernel of such a
trace to the span that launched it, and each idle stretch of the card to
the span the host was in.

    python -m evomotion_tpu_torch.train.profiling <trace.json>

prints that table for a trace written by :func:`trace` (the driver's
``EVOMOTION_TRACE_DIR``).
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import sys
import time
from collections import defaultdict

import torch

# The program's spans, parents before children (the nesting is documented
# in PERF.md): the policy inside the rollout, the env step and its physics
# step, the update, and the set-up.
SPANS = (
    "rollout.policy",
    "env.step", "env.observe", "env.autoreset",
    "physics.step", "physics.contacts", "physics.joint_rows", "physics.contact_rows",
    "physics.member", "physics.sweep", "physics.integrate",
    "update.gae", "update.actor", "update.critic",
    "setup.trainer", "env.reset", "kernels.build",
)
# the phases that timers open around the rollout and the update
# (``train_step_fn(timer=...)``): span_table's outer spans
PHASES = ("rollout", "update")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
UNATTRIBUTED = "(unattributed)"
# span_table's columns: calls and host ms from the spans, card work and idle
# time charged to the span itself, then with the spans nested in it ("_in")
COLUMNS = ("calls", "host_ms", "kernels", "device_ms", "idle_ms", "kernels_in",
           "device_ms_in", "idle_ms_in")

_OFF = contextlib.nullcontext()
_recorder = None  # the StepTimer that recording() installed


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the host and, where there is
    one, the card; written to ``log_dir/trace.json`` (chrome://tracing or
    Perfetto). The program's spans are ranges in it."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def span(name: str, block_on=None):
    """The program span ``name`` around a block: a ``record_function``
    range while a ``torch.profiler`` records, and host seconds and a call
    under ``name`` in the installed recorder's ``totals`` and ``counts``.
    With a recorder installed, ``block_on`` (a tensor or a device) is
    waited for before the clock is read. With neither, one shared no-op
    context."""
    rec = _recorder
    if rec is None and not torch.autograd._profiler_enabled():
        return _OFF
    return _span(name, rec, block_on)


@contextlib.contextmanager
def _span(name, rec, block_on):
    rng = torch.profiler.record_function(name) if torch.autograd._profiler_enabled() else _OFF
    with rng, (_OFF if rec is None else rec.phase(name, block_on)):
        yield


@contextlib.contextmanager
def recording(timer: StepTimer):
    """Installs ``timer`` as the recorder of every :func:`span` opened in
    the block (the previous one is restored after it)."""
    global _recorder
    prev, _recorder = _recorder, timer
    try:
        yield timer
    finally:
        _recorder = prev


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


# -- reading a trace back ----------------------------------------------------


def _events(path: str) -> list:
    with open(path) as f:
        raw = json.load(f)
    events = raw["traceEvents"] if isinstance(raw, dict) else raw
    return [e for e in events if e.get("ph") == "X"]


def _busy(device, window):
    """The union of the device intervals inside ``window``, in order."""
    lo, hi = window
    merged = []
    for a, b in sorted((max(e["ts"], lo), min(e["ts"] + e["dur"], hi)) for e in device
                       if e["ts"] + e["dur"] > lo and e["ts"] < hi):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _segments(spans):
    """The host timeline cut where a span opens or closes: ``(times,
    chains)``, ``chains[i]`` the names of the spans open from ``times[i]``
    to ``times[i + 1]``, outermost first. ``spans``: ``(start, end, name)``
    in start order, parents first."""
    times, chains, stack = [], [], []

    def cut(t):
        times.append(t)
        chains.append(tuple(s[2] for s in stack))

    for s in spans:
        while stack and stack[-1][1] <= s[0]:
            cut(stack.pop()[1])
        stack.append(s)
        cut(s[0])
    while stack:
        cut(stack.pop()[1])
    return times, chains


def span_table(path: str) -> dict:
    """Charges a chrome trace's card work and idle time to the spans.

    Each kernel, copy and fill goes to the innermost span that holds the
    host time of its launch (matched by ``correlation``): a span of
    :data:`SPANS`, else a phase of :data:`PHASES` as ``(<phase> self)``,
    else ``(unattributed)``, as is a device event whose launch is not in
    the trace. Each instant of the window (first phase's start to last phase's
    end; the spans' extent without phases) with nothing on the card goes
    the same way, by the span open on the host at that instant.

    Returns ``{"window_ms", "idle_ms", "rows"}``; ``rows`` maps each label
    to ``calls``, ``host_ms`` (the spans' durations in the trace),
    ``kernels`` (launches, copies and fills excluded), ``device_ms`` and
    ``idle_ms`` charged to the label itself, and ``kernels_in``,
    ``device_ms_in`` and ``idle_ms_in`` with the spans nested inside it."""
    events = _events(path)
    keep = set(SPANS) | set(PHASES)
    spans = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                    for e in events if e.get("cat") == "user_annotation"
                    and e["name"] in keep), key=lambda s: (s[0], -s[1]))
    launch = {e["args"]["correlation"]: float(e["ts"]) for e in events
              if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    device = [e for e in events if e.get("cat") in DEVICE_CATS]

    def label(chain):
        if not chain:
            return UNATTRIBUTED
        return chain[-1] if chain[-1] in SPANS else f"({chain[-1]} self)"

    rows = defaultdict(lambda: dict.fromkeys(COLUMNS, 0))
    for s0, s1, name in spans:
        rows[name]["calls"] += 1
        rows[name]["host_ms"] += (s1 - s0) * 1e-3

    def charge(chain, key, value):
        rows[label(chain)][key] += value
        for name in set(chain):
            rows[name][key + "_in"] += value

    times, chains = _segments(spans)

    def chain_at(t):
        i = bisect.bisect_right(times, t) - 1
        return chains[i] if i >= 0 else ()

    for e in device:
        t = launch.get(e.get("args", {}).get("correlation"))
        chain = () if t is None else chain_at(t)
        charge(chain, "device_ms", float(e["dur"]) * 1e-3)
        if e["cat"] == "kernel":
            charge(chain, "kernels", 1)

    outer = [s for s in spans if s[2] in PHASES] or spans
    if not outer:
        return {"window_ms": 0.0, "idle_ms": 0.0, "rows": dict(rows)}
    window = (outer[0][0], max(s[1] for s in outer))
    busy = _busy(device, window)
    edges = [window[0], *(x for iv in busy for x in iv), window[1]]
    idle = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    bounds = times + [window[1]]
    for a, b in idle:
        i = max(bisect.bisect_right(times, a) - 1, 0)
        if a < times[0]:
            charge((), "idle_ms", (min(b, times[0]) - a) * 1e-3)
        while i < len(times) and bounds[i] < b:
            lo, hi = max(a, bounds[i]), min(b, bounds[i + 1])
            if hi > lo:
                charge(chains[i], "idle_ms", (hi - lo) * 1e-3)
            i += 1
    return {"window_ms": (window[1] - window[0]) * 1e-3,
            "idle_ms": sum(b - a for a, b in idle) * 1e-3, "rows": dict(rows)}


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if len(args) != 1:
        print("usage: python -m evomotion_tpu_torch.train.profiling <trace.json>",
              file=sys.stderr)
        return 2
    table = span_table(args[0])
    print(f"window {table['window_ms']:.3f} ms, card idle {table['idle_ms']:.3f} ms")
    print(f"{'span':>22} " + " ".join(f"{c:>12}" for c in COLUMNS))
    for name, row in sorted(table["rows"].items(), key=lambda kv: -kv[1]["idle_ms"]):
        print(f"{name:>22} " + " ".join(f"{row[c]:>12.3f}" if isinstance(row[c], float)
                                        else f"{row[c]:>12}" for c in COLUMNS))
    return 0


if __name__ == "__main__":
    sys.exit(main())

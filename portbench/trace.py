"""The benchmark's spans and its reading of the device trace.

:class:`PhaseTimer` is the timer the trainers' ``train_step_fn(timer=...)``
takes (a copy of the port's ``train.profiling.StepTimer``, which waits for
the card at the end of each phase), extended to open a profiler span per
phase. :func:`profile` runs one call under ``torch.profiler`` and reads the
chrome trace it exports (the arithmetic of the port's
``tools._profile.device_events``, with timestamps) into a :class:`Trace`:
the device's events, the two phases, the program's own spans (its
``train.profiling.span`` ranges and any other user annotation) and each
launch's host time, by the ``correlation`` that ties it to its device
event. :meth:`Trace.launched_in` charges device events to the spans that
launched them, as the port's ``train.profiling.span_table`` does, with the
benchmark's own arithmetic.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import NamedTuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
PHASES = ("rollout", "update")  # the phases PhaseTimer opens (the trainers name them)


class PhaseTimer:
    """Host-clock phase times, each phase a profiler span that ends in a
    wait for the card."""

    def __init__(self):
        self.times: dict[str, list[float]] = defaultdict(list)

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            try:
                yield
            finally:
                dev = block_on if isinstance(block_on, torch.device) else getattr(
                    block_on, "device", None)
                if dev is not None and dev.type == "cuda":
                    torch.cuda.synchronize(dev)
        self.times[name].append(time.perf_counter() - t0)


class Event(NamedTuple):
    name: str
    cat: str
    ts: float  # microseconds
    dur: float
    corr: int | None  # the profiler's correlation id, where it gives one


class Trace(NamedTuple):
    device: list  # kernels, copies and fills
    spans: list  # the phases' spans (user annotations on the host)
    host_ops: list  # top-level host operators
    program_spans: list  # every other user annotation: the program's spans
    launches: dict  # correlation id -> host time of the launch (microseconds)

    def window(self) -> tuple[float, float] | None:
        """First span's start to last span's end, in microseconds."""
        if not self.spans:
            return None
        return min(e.ts for e in self.spans), max(e.ts + e.dur for e in self.spans)

    def kernels_in(self, span_name: str) -> int:
        """Kernel launches the card ran inside the spans called ``span_name``
        (each phase ends in a wait for the card, so its kernels finish inside
        it)."""
        spans = [(e.ts, e.ts + e.dur) for e in self.spans if e.name == span_name]
        return sum(1 for k in self.device if k.cat == "kernel"
                   and any(a <= k.ts and k.ts + k.dur <= b for a, b in spans))

    def launched_in(self, span_name: str) -> tuple[int, float]:
        """(kernels, device seconds) of the device events launched inside a
        span called ``span_name``, a phase or a program span, with the spans
        nested in it: those whose launch's host time lies in ``[start,
        end)`` of such a span, wherever the card ran them. The seconds count
        copies and fills too; a device event whose launch is not in the
        trace counts nowhere."""
        ivs = sorted((e.ts, e.ts + e.dur) for e in (*self.spans, *self.program_spans)
                     if e.name == span_name)
        starts, ends = [], []
        for a, b in ivs:
            if ends and a <= ends[-1]:
                ends[-1] = max(ends[-1], b)
            else:
                starts.append(a)
                ends.append(b)
        kernels, seconds = 0, 0.0
        for e in self.device:
            t = self.launches.get(e.corr)
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t < ends[i]:
                kernels += e.cat == "kernel"
                seconds += e.dur * 1e-6
        return kernels, seconds

    def busy(self) -> list[tuple[float, float]]:
        """The union of the device's operation intervals inside the window."""
        win = self.window()
        if win is None:
            return []
        ivs = sorted((max(e.ts, win[0]), min(e.ts + e.dur, win[1])) for e in self.device
                     if e.ts + e.dur > win[0] and e.ts < win[1])
        merged = []
        for a, b in ivs:
            if merged and a <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], b))
            else:
                merged.append((a, b))
        return merged

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) * 1e-6

    def window_s(self) -> float:
        win = self.window()
        return 0.0 if win is None else (win[1] - win[0]) * 1e-6

    def top_device_ops(self, n: int = 10) -> list:
        total = defaultdict(float)
        for e in self.device:
            total[e.name[:120]] += e.dur * 1e-6
        return sorted(([k, v] for k, v in total.items()), key=lambda x: -x[1])[:n]

    def idle_gaps(self, n: int = 10) -> list:
        """The ``n`` longest stretches with nothing on the device, each named
        by the outermost host operator running when it began."""
        busy = self.busy()
        win = self.window()
        if not busy:
            return []
        edges = [win[0]] + [x for iv in busy for x in iv] + [win[1]]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        ops = sorted(self.host_ops, key=lambda e: e.ts)
        out = []
        for a, b in gaps[:n]:
            running = [e for e in ops if e.ts <= a < e.ts + e.dur]
            label = max(running, key=lambda e: e.dur).name if running else "host, no operator"
            out.append([label[:120], (b - a) * 1e-6])
        return out


def _read(path: str) -> Trace:
    with open(path) as f:
        raw = json.load(f)
    events = raw["traceEvents"] if isinstance(raw, dict) else raw
    device, spans, program_spans, ops, launches = [], [], [], [], {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ev = Event(e.get("name", ""), cat, float(e.get("ts", 0.0)), float(e.get("dur", 0.0)),
                   e.get("args", {}).get("correlation"))
        if cat in DEVICE_CATS:
            device.append(ev)
        elif cat == "user_annotation":
            (spans if ev.name in PHASES else program_spans).append(ev)
        elif cat == "cpu_op":
            ops.append(ev)
        elif cat in LAUNCH_CATS and ev.corr is not None:
            launches[ev.corr] = ev.ts
    # keep the outermost operators: those no other operator contains
    ops.sort(key=lambda e: (e.ts, -e.dur))
    top, end = [], -1.0
    for e in ops:
        if e.ts >= end:
            top.append(e)
            end = e.ts + e.dur
    return Trace(device, spans, top, program_spans, launches)


def profile(fn) -> tuple[Trace, float]:
    """Runs ``fn()`` under ``torch.profiler`` (host, and the card where
    there is one) and returns its trace and the seconds ``fn`` took. The
    chrome trace goes to a temporary directory under ``TMPDIR`` and is
    deleted once read."""
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        took = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        del prof
        return _read(path), took

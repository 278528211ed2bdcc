"""One run of one cell: set-up, the measured window, the metrics, and the
comparison that decides ``correct``.

Everything that belongs to one configuration, traffic mix, metric or agent
family lives in a file of its own, found by name: ``BENCHMARK.json`` (at the
checkout's root) names each cell's configuration and traffic;
``configs/<name>.json`` and ``traffic/<name>.json`` hold them;
``limits/<cell>.json`` holds the cell's limits for the numbers compared;
``trainers/<agent>.py`` adapts the configuration's trainer and names the
numbers it compares, and ``counts/agents/<agent>.py`` counts its networks'
operations (both found by the configuration's ``agent``);
``metrics/<metric>.py`` reads each metric.
"""

from __future__ import annotations

import importlib
import json
import math
import sys
import time
from pathlib import Path
from typing import Any

import torch

from . import trace as tr

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
THREADS = 4  # torch's intra-op threads, the same in every run
BANNED = ("jax", "jaxlib", "flax", "evomotion_tpu")  # top-level names, compared whole


def banned_modules(modules=None) -> list[str]:
    """The loaded modules' top-level names that the benchmark forbids."""
    modules = sys.modules if modules is None else modules
    return sorted({n.split(".")[0] for n, m in list(modules.items())
                   if m is not None and n.split(".")[0] in BANNED})


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def family_module(path: str, cell: str):
    """The agent family's module ``portbench/<path>.py`` (``path`` in dots);
    a cell whose family lacks it stops the run, naming the file."""
    name = f"portbench.{path}"
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name != name:
            raise
        raise SystemExit(f"workload {cell!r}: its agent family has no "
                         f"portbench/{path.replace('.', '/')}.py") from None


class Cell:
    """A workload of ``BENCHMARK.json`` with its configuration, traffic and
    limits, its agent family's adapter and count modules, and the names of
    the metrics it reports. A family without either module stops it here,
    before any set-up."""

    def __init__(self, name: str, manifest: dict | None = None):
        manifest = load_json(ROOT / "BENCHMARK.json") if manifest is None else manifest
        by_name = {w["name"]: w for w in manifest["workloads"]}
        if name not in by_name:
            raise SystemExit(f"unknown workload {name!r}; known: {sorted(by_name)}")
        self.name = name
        self.workload = by_name[name]
        entry = {c["name"]: c for c in manifest["configs"]}[self.workload["config"]]
        self.config = load_json(ROOT / entry["file"])
        self.traffic = load_json(HERE / "traffic" / f"{self.workload['traffic']}.json")
        self.limits = load_json(HERE / "limits" / f"{name}.json")
        agent = self.config["agent"]
        self.adapter_module = family_module(f"trainers.{agent}", name)
        self.counts_module = family_module(f"counts.agents.{agent}", name)

        def mine(metrics):
            return [m["name"] for m in metrics if name in m.get("workloads", [name])]

        self.end_to_end = mine(manifest["end_to_end"])
        self.per_layer = mine(manifest["per_layer"])


class Run:
    """What one run measured, for the metric readers."""

    def __init__(self, cell: Cell, adapter):
        self.adapter = adapter
        self.config, self.traffic = cell.config, cell.traffic
        self.setup_s = self.window_s = 0.0
        self.iterations = 0
        self.iteration_s: list[float] = []  # each window iteration, host clock
        self.timer = None  # trace.PhaseTimer of the traced run
        self.trace = None  # trace.Trace of the iteration profiled after the window
        self.memory_peak_bytes = 0
        self.failed = 0
        self.obs_size = self.act_size = 0

    @property
    def env_steps(self) -> int:
        return self.iterations * self.adapter.env_steps_per_iteration

    def window_phase_s(self, phase: str) -> list[float]:
        """The phase's times in the window's iterations (the traced run's;
        the profiled iteration after the window is left out)."""
        return list(self.timer.times.get(phase, []))[:self.iterations] if self.timer else []


def adapter_for(cell: Cell, seed: int, device):
    """The cell's adapter, ``trainers/<agent>.py``'s ``Adapter``."""
    return cell.adapter_module.Adapter(cell.config, cell.traffic, seed, device)


def measure(cell: Cell, seed: int, seconds: float, trace: bool, device, t0: float,
            log=print) -> tuple[Run, dict]:
    """Set-up, the window and the comparison; returns the run and the
    readings of the numbers compared."""
    torch.set_num_threads(THREADS)
    adapter = adapter_for(cell, seed, device)
    run = Run(cell, adapter)
    adapter.setup()
    env = adapter.trainer.env
    run.obs_size, run.act_size = env.observation_size, env.action_size
    cuda = device.type == "cuda"
    if trace:
        run.timer = tr.PhaseTimer()
        tr.profile(lambda: torch.zeros(1, device=device) + 1)  # starts the profiler's tracer
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    run.setup_s = time.perf_counter() - t0

    start = time.perf_counter()
    deadline = start + seconds
    while True:
        t_it = time.perf_counter()
        adapter.iteration(run.timer)
        run.iterations += 1
        run.iteration_s.append(time.perf_counter() - t_it)  # waits for the card when traced
        if time.perf_counter() >= deadline:
            break
    if cuda:
        torch.cuda.synchronize(device)
    run.window_s = time.perf_counter() - start
    run.memory_peak_bytes = torch.cuda.max_memory_allocated(device) if cuda else 0
    run.failed = adapter.failed()
    log(f"window: {run.iterations} iterations, {run.env_steps} env steps in "
        f"{run.window_s:.4f} s; set-up {run.setup_s:.4f} s")
    if trace:
        # one more iteration under the profiler, after the window
        run.trace, took = tr.profile(lambda: adapter.iteration(run.timer))
        untraced = sum(run.iteration_s) / len(run.iteration_s)
        log(f"tracing overhead: the profiled iteration took {took:.4f} s, the window's "
            f"{untraced:.4f} s on average ({took / untraced - 1:+.2%})")
    adapter.release()
    t_ref = time.perf_counter()
    readings = adapter.readings()
    log(f"comparison with the reference: {time.perf_counter() - t_ref:.4f} s")
    return run, readings


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over the numbers that have a
    limit: each at or under it. A number that is missing or not finite
    fails."""
    rows, ok = {}, True
    for name, limit in limits.items():
        v = readings.get(name)
        ok = ok and v is not None and math.isfinite(v) and v <= limit
        rows[name] = {"value": v, "limit": limit}
    return ok, rows


def read_metrics(run: Run, names: list[str]) -> dict:
    """Each named metric's reader on the run; a metric whose reader finds
    nothing to read is left out."""
    out = {}
    for name in names:
        mod = importlib.import_module(f"portbench.metrics.{name}")
        value = mod.read(run)
        if value is not None and math.isfinite(value):
            out[name] = {"value": value, "unit": mod.UNIT}
    return out

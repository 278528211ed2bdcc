"""Kernel #1's share of its roofline: the least time of one sweep call on
an H100 (``counts.sweep``, from the configuration's shapes and the env
batch) over the kernel's mean device time per call in the profiled
iteration."""

from ..counts import sweep

LAYER = "sweep kernel"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "env_steps_per_s"
KERNEL = "sweep_envlast_slim"


def read(run):
    if run.trace is None:
        return None
    calls = [e.dur for e in run.trace.device if e.cat == "kernel" and KERNEL in e.name]
    if not calls:
        return None
    per_call_s = sum(calls) / len(calls) * 1e-6
    return sweep.least_seconds(run.config["sweep"], run.traffic["num_envs"]) / per_call_s * 100

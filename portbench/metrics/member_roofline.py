"""Kernel #4's share of its roofline: the least time of one member contact
call on an H100 (``counts.member``, from the configuration's ``member``
shapes and the env batch) over the kernel's mean device time per call in
the profiled iteration."""

from ..counts import member

LAYER = "member kernel"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "env_steps_per_s"
KERNEL = "member_contacts_kernel"


def read(run):
    if run.trace is None:
        return None
    calls = [e.dur for e in run.trace.device if e.cat == "kernel" and KERNEL in e.name]
    if not calls:
        return None
    per_call_s = sum(calls) / len(calls) * 1e-6
    return member.least_seconds(run.config["member"], run.traffic["num_envs"]) / per_call_s * 100

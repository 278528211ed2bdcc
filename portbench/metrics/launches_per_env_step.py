"""Kernel launches per rollout step, from the device trace: the kernels the
card ran inside the profiled iteration's ``rollout`` span, over the
horizon."""

LAYER = "physics step"
UNIT = "launches"
SOURCE = "device_trace"
MOVES = "env_steps_per_s"


def read(run):
    if run.trace is None:
        return None
    n = run.trace.kernels_in("rollout")
    return n / run.config["agent_parameters"]["horizon"] if n else None

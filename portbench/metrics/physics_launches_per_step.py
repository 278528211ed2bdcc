"""Kernel launches per physics step, from the device trace: the kernels
launched inside the program's ``physics.step`` spans of the profiled
iteration (the contacts, the rows, kernel #4, kernel #1 and the
integration, with the axis moves), over the rollout's steps."""

LAYER = "physics step"
UNIT = "launches"
SOURCE = "device_trace"
MOVES = "env_steps_per_s"
SPAN = "physics.step"


def read(run):
    if run.trace is None:
        return None
    n, _ = run.trace.launched_in(SPAN)
    return n / run.config["agent_parameters"]["horizon"] if n else None

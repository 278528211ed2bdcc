"""Kernel launches per update, from the device trace: the kernels the card
ran inside the profiled iteration's ``update`` span."""

LAYER = "networks and update"
UNIT = "launches"
SOURCE = "device_trace"
MOVES = "env_steps_per_s"
SPAN = "update"


def read(run):
    if run.trace is None:
        return None
    return float(run.trace.kernels_in(SPAN)) or None

"""The share of the profiled iteration (first span's start to last span's
end) in which the card ran no kernel, copy or fill."""

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "env_steps_per_s"


def read(run):
    if run.trace is None or not run.trace.device or run.trace.window_s() <= 0:
        return None
    return (1.0 - run.trace.busy_s() / run.trace.window_s()) * 100

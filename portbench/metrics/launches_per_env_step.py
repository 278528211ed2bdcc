"""Kernel launches per rollout step, from the device trace: the kernels the
card ran inside the profiled iteration's ``rollout`` span, over the
horizon: the policy, the env's bookkeeping and the physics step together
(``physics_launches_per_step`` counts the physics step alone)."""

LAYER = "env rollout"
UNIT = "launches"
SOURCE = "device_trace"
MOVES = "env_steps_per_s"
SPAN = "rollout"


def read(run):
    if run.trace is None:
        return None
    n = run.trace.kernels_in(SPAN)
    return n / run.config["agent_parameters"]["horizon"] if n else None

"""Milliseconds per rollout step (every env stepped once, with the policy's
sampling): the trainer's ``rollout`` phase over the horizon, averaged over
the traced run's window (the phase ends in a wait for the card)."""

LAYER = "env rollout"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "env_steps_per_s"
SPAN = "rollout"


def read(run):
    times = run.window_phase_s(SPAN)
    if not times:
        return None
    return sum(times) / len(times) / run.config["agent_parameters"]["horizon"] * 1e3

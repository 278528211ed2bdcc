"""Milliseconds per update (GAE and every epoch of both networks): the
trainer's ``update`` phase, averaged over the traced run's window (the phase ends in a wait for the
card)."""

LAYER = "trainer update"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "env_steps_per_s"
SPAN = "update"


def read(run):
    times = run.window_phase_s(SPAN)
    return sum(times) / len(times) * 1e3 if times else None

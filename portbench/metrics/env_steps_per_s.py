"""Simulated experience per second of training: every env step of the
window's iterations (iterations x horizon x envs), updates included, over
the window's seconds (host clock, from a wait for the card before the first
iteration to one after the last)."""

UNIT = "env-steps/s"
SOURCE = "host_clock"


def read(run):
    return run.env_steps / run.window_s if run.window_s > 0 else None

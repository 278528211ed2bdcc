"""The card's peak allocated memory over the window
(``torch.cuda.max_memory_allocated`` after a reset at its start)."""

LAYER = "device"
UNIT = "GiB"
SOURCE = "program_counter"
MOVES = "env_steps_per_s"


def read(run):
    return run.memory_peak_bytes / 2**30 if run.memory_peak_bytes else None

"""Windowed metric meters (the port's own copy of
``evomotion_tpu/train/metrics.py``, which it may not import).

Reference: evo_motion_networks/src/metrics.cpp (Meter/LossMeter): windowed
running mean (window 64 everywhere), name = value display strings, and a
to_csv that (quirk preserved) re-opens the file without append so only the
latest row survives (metrics.cpp:40-52).
"""

from __future__ import annotations

import os
from collections import deque


class Meter:
    def __init__(self, name: str, window_size: int | None = 64, default_value: float = 0.0):
        self.name = name
        self.window_size = window_size
        self.default_value = default_value
        self.results: deque = deque(maxlen=window_size)
        self.curr_step = 0

    def add(self, value: float) -> None:
        self.results.append(float(value))
        self.curr_step += 1

    def loss(self) -> float:
        if not self.results:
            return self.default_value
        return sum(self.results) / len(self.results)

    def set_window_size(self, new_window_size: int | None) -> None:
        old = list(self.results)
        self.window_size = new_window_size
        self.results = deque(old[-new_window_size:] if new_window_size else old, maxlen=new_window_size)

    def to_csv(self, output_directory: str) -> None:
        """Replicates the reference's truncate-not-append behavior."""
        path = os.path.join(output_directory, f"{self.name}.csv")
        if not os.path.exists(path):
            with open(path, "w") as f:
                f.write("step,loss\n")
        with open(path, "w") as f:  # truncates: only the last row survives
            f.write(f"{self.curr_step},{self.loss():.6f}\n")

    def to_string(self) -> str:
        return f"{self.name} = {self.loss():.6f}"


class LossMeter(Meter):
    """Float meter (LossMeter in metrics.h); window 64 by default."""

"""The walker tools at a size the CPU runs in seconds (the CPU tests and
``chip_smoke.py --cpu``)."""

from __future__ import annotations

import contextlib
import dataclasses


@contextlib.contextmanager
def small_walker(horizon: int = 3):
    """While open, every robot_walk env that ``RobotWalkFactory.make``
    builds settles with ``reset_frames=1`` and runs one solver iteration,
    and the eval horizons of ``tools.eval_walk``, ``tools.train_walk`` and
    ``tools.train_walk_offpolicy`` are ``horizon`` env steps in place of
    the 1800-step win horizon."""
    from ..envs import robot
    from . import eval_walk, train_walk, train_walk_offpolicy

    make = robot.RobotWalkFactory.make
    saved = (make, eval_walk.WIN, train_walk.WIN_STEPS, train_walk_offpolicy.WIN_STEPS)

    def small_make(self, *a, **kw):
        self.parameters = {**self.parameters, "reset_frames": "1"}
        env = make(self, *a, **kw)
        env.model = dataclasses.replace(env.model, n_iterations=1)
        return env

    robot.RobotWalkFactory.make = small_make
    eval_walk.WIN = train_walk.WIN_STEPS = train_walk_offpolicy.WIN_STEPS = horizon
    try:
        yield
    finally:
        (robot.RobotWalkFactory.make, eval_walk.WIN, train_walk.WIN_STEPS,
         train_walk_offpolicy.WIN_STEPS) = saved

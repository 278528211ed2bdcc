"""A frozen copy of the PyTorch port's plain physics path for the batched
``robot_walk`` step on the spider: the skeleton loader and compiler, the
model tables, the batched step (``batched.step_envlast``) with the sweep's
plain version in place of kernel #1 on every device, and the env
(``walk.RobotWalk``). The spider's files are copied under ``resources/``.

It is the reference the port's env step is held against, so it is frozen:
a change to the port leaves it as it is. Beyond the copy it keeps only the
batched tier, runs the sweep's plain version on the card too, fixes the
canonical row order, and adds the ``fp8`` row precision (J rounded to
e4m3) that the benchmark's control runs.
"""

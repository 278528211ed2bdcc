"""PyTorch / CUDA port of evomotion_tpu for NVIDIA Hopper cards.

A second package beside the JAX reference ``evomotion_tpu``; it imports no
JAX and no module of that package. It runs the batched spider
``robot_walk`` rollout (``envs.robot.RobotWalk``, the batched physics step)
and the CLI's sequential ``run`` path (``cli``: cartpole, cartpole3d and
robot_walk, one world stepped by the per-env physics step), with the
sequential-impulse sweeps as hand-written CUDA kernels (``kernels/csrc``).
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

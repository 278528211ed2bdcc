"""The benchmark's plain reference: PyTorch and NumPy only.

Nothing here imports ``jax``, the JAX package or the PyTorch port. The
physics step is a frozen copy of the port's plain paths (``sim/``); the
networks, the truncated-normal policy, GAE, the clipped PPO update and Adam
are written out here (``nets``, ``dist``, ``ppo``); ``compare`` turns the
program's captured outputs and the reference's into the numbers that decide
``correct``.
"""

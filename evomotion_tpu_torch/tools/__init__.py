"""Tools of the port, the counterparts of the repo's ``tools/``:
``prof_kernel`` (the env-last fat-row sweep per row visit), ``prof_step``
(phases of the batched spider step), ``eval_walk`` (greedy evaluation of a
robot_walk checkpoint) and ``train_walk`` (long-run batched PPO training
with learning-curve and greedy-eval logging). Run each with
``python -m evomotion_tpu_torch.tools.<name>``; they run on the card unless
given ``--device cpu`` (the profilers) or ``device="cpu"`` (``main`` of the
walker tools)."""

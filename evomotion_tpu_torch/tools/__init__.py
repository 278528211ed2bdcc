"""Tools of the port, the counterparts of the repo's ``tools/``:
``prof_kernel`` (the env-last fat-row sweep per row visit), ``prof_step``
(phases of the batched spider step), ``eval_walk`` (greedy evaluation of a
robot_walk checkpoint), ``train_walk`` (long-run batched PPO training with
learning-curve and greedy-eval logging), ``train_walk_offpolicy`` (the same
for SAC and CrossQ), ``train_offpolicy_cartpole`` (SAC and CrossQ
learning curves on cartpole), ``strict_trajectory`` (the strict-Bullet
artifact replayed on the xla step) and ``multihost_worker`` (one rank of
data-parallel training, under ``torch.distributed.run``). Run each with
``python -m evomotion_tpu_torch.tools.<name>``; they run on the card
unless given ``--device cpu`` (the profilers, the off-policy tools, the
replay and the worker) or ``device="cpu"`` (``main`` of the walker
tools)."""

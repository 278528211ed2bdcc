"""PyTorch / CUDA port of evomotion_tpu for NVIDIA Hopper cards.

A second package beside the JAX reference ``evomotion_tpu``; it imports no
JAX and no module of that package. It runs the batched spider
``robot_walk`` rollout (``envs.robot.RobotWalk``, the batched physics step);
the CLI's sequential ``run`` path (``cli``: cartpole, cartpole3d and
robot_walk, one world stepped by the per-env physics step); batched PPO-GAE
training through the CLI's ``train --num_envs N`` (``train.ppo_batched``,
``train.driver.train_batched``) and ``tools.train_walk``; the off-policy
tier: the SAC and CrossQ agents (``agents``) with their replay buffers
(``buffers.replay``), batched training with a device ring
(``train.offpolicy_batched``, ``train --num_envs N``,
``tools.train_walk_offpolicy``, ``tools.train_offpolicy_cartpole``) and
the sequential ``train --num_envs 1`` then ``run``; and the greedy
evaluation of a checkpoint, the committed walker's copy in
``resources/walker_r5e_s42`` among them (``tools.eval_walk``). The networks
(``networks``) are PyTorch modules; the sequential-impulse sweeps are
hand-written CUDA kernels (``kernels/csrc``). Still raising, each naming its
ROADMAP item: the other learning agents (A8), the other batched trainers
(A7), robot_jump (A6) and the viewer (A11). Entry points run on ``cuda``
unless the caller passes ``device="cpu"``.
"""

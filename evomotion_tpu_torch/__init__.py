"""PyTorch / CUDA port of evomotion_tpu for NVIDIA Hopper cards.

A second package beside the JAX reference ``evomotion_tpu``; it imports no
JAX and no module of that package. It runs the batched spider
``robot_walk`` and ``robot_jump`` rollouts (``envs.robot``, the batched
physics step); the CLI's sequential ``run`` path (``cli``: cartpole,
cartpole3d, robot_walk and robot_jump, one world stepped by the per-env
physics step); batched PPO-GAE training through the CLI's ``train
--num_envs N`` (``train.ppo_batched``, ``train.driver.train_batched``) and
``tools.train_walk``; batched A2C and PPO-vanilla training
(``train.onpolicy_step_batched``); the off-policy tier: batched SAC and
CrossQ with a device ring (``train.offpolicy_batched``,
``tools.train_walk_offpolicy``, ``tools.train_offpolicy_cartpole``); the
liquid (LTC) tier: liquid networks (``networks.liquid``), batched liquid
PPO-GAE (``train.ppo_liquid_batched``) and liquid SAC
(``train.offpolicy_batched``); the sequential agents A2C, PPO-vanilla,
PPO-GAE, SAC, CrossQ and the three liquid agents (``agents``, with their
replay buffers in ``buffers.replay``) through ``train --num_envs 1`` then
``run``; and the greedy evaluation of a checkpoint, the committed walker's
copy in ``resources/walker_r5e_s42`` among them (``tools.eval_walk``). The
networks (``networks``) are PyTorch modules; the sequential-impulse sweeps
are hand-written CUDA kernels (``kernels/csrc``). Still raising, naming
its ROADMAP item: the viewer (A11). Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``.
"""

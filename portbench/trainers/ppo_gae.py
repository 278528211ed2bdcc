from .ppo import NUMBERS, Adapter  # noqa: F401  (the batched PPO-GAE trainer, MLP networks)

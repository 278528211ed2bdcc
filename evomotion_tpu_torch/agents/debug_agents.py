"""Debug agents: random and constant, no learning (port of
``evomotion_tpu/agents/debug_agents.py``).

Reference: evo_motion_networks/src/agents/debug_agents.cpp. RandomAgent
returns uniform [-1, 1] actions, here from a seeded ``torch.Generator`` on
the device of the state it is given; ConstantAgent a fixed value. Both do
nothing on done/save/load and report no metrics.
"""

from __future__ import annotations

import torch

from .base import Agent


class DebugAgent(Agent):
    def __init__(self, action_space: int):
        self.action_space = action_space

    def done(self, state, reward):
        pass

    def save(self, output_folder_path):
        pass

    def load(self, input_folder_path):
        pass

    def get_metrics(self):
        return []

    def set_eval(self, eval_mode):
        pass

    def count_parameters(self):
        return 0


class RandomAgent(DebugAgent):
    def __init__(self, action_space: int, seed: int = 0):
        super().__init__(action_space)
        self.seed = seed
        self._gen = None

    def act(self, state, reward):
        if self._gen is None or self._gen.device != state.device:
            self._gen = torch.Generator(device=state.device).manual_seed(self.seed)
        u = torch.rand((state.shape[0], self.action_space), generator=self._gen,
                       device=state.device)
        return 2.0 * u - 1.0


class ConstantAgent(DebugAgent):
    def __init__(self, action_space: int, action_value: float):
        super().__init__(action_space)
        self.action_value = action_value

    def act(self, state, reward):
        return torch.full((state.shape[0], self.action_space), self.action_value,
                          device=state.device)

"""Agent interface of the sequential tier (port of ``evomotion_tpu/agents/base.py``).

Reference: evo_motion_networks/include/evo_motion_networks/agent.h:16-36.
``act(state, reward) -> action`` and ``done(state, reward)`` carry the
reference's one-step-late reward bookkeeping. States and actions are batch
first, as the port's envs give and take them: the sequential tier is a batch
of one (``state [1, obs]`` -> ``action [1, act]``).
"""

from __future__ import annotations

import abc

import torch


class Agent(abc.ABC):
    @abc.abstractmethod
    def act(self, state: torch.Tensor, reward: float) -> torch.Tensor: ...

    @abc.abstractmethod
    def done(self, state: torch.Tensor, reward: float) -> None: ...

    @abc.abstractmethod
    def save(self, output_folder_path: str) -> None: ...

    @abc.abstractmethod
    def load(self, input_folder_path: str) -> None: ...

    @abc.abstractmethod
    def get_metrics(self) -> list: ...

    @abc.abstractmethod
    def set_eval(self, eval_mode: bool) -> None: ...

    @abc.abstractmethod
    def count_parameters(self) -> int: ...

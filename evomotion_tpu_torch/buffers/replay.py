"""Replay buffers of the sequential (single-env) agent tier (port of
``evomotion_tpu/buffers/replay.py``, the port's own copy).

Reference: evo_motion_networks/{include/evo_motion_networks/replay_buffer.h,
src/replay_buffer.cpp}. Semantics preserved exactly:

- step buffers: FIFO eviction beyond ``size``; shuffled sampling that
  EXCLUDES the newest element (replay_buffer.cpp:17-27 builds indices over
  size-1); ``update_last`` patches the last entry: the env's reward and
  next state for an action arrive one step late, so ``act()`` stores a
  placeholder which the next ``act()``/``done()`` completes;
- trajectory buffers: a list of episodes with FIFO eviction,
  ``new_trajectory``, sampling only over episodes with > 1 step and
  excluding the last such episode (indices over filtered size-1,
  replay_buffer.cpp:79-91); ``has_enough``/``enough_trajectory`` thresholds
  match.

Items hold tensors (or anything else); the buffers only order them. The
shuffles come from ``np.random.default_rng(seed).permutation``, as in the
JAX package: a port buffer and a JAX buffer with the same seed, fed the
same ``add``/``update_last`` sequence, sample the same indices. The batched
trainers use a preallocated device ring instead (``train/offpolicy_batched``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Generic, TypeVar

import numpy as np

T = TypeVar("T")


@dataclasses.dataclass
class EpisodeStep:
    """episode_step (replay_buffer.h): (s, a, r, done, s')."""

    state: Any
    action: Any
    reward: float
    done: bool
    next_state: Any


@dataclasses.dataclass
class LiquidEpisodeStep:
    step: EpisodeStep
    x_t: dict[str, Any]  # module name -> hidden state at act time


@dataclasses.dataclass
class PpoEpisodeStep:
    """ppo_episode_step: (s, a, r, done, log_prob, value, next_value)."""

    state: Any
    action: Any
    reward: float
    done: bool
    log_prob: Any
    value: Any
    next_value: Any


@dataclasses.dataclass
class LiquidPpoEpisodeStep:
    step: PpoEpisodeStep
    x_t: dict[str, Any]


def _patch_last(last, kwargs) -> None:
    target = last.step if hasattr(last, "step") else last
    for k, v in kwargs.items():
        setattr(target, k, v)


class ReplayBuffer(Generic[T]):
    def __init__(self, size: int, seed: int):
        self.size = size
        self.memory: list[T] = []
        self.rng = np.random.default_rng(seed)

    def add(self, item: T) -> None:
        self.memory.append(item)
        while len(self.memory) > self.size:
            self.memory.pop(0)

    def update_last(self, **kwargs) -> None:
        _patch_last(self.memory[-1], kwargs)

    def empty(self) -> bool:
        return not self.memory

    def has_enough(self, batch_size: int) -> bool:
        return len(self.memory) - 1 >= batch_size

    def sample(self, batch_size: int) -> list[T]:
        """Shuffled sample excluding the newest element (its reward and next
        state are placeholders until the next act/done patches them)."""
        index = self.rng.permutation(len(self.memory) - 1)
        return [self.memory[i] for i in index[:batch_size]]


class TrajectoryReplayBuffer(Generic[T]):
    def __init__(self, size: int, seed: int):
        self.size = size
        self.memory: list[list[T]] = []
        self.rng = np.random.default_rng(seed)

    def new_trajectory(self) -> None:
        self.memory.append([])
        while len(self.memory) > self.size:
            self.memory.pop(0)

    def add(self, step: T) -> None:
        self.memory[-1].append(step)

    def update_last(self, **kwargs) -> None:
        _patch_last(self.memory[-1][-1], kwargs)

    def empty(self) -> bool:
        return not self.memory

    def trajectory_empty(self) -> bool:
        return self.empty() or not self.memory[-1]

    def _filtered(self) -> list[list[T]]:
        return [t for t in self.memory if len(t) > 1]

    def enough_trajectory(self, batch_size: int) -> bool:
        return len(self._filtered()) >= batch_size

    def sample(self, batch_size: int) -> list[list[T]]:
        filtered = self._filtered()
        index = self.rng.permutation(len(filtered) - 1)
        return [filtered[i] for i in index[:batch_size]]

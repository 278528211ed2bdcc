"""A cell cut to a size the CPU runs in seconds, for the benchmark's tests."""

from __future__ import annotations

import contextlib
import time

import torch

from portbench import harness


# every width or size key an agent family's parameters may have, and its
# tiny value: each that a configuration has is cut
TINY = {"hidden_size": 16, "critic_hidden_size": 16, "neuron_number": 8,
        "unfolding_steps": 3, "replay_buffer_size": 1024}


def tiny_cell(name: str, envs: int = 3, horizon: int = 3) -> harness.Cell:
    """``name``'s cell with one settle frame per reset loop, one solver
    iteration, small networks (:data:`TINY`), two epochs and ``envs`` envs."""
    cell = harness.Cell(name)
    cell.config["env_parameters"]["reset_frames"] = 1
    cell.config["physics"]["n_iterations"] = 1
    cell.config["sweep"]["n_iterations"] = 1
    a = cell.config["agent_parameters"]
    a.update(horizon=horizon, epoch=2)
    a.update({k: v for k, v in TINY.items() if k in a})
    cell.traffic["num_envs"] = envs
    return cell


@contextlib.contextmanager
def small_program():
    """The program's robot_walk built as :func:`tiny_cell` states it."""
    from evomotion_tpu_torch.tools.rehearsal import small_walker

    with small_walker():
        yield


def measure(cell: harness.Cell, seed: int = 2**31 + 7, trace: bool = False):
    """One run of ``cell`` on the CPU: (run, readings)."""
    with small_program():
        return harness.measure(cell, seed, 0.01, trace, torch.device("cpu"),
                               time.perf_counter(), log=lambda _msg: None)

"""PPO-GAE with MLP networks: two hidden layers of ``hidden_size``; the
actor has two heads of ``act`` (mean and scale), the critic one of 1."""

from __future__ import annotations

from . import _ppo


def layers(config: dict, obs: int, act: int):
    """(actor, critic) as lists of ``(in, out, reads_obs, repeats)``."""
    h = config["agent_parameters"]["hidden_size"]
    body = [(obs, h, True, 1), (h, h, False, 1)]
    return body + [(h, act, False, 1)] * 2, body + [(h, 1, False, 1)]


def iteration_flops(config: dict, obs: int, act: int, num_envs: int) -> dict:
    return _ppo.iteration_flops(*layers(config, obs, act), config, num_envs)

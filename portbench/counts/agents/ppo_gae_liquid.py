"""PPO-GAE with liquid (LTC) networks: ``neuron_number`` neurons, the
recurrent product unfolded ``unfolding_steps`` times; the actor has two
heads of ``act``, the critic one of 1."""

from __future__ import annotations

from . import _ppo


def layers(config: dict, obs: int, act: int):
    """(actor, critic) as lists of ``(in, out, reads_obs, repeats)``."""
    a = config["agent_parameters"]
    n, k = a["neuron_number"], a["unfolding_steps"]
    # the first unfolding step reads the stored hidden state: no input gradient
    cell = [(obs, n, True, 1), (n, n, True, 1), (n, n, False, k - 1)]
    return cell + [(n, act, False, 1)] * 2, cell + [(n, 1, False, 1)]


def iteration_flops(config: dict, obs: int, act: int, num_envs: int) -> dict:
    return _ppo.iteration_flops(*layers(config, obs, act), config, num_envs)

"""Float32 operations of the networks in one PPO-GAE training iteration,
from the layer widths: the matrix products only (elementwise work, the
loss and Adam are left out, so a share of the peak built on these counts
is a floor).

A product of an ``[M, i]`` input with an ``[i, o]`` weight costs ``2 M i o``
forward; backward costs ``2 M i o`` for the weight's gradient and as much
again for the input's, except where the input is the observation.
"""

from __future__ import annotations


def _layers(config: dict, obs: int, act: int):
    """(actor, critic) as lists of ``(in, out, reads_obs, repeats)``."""
    a = config["agent_parameters"]
    if config["agent"] == "ppo_gae":
        h = a["hidden_size"]
        body = [(obs, h, True, 1), (h, h, False, 1)]
        return body + [(h, act, False, 1)] * 2, body + [(h, 1, False, 1)]
    if config["agent"] == "ppo_gae_liquid":
        n, k = a["neuron_number"], a["unfolding_steps"]
        # the first unfolding step reads the stored hidden state: no input gradient
        cell = [(obs, n, True, 1), (n, n, True, 1), (n, n, False, k - 1)]
        return cell + [(n, act, False, 1)] * 2, cell + [(n, 1, False, 1)]
    raise ValueError(f"no network counts for {config['agent']}")


def _fwd(layers) -> int:
    return sum(2 * i * o * r for i, o, _, r in layers)


def _bwd(layers) -> int:
    return sum(2 * i * o * r * (1 if reads_obs else 2) for i, o, reads_obs, r in layers)


def iteration_flops(config: dict, obs: int, act: int, num_envs: int) -> dict:
    """``{"rollout", "update"}`` operations of one iteration: the actor and
    critic forward passes of every rollout step, then the bootstrap value and
    ``epoch`` full-batch forward and backward passes of both networks."""
    a = config["agent_parameters"]
    actor, critic = _layers(config, obs, act)
    samples = a["horizon"] * num_envs
    rollout = samples * (_fwd(actor) + _fwd(critic))
    update = num_envs * _fwd(critic) + a["epoch"] * samples * (
        _fwd(actor) + _bwd(actor) + _fwd(critic) + _bwd(critic))
    return {"rollout": float(rollout), "update": float(update)}

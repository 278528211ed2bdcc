"""Float32 operations of the networks in one training iteration, by agent
family: ``counts/agents/<agent>.py``, found by the configuration's
``agent``, gives ``iteration_flops(config, obs, act, num_envs) ->
{"rollout", "update"}``. The matrix products only (elementwise work, the
loss and the optimizer are left out, so a share of the peak built on these
counts is a floor).

A product of an ``[M, i]`` input with an ``[i, o]`` weight costs ``2 M i o``
forward; backward costs ``2 M i o`` for the weight's gradient and as much
again for the input's, except where the input is the observation. A family
module describes its networks as lists of ``(in, out, reads_obs, repeats)``
and sums them with :func:`fwd` and :func:`bwd`.
"""

from __future__ import annotations

import importlib


def fwd(layers) -> int:
    return sum(2 * i * o * r for i, o, _, r in layers)


def bwd(layers) -> int:
    return sum(2 * i * o * r * (1 if reads_obs else 2) for i, o, reads_obs, r in layers)


def iteration_flops(config: dict, obs: int, act: int, num_envs: int) -> dict:
    """``{"rollout", "update"}`` operations of one iteration of the
    configuration's agent family."""
    family = importlib.import_module(f"{__package__}.agents.{config['agent']}")
    return family.iteration_flops(config, obs, act, num_envs)

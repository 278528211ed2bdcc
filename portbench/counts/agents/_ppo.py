"""The PPO-GAE iteration's network operations, shared by the MLP and the
liquid families: the actor and critic forward passes of every rollout step,
then the bootstrap value and ``epoch`` full-batch forward and backward
passes of both networks."""

from __future__ import annotations

from ..networks import bwd, fwd


def iteration_flops(actor, critic, config: dict, num_envs: int) -> dict:
    """``{"rollout", "update"}`` of the networks ``actor`` and ``critic``
    (lists of ``(in, out, reads_obs, repeats)``)."""
    a = config["agent_parameters"]
    samples = a["horizon"] * num_envs
    rollout = samples * (fwd(actor) + fwd(critic))
    update = num_envs * fwd(critic) + a["epoch"] * samples * (
        fwd(actor) + bwd(actor) + fwd(critic) + bwd(critic))
    return {"rollout": float(rollout), "update": float(update)}

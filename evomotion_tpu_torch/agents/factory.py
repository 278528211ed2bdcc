"""Agent registry: string name -> factory with strict hyper-parameters
(port of ``evomotion_tpu/agents/factory.py``).

Reference: evo_motion_networks/src/agent_factory.cpp. Agent parameters have
NO defaults: a missing key raises ValueError (agent_factory.cpp:26-30 throws
std::invalid_argument). Registry names match AGENT_FACTORY_CONSTRUCTORS
(:189-206). The debug agents are ported; the learning agents are listed and
their sequential agents raise NotImplementedError naming their ROADMAP item
(A8). ``ppo_gae`` trains on the batched tier without an agent object (the
CLI's ``train --num_envs N``, ``train.driver.train_batched``).
"""

from __future__ import annotations

from .base import Agent
from .debug_agents import ConstantAgent, RandomAgent


class AgentFactory:
    def __init__(self, parameters: dict[str, str]):
        self.parameters = parameters

    def get_float(self, key: str) -> float:
        return float(self._raw(key))

    def _raw(self, key: str) -> str:
        if key not in self.parameters:
            raise ValueError(key)
        return self.parameters[key]

    def create_agent(self, state_space: int, action_space: int) -> Agent:
        raise NotImplementedError


class RandomAgentFactory(AgentFactory):
    def create_agent(self, state_space, action_space):
        return RandomAgent(action_space)


class ConstantAgentFactory(AgentFactory):
    def create_agent(self, state_space, action_space):
        return ConstantAgent(action_space, self.get_float("action_value"))


def _not_ported(name: str, item: str):
    class _Factory(AgentFactory):
        def create_agent(self, state_space, action_space):
            raise NotImplementedError(f"agent {name!r} is not ported yet (ROADMAP {item})")

    _Factory.__name__ = f"NotPorted_{name}"
    return _Factory


# the networks, the truncated normal, checkpoints and the batched PPO-GAE
# trainer are ported; the sequential learning agents (act/done/save/load,
# the CLI's `train --num_envs 1` and `run` of a trained agent) are ROADMAP A8
AGENT_FACTORY_CONSTRUCTORS = {
    "random": RandomAgentFactory,
    "constant": ConstantAgentFactory,
    "actor_critic": _not_ported("actor_critic", "A8"),
    "actor_critic_liquid": _not_ported("actor_critic_liquid", "A8"),
    "soft_actor_critic": _not_ported("soft_actor_critic", "A8"),
    "soft_actor_critic_liquid": _not_ported("soft_actor_critic_liquid", "A8"),
    "ppo_gae": _not_ported("ppo_gae", "A8"),
    "ppo_gae_liquid": _not_ported("ppo_gae_liquid", "A8"),
    "ppo_vanilla": _not_ported("ppo_vanilla", "A8"),
    "cross_q": _not_ported("cross_q", "A8"),
}


def get_agent_factory(agent_name: str, parameters: dict[str, str]) -> AgentFactory:
    if agent_name not in AGENT_FACTORY_CONSTRUCTORS:
        raise ValueError(agent_name)
    return AGENT_FACTORY_CONSTRUCTORS[agent_name](parameters)

"""Agent registry: string name -> factory with strict hyper-parameters
(port of ``evomotion_tpu/agents/factory.py``).

Reference: evo_motion_networks/src/agent_factory.cpp. Agent parameters have
NO defaults: a missing key raises ValueError (agent_factory.cpp:26-30 throws
std::invalid_argument). Registry names match AGENT_FACTORY_CONSTRUCTORS
(:189-206). Ported: the debug agents, the on-policy agents
``actor_critic``, ``ppo_vanilla`` and ``ppo_gae``, the off-policy agents
``soft_actor_critic`` and ``cross_q``, and the liquid agents
``actor_critic_liquid``, ``ppo_gae_liquid`` and ``soft_actor_critic_liquid``
(every one the JAX package has). ``create_agent`` builds the agent on
``device`` (default ``cuda``).
"""

from __future__ import annotations

from .actor_critic import ActorCriticAgent
from .base import Agent
from .cross_q import CrossQAgent
from .debug_agents import ConstantAgent, RandomAgent
from .liquid_agents import ActorCriticLiquidAgent, PpoGaeLiquidAgent, SoftActorCriticLiquidAgent
from .ppo_gae import PpoGaeAgent
from .ppo_vanilla import PpoVanillaAgent
from .soft_actor_critic import SoftActorCriticAgent


class AgentFactory:
    def __init__(self, parameters: dict[str, str]):
        self.parameters = parameters

    def get_int(self, key: str) -> int:
        return int(self._raw(key))

    def get_float(self, key: str) -> float:
        return float(self._raw(key))

    def get_bool(self, key: str) -> bool:
        raw = self._raw(key)
        if raw in ("true", "false"):
            return raw == "true"
        raise ValueError(raw)

    def get_str(self, key: str) -> str:
        return self._raw(key)

    def _raw(self, key: str) -> str:
        if key not in self.parameters:
            raise ValueError(key)
        return self.parameters[key]

    def create_agent(self, state_space: int, action_space: int, device=None) -> Agent:
        raise NotImplementedError


class RandomAgentFactory(AgentFactory):
    def create_agent(self, state_space, action_space, device=None):
        return RandomAgent(action_space)


class ConstantAgentFactory(AgentFactory):
    def create_agent(self, state_space, action_space, device=None):
        return ConstantAgent(action_space, self.get_float("action_value"))


class ActorCriticFactory(AgentFactory):
    def create_agent(self, state_space, action_space, device=None):
        return ActorCriticAgent(
            self.get_int("seed"), state_space, action_space, self.get_int("hidden_size"),
            self.get_int("batch_size"), self.get_float("lr"), self.get_float("gamma"),
            self.get_float("entropy_start_factor"), self.get_float("entropy_end_factor"),
            self.get_int("entropy_steps"), self.get_int("replay_buffer_size"),
            self.get_int("train_every"), device=device,
        )


class ActorCriticLiquidFactory(AgentFactory):
    def create_agent(self, state_space, action_space, device=None):
        return ActorCriticLiquidAgent(
            self.get_int("seed"), state_space, action_space, self.get_int("neuron_number"),
            self.get_int("batch_size"), self.get_float("lr"), self.get_float("gamma"),
            self.get_float("entropy_start_factor"), self.get_float("entropy_end_factor"),
            self.get_int("entropy_steps"), self.get_int("unfolding_steps"),
            self.get_int("replay_buffer_size"), self.get_int("train_every"), device=device,
        )


class SoftActorCriticFactory(AgentFactory):
    def create_agent(self, state_space, action_space, device=None):
        return SoftActorCriticAgent(
            self.get_int("seed"), state_space, action_space,
            self.get_int("actor_hidden_size"), self.get_int("critic_hidden_size"),
            self.get_int("batch_size"), self.get_int("epoch"),
            self.get_float("learning_rate"), self.get_float("gamma"), self.get_float("tau"),
            self.get_int("replay_buffer_size"), self.get_int("train_every"), device=device,
        )


class SoftActorCriticLiquidFactory(AgentFactory):
    def create_agent(self, state_space, action_space, device=None):
        return SoftActorCriticLiquidAgent(
            self.get_int("seed"), state_space, action_space, self.get_int("neuron_number"),
            self.get_int("batch_size"), self.get_int("epoch"),
            self.get_float("learning_rate"), self.get_float("gamma"), self.get_float("tau"),
            self.get_int("unfolding_steps"), self.get_int("replay_buffer_size"),
            self.get_int("train_every"), device=device,
        )


class PpoGaeFactory(AgentFactory):
    def create_agent(self, state_space, action_space, device=None):
        return PpoGaeAgent(
            self.get_int("seed"), state_space, action_space, self.get_int("hidden_size"),
            self.get_float("gamma"), self.get_float("lambda"), self.get_float("epsilon"),
            self.get_float("entropy_factor"), self.get_float("critic_loss_factor"),
            self.get_int("epoch"), self.get_int("batch_size"), self.get_int("train_every"),
            self.get_int("replay_buffer_size"), self.get_float("learning_rate"),
            self.get_float("clip_grad_norm"), device=device,
        )


class PpoGaeLiquidFactory(AgentFactory):
    def create_agent(self, state_space, action_space, device=None):
        return PpoGaeLiquidAgent(
            self.get_int("seed"), state_space, action_space, self.get_int("neuron_number"),
            self.get_int("unfolding_steps"), self.get_float("gamma"), self.get_float("lambda"),
            self.get_float("epsilon"), self.get_float("entropy_factor"),
            self.get_float("critic_loss_factor"), self.get_int("epoch"),
            self.get_int("batch_size"), self.get_int("train_every"),
            self.get_int("replay_buffer_size"), self.get_float("learning_rate"),
            self.get_float("clip_grad_norm"), device=device,
        )


class PpoVanillaFactory(AgentFactory):
    def create_agent(self, state_space, action_space, device=None):
        return PpoVanillaAgent(
            self.get_int("seed"), state_space, action_space, self.get_int("hidden_size"),
            self.get_float("gamma"), self.get_float("epsilon"),
            self.get_float("entropy_factor"), self.get_float("critic_loss_factor"),
            self.get_int("epoch"), self.get_int("batch_size"), self.get_float("learning_rate"),
            device=device,
        )


class CrossQFactory(AgentFactory):
    def create_agent(self, state_space, action_space, device=None):
        return CrossQAgent(
            self.get_int("seed"), state_space, action_space,
            self.get_int("actor_hidden_size"), self.get_int("critic_hidden_size"),
            self.get_int("batch_size"), self.get_int("epoch"),
            self.get_float("learning_rate"), self.get_float("gamma"),
            self.get_int("replay_buffer_size"), self.get_int("train_every"), device=device,
        )


AGENT_FACTORY_CONSTRUCTORS = {
    "random": RandomAgentFactory,
    "constant": ConstantAgentFactory,
    "actor_critic": ActorCriticFactory,
    "actor_critic_liquid": ActorCriticLiquidFactory,
    "soft_actor_critic": SoftActorCriticFactory,
    "soft_actor_critic_liquid": SoftActorCriticLiquidFactory,
    "ppo_gae": PpoGaeFactory,
    "ppo_gae_liquid": PpoGaeLiquidFactory,
    "ppo_vanilla": PpoVanillaFactory,
    "cross_q": CrossQFactory,
}


def get_agent_factory(agent_name: str, parameters: dict[str, str]) -> AgentFactory:
    if agent_name not in AGENT_FACTORY_CONSTRUCTORS:
        raise ValueError(agent_name)
    return AGENT_FACTORY_CONSTRUCTORS[agent_name](parameters)

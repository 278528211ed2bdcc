"""Environment registry: string name -> factory.

Mirrors ENV_FACTORY_CONSTRUCTORS + get_environment_factory
(env_factory.cpp:108-120): unknown names raise ValueError (the reference
throws std::invalid_argument).
"""

from __future__ import annotations

from .cartpole import CartPoleFactory
from .cartpole3d import CartPole3dFactory
from .robot import RobotJumpFactory, RobotWalkFactory

ENV_FACTORY_CONSTRUCTORS = {
    "cartpole": CartPoleFactory,
    "cartpole3d": CartPole3dFactory,
    "robot_walk": RobotWalkFactory,
    "robot_jump": RobotJumpFactory,
}


def get_environment_factory(env_name: str, parameters: dict[str, str]):
    if env_name not in ENV_FACTORY_CONSTRUCTORS:
        raise ValueError(env_name)
    return ENV_FACTORY_CONSTRUCTORS[env_name](parameters)

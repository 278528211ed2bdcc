"""2D CartPole in PyTorch, batch first (port of ``evomotion_tpu/envs/cartpole.py``).

Reference: evo_motion_model/src/env/cartpole.{h,cpp}. Scene: static base box
(10,2,10) at (0,-4,10); chariot (0.5,0.25,0.5) mass 1 on a powered slider
(force 64, limits +-10, x axis); pendulum (0.1,0.7,0.1) mass 1 on a free
z-axis hinge. All inter-body collisions ignored (cartpole.cpp:85-87): the
scene is contact-free, so the per-env step makes one sweep per physics step.

Observation (7, cartpole.cpp:108-111):
  [|x|/10, x/10, vx, vx - last_vx, angle/(2pi) - 1, wz, wz - last_wz]
  with angle = btQuaternion::getAngle of the pendulum (2*acos(w), >= 0).
Reward (cartpole.cpp:116-117): uprightness + centering, overridden to -2 on
fail / +2 on win. Fail: |x| > 10 or angle outside +-limit_angle; win:
step_idx > max_steps. Reset (cartpole.cpp:127-180): teleport, zero velocities,
unpower the motor, apply a random central impulse U(-push, push) to the
chariot, settle reset_frame_nb frames, re-power. In ``step`` a finished
episode teleports and then settles one physics step per env step
(``valid=False``).

Resets draw from the reference's std::mt19937 stream with ``mt_seed``, else
from the ``torch.Generator`` passed to reset/step.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from ..device import resolve
from ..physics import maths
from ..physics.engine import PhysicsState, default_solver, init_state
from ..physics.model import ModelBuilder
from ..physics.batched import BatchedStep
from ..physics.perenv import PerEnvStep
from ..physics.shapes import get_shape
from .base import StepResult, draws, get_value, where

DT = 1.0 / 60.0  # DELTA_T_MODEL (src/constants.h.in:9)


@dataclasses.dataclass(frozen=True)
class CartPoleParams:
    """Defaults from CartPoleFactory (env_factory.cpp:49-58). The max-steps
    key is spelled ``mas_steps`` in the reference, kept in the factory."""

    slider_speed: float = 16.0
    slider_force: float = 64.0
    chariot_push_force: float = 2.0
    limit_angle: float = math.pi * 0.5
    reset_frame_nb: int = 8
    chariot_mass: float = 1.0
    pendulum_mass: float = 1.0
    max_steps: int = 60 * 60


class CartPoleState(NamedTuple):
    """Batch of cartpole states, env axis first."""

    physics: PhysicsState
    reset_idx: torch.Tensor  # [B] int32: resets consumed (mt19937 table cursor)
    step_idx: torch.Tensor  # [B] int32
    last_vel: torch.Tensor  # [B] f32
    last_ang_vel: torch.Tensor  # [B] f32
    motor_target: torch.Tensor  # [B, 1] (kept for state parity; never updated)
    settle_left: torch.Tensor  # [B] int32; > 0 while settling (motor off)


class CartPole:
    """CartPole on the port's per-env physics step (fat rows, the fat-row sweep
    kernel once per physics step: the scene has no contact pairs), or with
    ``per_env_step=False`` on the batched step (slim env-last rows, the slim
    sweep kernel), which the JAX package's ``vmap(env.step)`` reaches through
    its custom_vmap rule. The sequential tier is a batch of one; a batch of B
    steps each world alike."""

    observation_size = 7
    action_size = 1

    def __init__(self, params: CartPoleParams = CartPoleParams(), mt_seed: int | None = None,
                 device=None, per_env_step: bool = True):
        self.params = params
        self.device = resolve(device)
        dev = self.device
        self._mt_table = None
        if mt_seed is not None:
            from ..utils.mt19937 import reset_draw_table

            # strict reset parity: the reference's per-env std::mt19937 draw
            # (cartpole.cpp:15,171)
            self._mt_table = torch.as_tensor(reset_draw_table(mt_seed, 1), device=dev)
        base_height, base_pos = 2.0, -4.0
        pendulum_height, pendulum_width = 0.7, 0.1
        pendulum_offset = pendulum_height / 4.0
        chariot_height, chariot_width = 0.25, 0.5
        self.chariot_pos = base_pos + base_height + chariot_height
        self.pendulum_pos = self.chariot_pos + chariot_height + pendulum_height - pendulum_offset

        b = ModelBuilder()
        cube = get_shape("cube").hull_verts
        ident = (0.0, 0.0, 0.0, 1.0)
        self.base = b.add_body("base", cube, (10, base_height, 10), 0.0, (0, base_pos, 10), ident)
        self.chariot = b.add_body(
            "chariot", cube, (chariot_width, chariot_height, chariot_width),
            params.chariot_mass, (0, self.chariot_pos, 10), ident,
        )
        self.pendulum = b.add_body(
            "pendulum", cube, (pendulum_width, pendulum_height, pendulum_width),
            params.pendulum_mass, (0, self.pendulum_pos, 10), ident,
        )
        # cartpole.cpp:85-87: every pair ignores collision
        b.set_ignore_collision(self.base, self.chariot)
        b.set_ignore_collision(self.chariot, self.pendulum)
        b.set_ignore_collision(self.base, self.pendulum)
        self.slider = b.add_slider(
            self.base, self.chariot,
            (0, base_height, 0), ident, (0, -chariot_height, 0), ident,
            lin_lo=-10.0, lin_hi=10.0, max_motor_force=params.slider_force, motor_index=0,
        )
        b.add_hinge(
            self.chariot, self.pendulum,
            (0, chariot_height, 0), (0, -pendulum_height + pendulum_offset, 0),
            (0, 0, 1), (0, 0, 1),
        )
        self.model = dataclasses.replace(b.finalize(), solver=default_solver())
        self.physics_step = (PerEnvStep if per_env_step else BatchedStep)(self.model, DT, dev)
        self._spawn_pos = torch.tensor(
            [[0.0, self.chariot_pos, 10.0], [0.0, self.pendulum_pos, 10.0]], device=dev)
        self._ident = torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev)
        self._movers = torch.tensor([self.chariot, self.pendulum], device=dev)

    # --- internals ---

    def _obs(self, physics: PhysicsState, last_vel, last_ang_vel):
        x = physics.pos[:, self.chariot, 0]
        base_x = physics.pos[:, self.base, 0]
        center_distance = torch.abs(x - base_x)
        vel = physics.lin_vel[:, self.chariot, 0]
        ang = maths.quat_angle(physics.quat[:, self.pendulum])
        ang_vel = physics.ang_vel[:, self.pendulum, 2]
        obs = torch.stack(
            [
                center_distance / 10.0,
                (x - base_x) / 10.0,
                vel,
                vel - last_vel,
                ang / (2.0 * math.pi) - 1.0,
                ang_vel,
                ang_vel - last_ang_vel,
            ],
            -1,
        )
        return obs, center_distance, vel, ang, ang_vel

    def _phys_step(self, physics, target, powered):
        """target [B, 1]; powered [B] bool."""
        return self.physics_step(physics, target, powered[:, None])

    def _teleported(self, physics: PhysicsState, u):
        """Chariot and pendulum back to spawn at rest, then the random chariot
        impulse rand_force = u * 2 push - push (cartpole.cpp:133-173); u [B, 1]."""
        mv = self._movers
        pos, quat = physics.pos.clone(), physics.quat.clone()
        lin, ang = physics.lin_vel.clone(), physics.ang_vel.clone()
        pos[:, mv] = self._spawn_pos
        quat[:, mv] = self._ident
        lin[:, mv] = 0.0
        ang[:, mv] = 0.0
        push = self.params.chariot_push_force
        rand_force = u[:, 0] * push * 2.0 - push
        # applyCentralImpulse: dv = impulse / mass
        lin[:, self.chariot, 0] += rand_force / self.params.chariot_mass
        return physics._replace(pos=pos, quat=quat, lin_vel=lin, ang_vel=ang)

    def _draws(self, reset_idx, generator):
        return draws(self._mt_table, reset_idx, 1, generator, self.device)

    # --- public API ---

    def reset(self, n_envs: int = 1, generator: torch.Generator | None = None):
        """Blocking reset: teleport + settle reset_frame_nb frames (motor
        off), then the first observation (Environment::reset -> reset_engine
        + compute_step)."""
        dev = self.device
        i32 = dict(dtype=torch.int32, device=dev)
        zero_idx = torch.zeros(n_envs, **i32)
        physics = self._teleported(init_state(self.model, n_envs, dev),
                                   self._draws(zero_idx, generator))
        target = torch.zeros((n_envs, 1), device=dev)
        off = torch.zeros(n_envs, dtype=torch.bool, device=dev)
        for _ in range(self.params.reset_frame_nb):
            physics = self._phys_step(physics, target, off)[0]
        zf = torch.zeros(n_envs, device=dev)
        state = CartPoleState(
            physics=physics, reset_idx=torch.ones(n_envs, **i32), step_idx=zero_idx,
            last_vel=zf, last_ang_vel=zf.clone(), motor_target=target.clone(),
            settle_left=zero_idx.clone(),
        )
        return self._compute_step(state)

    def _compute_step(self, state: CartPoleState):
        """compute_step (cartpole.cpp:101-124), including its counter/flag
        update order: done checked before step_idx increments."""
        p = self.params
        obs, center_distance, vel, ang, ang_vel = self._obs(
            state.physics, state.last_vel, state.last_ang_vel)
        x = state.physics.pos[:, self.chariot, 0]
        fail = (x > 10.0) | (x < -10.0) | (ang > p.limit_angle) | (ang < -p.limit_angle)
        win = state.step_idx > p.max_steps
        done = fail | win
        reward = (p.limit_angle - torch.abs(ang)) / p.limit_angle + (10.0 - center_distance) / 10.0
        reward = torch.where(fail, -2.0, torch.where(win, 2.0, reward))
        state = state._replace(step_idx=state.step_idx + 1, last_vel=vel, last_ang_vel=ang_vel)
        return state, StepResult(obs, reward, done, torch.ones_like(done), win)

    def step(self, state: CartPoleState, action, generator: torch.Generator | None = None):
        """One env step for every env (action [B, 1] in [-1, 1]) with the
        non-blocking auto-reset (see base.py)."""
        p = self.params
        settling = state.settle_left > 0
        target = torch.where(settling[:, None], 0.0, action * p.slider_speed)
        physics, _ = self._phys_step(state.physics, target, ~settling)
        state = state._replace(physics=physics)

        # settling branch: count down; invalid transition
        settle_state = state._replace(settle_left=state.settle_left - 1)
        false = torch.zeros_like(settling)
        settle_res = StepResult(
            obs=self._obs(physics, state.last_vel, state.last_ang_vel)[0],
            reward=torch.zeros_like(state.last_vel), done=false, valid=false, win=false,
        )
        # the step after settling completes emits the episode's first obs
        finishing = settling & (state.settle_left <= 1)
        fin_state, fin_res = self._compute_step(settle_state)
        fin_res = fin_res._replace(done=false, valid=~false, win=false)

        # running branch; on done: teleport and enter settling
        run_state, run_res = self._compute_step(state)
        done_state = run_state._replace(
            physics=self._teleported(run_state.physics,
                                     self._draws(run_state.reset_idx, generator)),
            reset_idx=run_state.reset_idx + 1,
            step_idx=torch.zeros_like(run_state.step_idx),
            settle_left=torch.full_like(run_state.settle_left, p.reset_frame_nb),
        )
        run_state = where(run_res.done, done_state, run_state)
        out_state = where(settling, where(finishing, fin_state, settle_state), run_state)
        out_res = where(settling, where(finishing, fin_res, settle_res), run_res)
        return out_state, out_res


class CartPoleFactory:
    """Registry factory (env_factory.cpp:49-58)."""

    name = "cartpole"

    def __init__(self, parameters: dict[str, str]):
        self.parameters = parameters

    def make(self, seed: int = 1234, mt_parity: bool = True, device=None,
             per_env_step: bool = True) -> CartPole:
        """The sequential tier's env (reset with one world) by default; the
        batched trainers pass ``per_env_step=False`` for the batched step."""
        g = lambda k, d: get_value(self.parameters, k, d)  # noqa: E731
        return CartPole(
            CartPoleParams(
                slider_speed=g("slider_speed", 16.0),
                slider_force=g("slider_force", 64.0),
                chariot_push_force=g("chariot_push_force", 2.0),
                limit_angle=g("limit_angle", math.pi * 0.5),
                reset_frame_nb=g("reset_frame_nb", 8),
                chariot_mass=g("chariot_mass", 1.0),
                pendulum_mass=g("pendulum_mass", 1.0),
                # reference key is the typo'd "mas_steps" (env_factory.cpp:56)
                max_steps=g("mas_steps", 60 * 60),
            ),
            mt_seed=seed if mt_parity else None, device=device, per_env_step=per_env_step,
        )

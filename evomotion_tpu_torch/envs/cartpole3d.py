"""3D CartPole in PyTorch, batch first (port of ``evomotion_tpu/envs/cartpole3d.py``).

Reference: evo_motion_model/src/env/cartpole3d.{h,cpp}. Scene: static base
(10,1,10) at (0,-4,10); cart_x (0.5,0.125,0.5) on an x-axis slider from the
base; cart_z (0.5,0.125,0.5) on a z-axis slider from cart_x (frames rotated
pi/2 about Y, cartpole3d.cpp:88-95); a cylinder pole attached to cart_z by a
point2point constraint only. All collisions ignored: one sweep per physics
step on the per-env path. Motor forces scale with carried mass
(slider_force_per_kg * downstream mass, cartpole3d.cpp:72,100).

Observation (28, cartpole3d.cpp:189-218) replicated with the reference's
quirks: vertical_ang / plan_ang divide by the SUM of vector norms, several
"velocity" features are per-step deltas of derived angles. Reward
(cartpole3d.cpp:225-227): squared shaping, -2 fail / +2 win. Reset
(cartpole3d.cpp:246-323): teleport, random planar impulse (angle U(0,2pi),
magnitude U(0,push)) on cart_z, settle with motors off.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve
from ..physics import maths
from ..physics.engine import PhysicsState, default_solver, init_state
from ..physics.model import ModelBuilder
from ..physics.batched import BatchedStep
from ..physics.perenv import PerEnvStep
from ..physics.shapes import get_shape
from .base import StepResult, draws, get_value, where

DT = 1.0 / 60.0


@dataclasses.dataclass(frozen=True)
class CartPole3dParams:
    """Defaults from CartPole3dFactory (env_factory.cpp:60-71)."""

    slider_speed: float = 16.0
    slider_force_per_kg: float = 32.0
    chariot_push_force: float = 2.0
    reset_frame_nb: int = 8
    limit_angle: float = math.pi / 2.0
    cart_x_mass: float = 1.0
    cart_z_mass: float = 1.0
    pole_mass: float = 1.0
    max_steps: int = 60 * 60


class CartPole3dState(NamedTuple):
    """Batch of cartpole3d states, env axis first."""

    physics: PhysicsState
    reset_idx: torch.Tensor  # [B] int32: resets consumed (mt19937 table cursor)
    step_idx: torch.Tensor  # [B] int32
    # [B, 10]: vel_x, vel_z, ang, ang_vel, ang_vel_vec (3), vert_ang,
    # vert_ang_vel, plan_ang
    lasts: torch.Tensor
    last_plan_ang_vec: torch.Tensor  # [B]
    settle_left: torch.Tensor  # [B] int32


def _quat_axis(q):
    """btQuaternion::getAxis: xyz / sqrt(1 - w^2), or (1,0,0) near identity."""
    s_sq = 1.0 - q[..., 3] * q[..., 3]
    small = s_sq < 10.0 * 1.192092896e-07
    s = torch.sqrt(torch.clamp(s_sq, min=1e-30))
    axis = q[..., :3] / s[..., None]
    unit_x = torch.tensor([1.0, 0.0, 0.0], device=q.device)
    return torch.where(small[..., None], unit_x, axis)


class CartPole3d:
    """CartPole3d on the port's per-env physics step (fat rows, the fat-row sweep
    kernel once per physics step: the scene has no contact pairs), or with
    ``per_env_step=False`` on the batched step (slim env-last rows, the slim
    sweep kernel), which the JAX package's ``vmap(env.step)`` reaches through
    its custom_vmap rule. The sequential tier is a batch of one; a batch of B
    steps each world alike."""

    observation_size = 28
    action_size = 2

    def __init__(self, params: CartPole3dParams = CartPole3dParams(),
                 mt_seed: int | None = None, device=None, per_env_step: bool = True):
        self.params = params
        self.device = resolve(device)
        dev = self.device
        self._mt_table = None
        if mt_seed is not None:
            from ..utils.mt19937 import reset_draw_table

            # strict reset parity: the reference's per-env std::mt19937 draws
            # (cartpole3d.cpp:22,308-309)
            self._mt_table = torch.as_tensor(reset_draw_table(mt_seed, 2), device=dev)
        base_scale = (10.0, 1.0, 10.0)
        base_pos = (0.0, -4.0, 10.0)
        cart_x_pos = (0.0, -4.0 + 1.0 + 0.125, 10.0)
        cart_z_pos = (0.0, cart_x_pos[1] + 0.125 + 0.125, 10.0)
        pole_pos = (0.0, cart_z_pos[1] + 0.125 + 0.5 - 0.5 / 4.0, 10.0)
        self.base_scale = base_scale
        self.cart_z_pos = cart_z_pos

        b = ModelBuilder()
        cube = get_shape("cube").hull_verts
        cyl = get_shape("cylinder").hull_verts
        ident = (0.0, 0.0, 0.0, 1.0)
        self.base = b.add_body("base", cube, base_scale, 0.0, base_pos, ident)
        self.cart_x = b.add_body("cart_x", cube, (0.5, 0.125, 0.5), params.cart_x_mass,
                                 cart_x_pos, ident)
        self.cart_z = b.add_body("cart_z", cube, (0.5, 0.125, 0.5), params.cart_z_mass,
                                 cart_z_pos, ident)
        self.pole = b.add_body("pole", cyl, (0.1, 0.5, 0.1), params.pole_mass, pole_pos, ident)
        for i in (self.cart_x, self.cart_z, self.pole):
            b.set_ignore_collision(self.base, i)
        b.set_ignore_collision(self.cart_x, self.cart_z)
        b.set_ignore_collision(self.cart_x, self.pole)
        b.set_ignore_collision(self.cart_z, self.pole)

        # x slider: identity frames (axis = +x)
        b.add_slider(
            self.base, self.cart_x, (0, 1.0, 0), ident, (0, -0.125, 0), ident,
            lin_lo=-100.0, lin_hi=100.0,
            max_motor_force=params.slider_force_per_kg
            * (params.cart_x_mass + params.cart_z_mass + params.pole_mass),
            motor_index=0,
        )
        # z slider: frames rotated pi/2 about Y (slide axis -> -z); the f32
        # quaternion of maths.quat_from_axis_angle, as the JAX env builds it
        qy = tuple(float(v) for v in maths.quat_from_axis_angle(
            torch.tensor([0.0, 1.0, 0.0]), torch.tensor(math.pi / 2)))
        b.add_slider(
            self.cart_x, self.cart_z, (0, 0.125, 0), qy, (0, -0.125, 0), qy,
            lin_lo=-100.0, lin_hi=100.0,
            max_motor_force=params.slider_force_per_kg * (params.cart_z_mass + params.pole_mass),
            motor_index=1,
        )
        b.add_p2p(self.cart_z, self.pole, (0, 0.125, 0), (0, -0.5 + 0.5 / 4.0, 0))
        self.model = dataclasses.replace(b.finalize(), solver=default_solver())
        self.physics_step = (PerEnvStep if per_env_step else BatchedStep)(self.model, DT, dev)
        self._movers = torch.tensor([self.cart_x, self.cart_z, self.pole], device=dev)
        self._spawn_pos = torch.tensor(np.array([cart_x_pos, cart_z_pos, pole_pos], np.float32),
                                       device=dev)
        self._ident = torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev)
        self._up = torch.tensor([0.0, 1.0, 0.0], device=dev)

    def _obs(self, physics: PhysicsState, lasts, last_plan_ang_vec):
        (last_vel_x, last_vel_z, last_ang, last_ang_vel, lav0, lav1, lav2, last_vert_ang,
         last_vert_ang_vel, last_plan_ang) = lasts.unbind(-1)
        last_ang_vel_vec = torch.stack([lav0, lav1, lav2], -1)
        pi = math.pi
        bx, bz = self.base_scale[0], self.base_scale[2]
        cz = self.cart_z_pos

        pos = physics.pos[:, self.cart_z]
        vel_x = physics.lin_vel[:, self.cart_z, 0]
        vel_z = physics.lin_vel[:, self.cart_z, 2]
        center_distance = torch.sqrt((cz[0] - pos[:, 0]) ** 2 + (cz[2] - pos[:, 2]) ** 2)
        pos_x = pos[:, 0] - cz[0]
        pos_z = pos[:, 2] - cz[2]

        q = physics.quat[:, self.pole]
        ang_x, ang_y, ang_z = maths.quat_to_euler_zyx(q)  # (yaw, pitch, roll)

        up = self._up
        rotated = maths.quat_rotate(q, up)
        ang = torch.arccos(torch.clamp(
            (rotated * up).sum(-1) / (1.0 * torch.linalg.vector_norm(rotated, dim=-1)), -1.0, 1.0))
        ang_vel = ang - last_ang

        ang_vel_vec = physics.ang_vel[:, self.pole]
        ang_acc_vec = ang_vel_vec - last_ang_vel_vec

        axis = _quat_axis(q)
        # reference divides by the SUM of norms here (cartpole3d.cpp:204-216)
        vertical_ang = torch.arccos(torch.clamp(
            (axis * up).sum(-1) / (torch.linalg.vector_norm(axis, dim=-1) + 1.0), -1.0, 1.0))
        vertical_ang_vel = vertical_ang - last_vert_ang
        axis_plan = torch.stack([axis[:, 0], torch.zeros_like(axis[:, 0]), axis[:, 2]], -1)
        plan_ang = torch.arccos(torch.clamp(
            axis_plan[:, 0] / (torch.linalg.vector_norm(axis_plan, dim=-1) + 1.0), -1.0, 1.0))
        plan_ang_vel = plan_ang - last_plan_ang

        obs = torch.stack(
            [
                center_distance / bx, pos_x / bx, vel_x, vel_x - last_vel_x,
                pos_z / bz, vel_z, vel_z - last_vel_z,
                ang_x / pi, ang_y / pi, ang_z / pi,
                ang / (2.0 * pi) - 1.0, ang_vel, ang_vel - last_ang_vel,
                ang_vel_vec[:, 0], ang_vel_vec[:, 1], ang_vel_vec[:, 2],
                ang_acc_vec[:, 0], ang_acc_vec[:, 1], ang_acc_vec[:, 2],
                axis[:, 0], axis[:, 1], axis[:, 2],
                plan_ang / pi, plan_ang_vel, plan_ang_vel - last_plan_ang_vec,
                vertical_ang / pi, vertical_ang_vel, vertical_ang_vel - last_vert_ang_vel,
            ],
            -1,
        )
        new_lasts = torch.stack(
            [vel_x, vel_z, ang, ang_vel, ang_vel_vec[:, 0], ang_vel_vec[:, 1],
             ang_vel_vec[:, 2], vertical_ang, vertical_ang_vel, plan_ang], -1,
        )
        return obs, center_distance, ang, new_lasts, plan_ang_vel

    def _compute_step(self, state: CartPole3dState):
        p = self.params
        bx = self.base_scale[0]
        obs, center_distance, ang, new_lasts, plan_ang_vel = self._obs(
            state.physics, state.lasts, state.last_plan_ang_vec)
        fail = (center_distance > bx) | (torch.abs(ang) > p.limit_angle)
        win = state.step_idx > p.max_steps
        done = fail | win
        reward = ((p.limit_angle - torch.abs(ang)) / p.limit_angle) ** 2 + (
            (bx - center_distance) / bx) ** 2
        reward = torch.where(fail, -2.0, torch.where(win, 2.0, reward))
        state = state._replace(step_idx=state.step_idx + 1, lasts=new_lasts,
                               last_plan_ang_vec=plan_ang_vel)
        return state, StepResult(obs, reward, done, torch.ones_like(done), win)

    def _teleported(self, physics: PhysicsState, u):
        """Carts and pole back to spawn at rest, then the random planar impulse
        on cart_z: angle u0 * 2pi, magnitude u1 * push; u [B, 2]."""
        mv = self._movers
        pos, quat = physics.pos.clone(), physics.quat.clone()
        lin, ang = physics.lin_vel.clone(), physics.ang_vel.clone()
        pos[:, mv] = self._spawn_pos
        quat[:, mv] = self._ident
        lin[:, mv] = 0.0
        ang[:, mv] = 0.0
        angle = u[:, 0] * 2.0 * math.pi
        force = u[:, 1] * self.params.chariot_push_force
        imp = torch.stack([torch.cos(angle) * force, torch.zeros_like(force),
                           torch.sin(angle) * force], -1)
        lin[:, self.cart_z] += imp / self.params.cart_z_mass
        return physics._replace(pos=pos, quat=quat, lin_vel=lin, ang_vel=ang)

    def _draws(self, reset_idx, generator):
        return draws(self._mt_table, reset_idx, 2, generator, self.device)

    def _phys_step(self, physics, targets, powered):
        """targets [B, 2]; powered [B] bool (both motors)."""
        return self.physics_step(physics, targets, powered[:, None].expand(-1, 2))

    def reset(self, n_envs: int = 1, generator: torch.Generator | None = None):
        dev = self.device
        i32 = dict(dtype=torch.int32, device=dev)
        zero_idx = torch.zeros(n_envs, **i32)
        physics = self._teleported(init_state(self.model, n_envs, dev),
                                   self._draws(zero_idx, generator))
        targets = torch.zeros((n_envs, 2), device=dev)
        off = torch.zeros(n_envs, dtype=torch.bool, device=dev)
        for _ in range(self.params.reset_frame_nb):
            physics = self._phys_step(physics, targets, off)[0]
        state = CartPole3dState(
            physics=physics, reset_idx=torch.ones(n_envs, **i32), step_idx=zero_idx,
            lasts=torch.zeros((n_envs, 10), device=dev),
            last_plan_ang_vec=torch.zeros(n_envs, device=dev), settle_left=zero_idx.clone(),
        )
        return self._compute_step(state)

    def step(self, state: CartPole3dState, action, generator: torch.Generator | None = None):
        """One env step for every env (action [B, 2] in [-1, 1]) with the
        non-blocking auto-reset (see base.py)."""
        p = self.params
        settling = state.settle_left > 0
        targets = torch.where(settling[:, None], 0.0, action * p.slider_speed)
        physics, _ = self._phys_step(state.physics, targets, ~settling)
        state = state._replace(physics=physics)

        settle_state = state._replace(settle_left=state.settle_left - 1)
        false = torch.zeros_like(settling)
        settle_res = StepResult(
            obs=self._obs(physics, state.lasts, state.last_plan_ang_vec)[0],
            reward=torch.zeros_like(state.last_plan_ang_vec), done=false, valid=false,
            win=false,
        )
        finishing = settling & (state.settle_left <= 1)
        fin_state, fin_res = self._compute_step(settle_state)
        fin_res = fin_res._replace(done=false, valid=~false, win=false)

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


class CartPole3dFactory:
    """Registry factory (env_factory.cpp:60-71)."""

    name = "cartpole3d"

    def __init__(self, parameters: dict[str, str]):
        self.parameters = parameters

    def make(self, seed: int = 1234, mt_parity: bool = True, device=None,
             per_env_step: bool = True) -> CartPole3d:
        """The sequential tier's env (reset with one world) by default; the
        batched trainers pass ``per_env_step=False`` for the batched step."""
        g = lambda k, d: get_value(self.parameters, k, d)  # noqa: E731
        return CartPole3d(
            CartPole3dParams(
                slider_speed=g("slider_speed", 16.0),
                slider_force_per_kg=g("slider_force_per_kg", 32.0),
                chariot_push_force=g("chariot_push_force", 2.0),
                reset_frame_nb=g("reset_frame_nb", 8),
                limit_angle=g("limit_angle", math.pi / 2.0),
                cart_x_mass=g("cart_x_mass", 1.0),
                cart_z_mass=g("cart_z_mass", 1.0),
                pole_mass=g("pole_mass", 1.0),
                max_steps=g("max_steps", 60 * 60),
            ),
            mt_seed=seed if mt_parity else None, device=device, per_env_step=per_env_step,
        )

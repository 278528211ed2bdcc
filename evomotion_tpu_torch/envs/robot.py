"""robot_walk and robot_jump in PyTorch, batch-native (port of
``evomotion_tpu/envs/robot.py``).

Reference: evo_motion_model/src/env/robot_walk.{h,cpp} and
robot_jump.{h,cpp} over the spider skeleton (17 members, 12 hinges + 4
fixed, 12 muscles -> obs 371, act 12).

Observation layout (skeleton.cpp:140-160 get_states), with the reference's
quirks: RootMemberState(root) ++ MemberState(non-root members, JSON order)
++ MuscleState(muscles). Per member: yaw/pitch/roll / pi, lin vel, ang vel /
pi, "acceleration" = last_vel - current_vel (reversed sign, replicated),
and the floor-touched flag, taken once at construction and consumed by the
very first observation only. Member extra: world offset from root; root
extra: [log(|p|+1), p.y, atan2(p.z, p.x)]. Muscle state: slider linear pos,
slider applied impulse, both p2p applied impulses.

robot_walk (robot_walk.cpp:56-104): reward = root v_z; a time bank of
remaining steps decrements while v < minimal_velocity and increments while
v >= target_velocity; fail at <= 0, win at max_episode_seconds. Reset:
random yaw/roll/pitch in +-(2pi/3)/2 around spawn (1, 0.25, 2), then two
settle loops of reset_frames (60 physics steps).

robot_jump (robot_jump.cpp:67-104): reward = max(v_y, 0) + v_z, the same
time bank on it; fail at remaining < 0 (strictly), tilt +-(pi/3)/2, ONE
settle loop of reset_seconds / DT frames (10).

In ``step`` a finished episode teleports and settles again one physics
step per env step, so a rollout of N env steps takes exactly N physics
steps (and N sweep launches).

Random draws come from an explicit ``torch.Generator``, or, with ``mt_seed``,
from the reference's std::mt19937 stream (the reset table of
``utils.mt19937``), which the tests use to match the JAX env.

Two tiers, chosen where the env is built: the batched tier (default) steps
a batch of worlds with the batched step; ``per_env_step=True`` steps each
world with the per-env step (fat rows, dense member narrowphase, the
fat-row sweep kernel twice per physics step), the JAX package's sequential
tier. :class:`RobotWalkFactory` and :class:`RobotJumpFactory` make the
sequential tier, for the CLI.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve
from ..physics import maths
from ..physics.batched import BatchedStep
from ..physics.engine import PhysicsState, StepDiagnostics, default_solver, init_state
from ..physics.perenv import PerEnvStep
from ..physics.robot_compiler import compile_robot
from ..serialize import robot as robot_json
from .base import StepResult, draws, get_value, where

DT = 1.0 / 60.0

DEFAULT_SKELETON = os.path.join(
    os.path.dirname(__file__), "..", "resources", "skeleton", "spider.json"
)


class RobotEnvState(NamedTuple):
    """Batch of robot env states, env axis first."""

    physics: PhysicsState
    reset_idx: torch.Tensor  # [B] int32: resets consumed (mt19937 table cursor)
    curr_step: torch.Tensor  # [B] int32
    remaining_steps: torch.Tensor  # [B] int32
    # proprioception deltas persist across resets (the reference builds its
    # states once in the env ctor and reset_engine never clears them)
    last_lin_vel: torch.Tensor  # [B, n_members, 3]
    last_ang_vel: torch.Tensor  # [B, n_members, 3]
    touch_taken: torch.Tensor  # [B] bool: ctor touch flag consumed?
    motor_target: torch.Tensor  # [B, M] muscle targets (held through settle)
    motors_on: torch.Tensor  # [B] bool
    settle_left: torch.Tensor  # [B] int32
    diag_slider_pos: torch.Tensor  # [B, M]
    diag_slider_imp: torch.Tensor  # [B, M]
    diag_p2p_imp: torch.Tensor  # [B, 2M] (a, b interleaved by muscle)


class _RobotEnvBase:
    """The spider env on the port's physics step, batch first; subclasses
    define the reward, the termination and the reset's settle and tilt
    through the hooks below.

    ``per_env_step`` selects the physics step: False, the batched step;
    True, the per-env step (the sequential tier, a batch of one).
    ``device`` defaults to ``cuda``; pass ``"cpu"`` to run on the CPU.
    Replace :attr:`model` (``dataclasses.replace``) to change a model field;
    the physics step is rebuilt for it."""

    def __init__(self, skeleton_json_path: str, reset_frames: int, minimal_velocity: float,
                 target_velocity: float, mt_seed: int | None = None, device=None,
                 per_env_step: bool = False):
        self.device = resolve(device)
        self.per_env_step = per_env_step
        self.spec = robot_json.load(skeleton_json_path)
        model, self.meta = compile_robot(self.spec)
        model = dataclasses.replace(model, solver=default_solver())
        self._axes = torch.eye(3, device=self.device)
        self._spawn = torch.tensor([1.0, 0.25, 2.0], device=self.device)
        self.model = model
        self.observation_size = self.meta.obs_dim
        self.action_size = self.meta.action_dim
        self.reset_frames = reset_frames
        self.minimal_velocity = minimal_velocity
        self.target_velocity = target_velocity
        dev = self.device
        self._mt_table = None
        if mt_seed is not None:
            from ..utils.mt19937 import reset_draw_table

            # reference draw order per reset: yaw, roll, pitch (robot_walk.cpp:82-84)
            self._mt_table = torch.as_tensor(reset_draw_table(mt_seed, 3), device=dev)
        meta = self.meta

        def idx(x):
            return torch.as_tensor(np.asarray(x, np.int64), device=dev)

        self._members = idx(meta.member_bodies)
        self._non_root = idx(meta.non_root_bodies)
        member_order = list(meta.member_bodies)
        self._root_slot = member_order.index(meta.root_body)
        self._non_root_slots = idx(
            [i for i in range(len(member_order)) if i != self._root_slot]
        )
        self._speed = torch.as_tensor(meta.muscle_speed, device=dev)
        self._touch0 = torch.as_tensor(meta.initial_floor_touch, device=dev)[self._members]
        self._muscle_sliders = idx(meta.muscle_sliders)
        self._muscle_p2p_a = idx(meta.muscle_p2p_a)
        self._muscle_p2p_b = idx(meta.muscle_p2p_b)

    @property
    def model(self):
        return self._model

    @model.setter
    def model(self, model):
        self._model = model
        self.physics_step = (PerEnvStep if self.per_env_step else BatchedStep)(
            model, DT, self.device)
        # build transforms of the skeleton bodies, the reset's "first transform"
        sk = [i for i in range(model.n_bodies) if i != self.meta.floor_body]
        self._skeleton = torch.as_tensor(sk, device=self.device)
        f32 = dict(dtype=torch.float32, device=self.device)
        self._first_pos = torch.as_tensor(model.init_pos[sk], **f32)
        self._first_quat = torch.as_tensor(model.init_quat[sk], **f32)

    # -- subclass hooks ---------------------------------------------------

    @property
    def settle_total(self) -> int:
        """Physics steps of settling per reset."""
        raise NotImplementedError

    @property
    def max_steps(self) -> int:
        raise NotImplementedError

    @property
    def initial_remaining(self) -> int:
        raise NotImplementedError

    @property
    def tilt_limit(self) -> float:
        raise NotImplementedError

    def _reward_velocity(self, physics: PhysicsState) -> torch.Tensor:
        """[B]: the reward, from the root's velocity."""
        raise NotImplementedError

    def _fail(self, remaining: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _bank_velocity(self, physics: PhysicsState) -> torch.Tensor:
        """[B]: the velocity the time bank compares with its thresholds."""
        return self._reward_velocity(physics)

    def _root_vel(self, physics: PhysicsState) -> torch.Tensor:
        return physics.lin_vel[:, self.meta.root_body]

    # ------------------------------------------------------------------

    def _phys_step(self, physics, targets, powered):
        """targets [B, M]; powered [B] bool (motors unpowered until the
        first contract(), muscle_controller.cpp:10-12)."""
        enabled = powered[:, None].expand(-1, self.model.n_slider)
        return self.physics_step(physics, targets, enabled)

    def _obs(self, state: RobotEnvState):
        """The 371-value observation [B, obs]; also returns the member
        velocities that become the next step's ``last_*``."""
        phys = state.physics
        mem = self._members
        quat = phys.quat[:, mem]
        lin = phys.lin_vel[:, mem]
        ang = phys.ang_vel[:, mem]

        yaw, pitch, roll = maths.quat_to_euler_zyx(quat)
        pi = math.pi
        lin_acc = state.last_lin_vel - lin  # reference's reversed delta
        ang_acc = (state.last_ang_vel - ang) / pi
        touch = torch.where(
            state.touch_taken[:, None], torch.zeros_like(yaw), self._touch0[None]
        )
        base16 = torch.cat(
            [torch.stack([yaw / pi, pitch / pi, roll / pi], -1), lin, ang / pi,
             lin_acc, ang_acc, touch[..., None]],
            dim=-1,
        )  # [B, n_members, 16]

        root_pos = phys.pos[:, self.meta.root_body]  # [B, 3]
        root_extra = torch.stack(
            [
                torch.log(torch.sqrt((root_pos * root_pos).sum(-1)) + 1.0),
                root_pos[:, 1],
                torch.arctan2(root_pos[:, 2], root_pos[:, 0]),
            ],
            dim=-1,
        )
        offsets = phys.pos[:, self._non_root] - root_pos[:, None]
        root_state = torch.cat([base16[:, self._root_slot], root_extra], -1)
        member_states = torch.cat([base16[:, self._non_root_slots], offsets], -1)
        muscle_states = torch.stack(
            [state.diag_slider_pos, state.diag_slider_imp,
             state.diag_p2p_imp[:, 0::2], state.diag_p2p_imp[:, 1::2]],
            dim=-1,
        )  # [B, M, 4]
        b = root_state.shape[0]
        obs = torch.cat(
            [root_state, member_states.reshape(b, -1), muscle_states.reshape(b, -1)], -1
        )
        return obs, lin, ang

    def _compute_step(self, state: RobotEnvState):
        obs, lin, ang = self._obs(state)
        reward = self._reward_velocity(state.physics)
        v = self._bank_velocity(state.physics)
        remaining = state.remaining_steps
        remaining = torch.where(
            v < self.minimal_velocity,
            remaining - 1,
            torch.where(v >= self.target_velocity, remaining + 1, remaining),
        )
        # non-finite guard (no reference counterpart): an exploded solve ends
        # the episode as a fail with sanitized outputs, and the auto-reset
        # teleports the env back to a clean state
        finite = torch.isfinite(obs).all(-1) & torch.isfinite(reward)
        obs = torch.where(finite[:, None], obs, 0.0)
        reward = torch.where(finite, reward, 0.0)
        lin = torch.where(finite[:, None, None], lin, 0.0)
        ang = torch.where(finite[:, None, None], ang, 0.0)
        win = (state.curr_step >= self.max_steps) & finite
        fail = self._fail(remaining) | ~finite
        done = win | fail
        state = state._replace(
            curr_step=state.curr_step + 1,
            remaining_steps=remaining,
            last_lin_vel=lin,
            last_ang_vel=ang,
            touch_taken=torch.ones_like(state.touch_taken),
        )
        return state, StepResult(obs, reward, done, torch.ones_like(done), win)

    def _draws(self, reset_idx, generator):
        """Three U(0,1) draws per env (yaw, roll, pitch): [B, 3]."""
        return draws(self._mt_table, reset_idx, 3, generator, self.device)

    def _teleported(self, physics: PhysicsState, u) -> PhysicsState:
        """Random tilt around spawn; skeleton bodies to M * first_transform
        with zero velocities, every warm-start cache cleared
        (robot_walk.cpp:76-96; item.cpp RigidBodyItem::reset)."""
        limit = self.tilt_limit
        yaw = u[:, 0] * limit - limit / 2.0
        rollv = u[:, 1] * limit - limit / 2.0
        pitch = u[:, 2] * limit - limit / 2.0
        axes = self._axes
        # glm::eulerAngleYXZ(yaw, pitch, roll) = RY(yaw) RX(pitch) RZ(roll)
        qy = maths.quat_from_axis_angle(axes[1], yaw)
        qx = maths.quat_from_axis_angle(axes[0], pitch)
        qz = maths.quat_from_axis_angle(axes[2], rollv)
        q = maths.quat_mul(qy, maths.quat_mul(qx, qz))  # [B, 4]

        sk = self._skeleton
        pos = physics.pos.clone()
        quat = physics.quat.clone()
        lin = physics.lin_vel.clone()
        ang = physics.ang_vel.clone()
        pos[:, sk] = self._spawn + maths.quat_rotate(q[:, None], self._first_pos[None])
        quat[:, sk] = maths.quat_normalize(maths.quat_mul(q[:, None], self._first_quat[None]))
        lin[:, sk] = 0.0
        ang[:, sk] = 0.0
        # the reference reset removes and re-adds bodies AND constraints
        # (robot_walk.cpp:89-97), so all warm-start caches clear
        return physics._replace(
            pos=pos, quat=quat, lin_vel=lin, ang_vel=ang,
            contact_lambda=torch.zeros_like(physics.contact_lambda),
            contact_vid=torch.full_like(physics.contact_vid, -1),
            joint_lambda=torch.zeros_like(physics.joint_lambda),
            dyn_lambda=torch.zeros_like(physics.dyn_lambda),
            dyn_vid=torch.full_like(physics.dyn_vid, -1),
        )

    def reset(self, n_envs: int, generator: torch.Generator | None = None):
        """Blocking reset of ``n_envs`` envs (Environment::reset): teleport,
        settle ``settle_total`` physics steps with motors off, first obs."""
        dev = self.device
        m = self.model.n_slider
        i32 = dict(dtype=torch.int32, device=dev)
        physics = init_state(self.model, n_envs, dev)
        physics = self._teleported(physics, self._draws(torch.zeros(n_envs, **i32), generator))
        targets = torch.zeros((n_envs, m), device=dev)
        off = torch.zeros(n_envs, dtype=torch.bool, device=dev)
        for _ in range(self.settle_total):
            physics = self._phys_step(physics, targets, off)[0]
        nm = len(self.meta.member_bodies)
        state = RobotEnvState(
            physics=physics,
            reset_idx=torch.ones(n_envs, **i32),
            curr_step=torch.zeros(n_envs, **i32),
            remaining_steps=torch.full((n_envs,), self.initial_remaining, **i32),
            last_lin_vel=torch.zeros((n_envs, nm, 3), device=dev),
            last_ang_vel=torch.zeros((n_envs, nm, 3), device=dev),
            touch_taken=off.clone(),
            motor_target=torch.zeros((n_envs, m), device=dev),
            motors_on=off.clone(),
            settle_left=torch.zeros(n_envs, **i32),
            diag_slider_pos=torch.zeros((n_envs, m), device=dev),
            diag_slider_imp=torch.zeros((n_envs, m), device=dev),
            diag_p2p_imp=torch.zeros((n_envs, 2 * m), device=dev),
        )
        return self._compute_step(state)

    def _store_diag(self, state: RobotEnvState, diag: StepDiagnostics) -> RobotEnvState:
        p2p = torch.stack(
            [diag.p2p_applied_impulse[:, self._muscle_p2p_a],
             diag.p2p_applied_impulse[:, self._muscle_p2p_b]], -1
        )
        return state._replace(
            diag_slider_pos=diag.slider_lin_pos[:, self._muscle_sliders],
            diag_slider_imp=diag.slider_applied_impulse[:, self._muscle_sliders],
            diag_p2p_imp=p2p.reshape(p2p.shape[0], -1),
        )

    def step(self, state: RobotEnvState, action, generator: torch.Generator | None = None):
        """One env step for every env: action [B, M] in [-1, 1]. ``generator``
        draws the tilt of envs whose episode ends (not needed with mt_seed)."""
        settling = state.settle_left > 0
        # guard: a NaN action would propagate into the persistent motor
        # target (held through resets) and re-poison every future episode
        action = torch.where(torch.isfinite(action), action, 0.0)
        target = torch.where(settling[:, None], state.motor_target, action * self._speed)
        powered = torch.where(settling, state.motors_on, True)
        physics, diag = self._phys_step(state.physics, target, powered)
        state = self._store_diag(
            state._replace(physics=physics, motor_target=target, motors_on=powered), diag
        )

        settle_state = state._replace(settle_left=state.settle_left - 1)
        false = torch.zeros_like(settling)
        settle_res = StepResult(
            obs=self._obs(state)[0],
            reward=torch.zeros_like(state.physics.pos[:, 0, 0]),
            done=false, valid=false, win=false,
        )
        finishing = settling & (state.settle_left <= 1)
        fin_state, fin_res = self._compute_step(settle_state)
        fin_res = fin_res._replace(done=false, valid=~false, win=false)

        run_state, run_res = self._compute_step(state)
        u = self._draws(run_state.reset_idx, generator)
        done_state = run_state._replace(
            physics=self._teleported(run_state.physics, u),
            reset_idx=run_state.reset_idx + 1,
            curr_step=torch.zeros_like(run_state.curr_step),
            remaining_steps=torch.full_like(run_state.remaining_steps, self.initial_remaining),
            settle_left=torch.full_like(run_state.settle_left, self.settle_total),
        )
        run_state = where(run_res.done, done_state, run_state)

        out_state = where(settling, where(finishing, fin_state, settle_state), run_state)
        out_res = where(settling, where(finishing, fin_res, settle_res), run_res)
        return out_state, out_res


@dataclasses.dataclass(frozen=True)
class RobotWalkParams:
    """Defaults from RobotWalkFactory (env_factory.cpp:74-83)."""

    skeleton_json_path: str = DEFAULT_SKELETON
    initial_remaining_seconds: float = 1.0
    max_episode_seconds: float = 30.0
    target_velocity: float = 0.5
    minimal_velocity: float = 0.1
    reset_frames: int = 30


class RobotWalk(_RobotEnvBase):
    """robot_walk: reward root v_z, two settle loops, tilt +-(2pi/3)/2."""

    def __init__(self, params: RobotWalkParams = RobotWalkParams(),
                 mt_seed: int | None = None, device=None, per_env_step: bool = False):
        self.params = params
        super().__init__(params.skeleton_json_path, params.reset_frames,
                         params.minimal_velocity, params.target_velocity, mt_seed, device,
                         per_env_step)

    @property
    def settle_total(self) -> int:
        # reset_engine settles reset_frames twice (robot_walk.cpp:98,103)
        return 2 * self.reset_frames

    @property
    def max_steps(self) -> int:
        return int(self.params.max_episode_seconds / DT)

    @property
    def initial_remaining(self) -> int:
        return int(self.params.initial_remaining_seconds / DT)

    @property
    def tilt_limit(self) -> float:
        return math.pi * 2.0 / 3.0

    def _reward_velocity(self, physics):
        return self._root_vel(physics)[:, 2]

    def _fail(self, remaining):
        return remaining <= 0


@dataclasses.dataclass(frozen=True)
class RobotJumpParams:
    """Defaults from RobotJumpFactory (env_factory.cpp:91-100)."""

    skeleton_json_path: str = DEFAULT_SKELETON
    minimal_velocity: float = 0.1
    target_velocity: float = 0.5
    max_seconds: float = 30.0
    initial_seconds: float = 1.0
    reset_seconds: float = 1.0 / 6.0


class RobotJump(_RobotEnvBase):
    """robot_jump: reward max(v_y, 0) + v_z, one settle loop, tilt
    +-(pi/3)/2, fail strictly below an empty time bank."""

    def __init__(self, params: RobotJumpParams = RobotJumpParams(),
                 mt_seed: int | None = None, device=None, per_env_step: bool = False):
        self.params = params
        super().__init__(params.skeleton_json_path, int(params.reset_seconds / DT),
                         params.minimal_velocity, params.target_velocity, mt_seed, device,
                         per_env_step)

    @property
    def settle_total(self) -> int:
        return self.reset_frames  # single settle loop (robot_jump.cpp:101)

    @property
    def max_steps(self) -> int:
        return int(self.params.max_seconds / DT)

    @property
    def initial_remaining(self) -> int:
        return int(self.params.initial_seconds / DT)

    @property
    def tilt_limit(self) -> float:
        return math.pi / 3.0

    def _reward_velocity(self, physics):
        v = self._root_vel(physics)
        return torch.clamp_min(v[:, 1], 0.0) + v[:, 2]

    def _fail(self, remaining):
        return remaining < 0  # strictly (robot_jump.cpp:79)


class RobotWalkFactory:
    """Registry factory (env_factory.cpp:74-83): string parameters with
    defaults, parsed by the defaults' types."""

    name = "robot_walk"

    def __init__(self, parameters: dict[str, str]):
        self.parameters = parameters

    def make(self, seed: int = 1234, mt_parity: bool = True, device=None,
             per_env_step: bool = True) -> RobotWalk:
        """The sequential tier by default: one world stepped by the per-env
        step (the CLI's ``run``). The batched trainers and the greedy eval
        pass ``per_env_step=False`` for the batched step; in the JAX package
        ``vmap(env.step)`` reaches it through the custom_vmap rule.
        ``mt_parity`` seeds the reference's std::mt19937 reset stream; without
        it, resets draw from the ``torch.Generator`` passed to reset/step."""
        g = lambda k, d: get_value(self.parameters, k, d)  # noqa: E731
        return RobotWalk(
            RobotWalkParams(
                skeleton_json_path=g("skeleton_json_path", DEFAULT_SKELETON),
                initial_remaining_seconds=g("initial_remaining_seconds", 1.0),
                max_episode_seconds=g("max_episode_seconds", 30.0),
                target_velocity=g("target_velocity", 0.5),
                minimal_velocity=g("minimal_velocity", 0.1),
                reset_frames=g("reset_frames", 30),
            ),
            mt_seed=seed if mt_parity else None, device=device, per_env_step=per_env_step,
        )


class RobotJumpFactory:
    """Registry factory (env_factory.cpp:91-100); ``make`` takes the
    arguments of :meth:`RobotWalkFactory.make`."""

    name = "robot_jump"

    def __init__(self, parameters: dict[str, str]):
        self.parameters = parameters

    def make(self, seed: int = 1234, mt_parity: bool = True, device=None,
             per_env_step: bool = True) -> RobotJump:
        g = lambda k, d: get_value(self.parameters, k, d)  # noqa: E731
        return RobotJump(
            RobotJumpParams(
                skeleton_json_path=g("skeleton_json_path", DEFAULT_SKELETON),
                minimal_velocity=g("minimal_velocity", 0.1),
                target_velocity=g("target_velocity", 0.5),
                max_seconds=g("max_seconds", 30.0),
                initial_seconds=g("initial_seconds", 1.0),
                reset_seconds=g("reset_seconds", 1.0 / 6.0),
            ),
            mt_seed=seed if mt_parity else None, device=device, per_env_step=per_env_step,
        )

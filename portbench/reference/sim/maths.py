"""Batched quaternion math in PyTorch (port of ``evomotion_tpu/physics/maths.py``).

All functions broadcast over leading batch dimensions; the trailing axis holds
the vector / quaternion components, float32. Quaternions are ``[x, y, z, w]``
(Bullet's storage order).

Semantics-parity notes (reference files):
- rotation integration matches ``btTransformUtil::integrateTransform``;
- ``quat_to_euler_zyx`` matches ``btMatrix3x3::getEulerZYX`` (proprioception,
  evo_motion_model/src/robot/proprioception_state.cpp:26).

Only the functions the batched robot path uses are ported; the rigid-transform
and matrix-to-quaternion helpers of the JAX module wait for the slices that
need them.
"""

from __future__ import annotations

import math

import torch

# Bullet's ANGULAR_MOTION_THRESHOLD = 0.5 * SIMD_HALF_PI
_ANGULAR_MOTION_THRESHOLD = 0.5 * (math.pi * 0.5)


def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1 * q2, [..., 4] in xyzw order."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        dim=-1,
    )


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=eps)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v [..., 3] by quaternion(s) q [..., 4]."""
    qv = q[..., :3]
    w = q[..., 3:4]
    qv, v = torch.broadcast_tensors(qv, v)
    t = 2.0 * torch.linalg.cross(qv, v, dim=-1)
    return v + w * t + torch.linalg.cross(qv, t, dim=-1)


def quat_rotate_inv(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return quat_rotate(quat_conj(q), v)


def quat_from_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    axis = axis / torch.clamp(torch.linalg.vector_norm(axis, dim=-1, keepdim=True), min=1e-12)
    half = 0.5 * angle
    s = torch.sin(half)[..., None]
    c = torch.cos(half)[..., None]
    axis, s = torch.broadcast_tensors(axis, s)
    return torch.cat([axis * s, c], dim=-1)


def quat_to_mat3(q: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] from quaternion [..., 4]."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def quat_to_euler_zyx(q: torch.Tensor):
    """(yaw, pitch, roll) as in ``btMatrix3x3::getEulerZYX`` (solution 1)."""
    m = quat_to_mat3(q)
    m00, m10 = m[..., 0, 0], m[..., 1, 0]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    locked = torch.abs(m20) >= 1.0 - 1e-7
    pitch_free = -torch.arcsin(torch.clamp(m20, -1.0, 1.0))
    yaw_free = torch.arctan2(m10, m00)
    roll_free = torch.arctan2(m21, m22)

    # Bullet's gimbal handling: roll = 0, yaw/pitch from remaining terms
    m01, m02 = m[..., 0, 1], m[..., 0, 2]
    half_pi = torch.full_like(m20, math.pi / 2)
    pitch_lock = torch.where(m20 < 0, half_pi, -half_pi)
    yaw_lock = torch.where(m20 < 0, torch.arctan2(m01, m02), torch.arctan2(-m01, -m02))

    yaw = torch.where(locked, yaw_lock, yaw_free)
    pitch = torch.where(locked, pitch_lock, pitch_free)
    roll = torch.where(locked, torch.zeros_like(roll_free), roll_free)
    return yaw, pitch, roll


def quat_angle(q: torch.Tensor) -> torch.Tensor:
    """``btQuaternion::getAngle``: 2 * acos(|w| clamped)."""
    return 2.0 * torch.arccos(torch.clamp(q[..., 3], -1.0, 1.0))


def quat_integrate(q: torch.Tensor, omega: torch.Tensor, dt: float) -> torch.Tensor:
    """Advance orientation by angular velocity over dt (exponential map with
    the angular-motion clamp, as ``btTransformUtil::integrateTransform``)."""
    angle = torch.linalg.vector_norm(omega, dim=-1, keepdim=True)
    limit = _ANGULAR_MOTION_THRESHOLD / dt
    angle = torch.clamp(angle, max=limit)
    half = angle * (dt * 0.5)
    small = angle * dt < 0.001
    factor = torch.where(
        small,
        0.5 * dt - (dt * dt * dt) * (1.0 / 48.0) * angle * angle,
        torch.sin(half) / torch.clamp(angle, min=1e-12),
    )
    axis = omega * factor
    dorn = torch.cat([axis, torch.cos(half)], dim=-1)
    return quat_normalize(quat_mul(dorn, q))

"""Kernel #4, the member contact phase (``kernels/csrc/member_contacts.cu``):
its float32 operations and the bytes it must move for one call, from the
configuration's shapes (``config["member"]``, named as the port's
``kernels.member.Shapes`` and ``MemberMeta`` name them) and the env batch;
never from the tensors the program hands the kernel.

Shapes: ``p`` member pairs, ``m`` pairs narrowphased per env (the top-M),
``k`` manifold points per pair, ``v`` proxy-hull test points, ``f`` hull
faces, ``ne`` hull edge directions, ``nsupp`` test points the edge SAT
projects, ``edge`` (edge contacts on), ``u`` member bodies, ``nb`` bodies,
``row_dtype`` (J's type).

Operations per env, the main terms (a floor): the plane tests of both sides
of each narrowphased pair, 6 per test point and face, and with edge
contacts the SAT's projections, 5 per axis, test point and side. Bytes per
env: each input read once (the member bodies' staged state, 22 floats each;
the warm caches, an int32 feature id and 3 f32 impulses per contact point),
each output written once (a normal row per point and two friction rows,
each 12 J values and 4 f32 scalars; ``act``, ``vid``, ``lam_n0`` and the two
``lam_t0`` per point; ``imp6``, 6 f32 per body).
"""

from __future__ import annotations

from .sweep import H100_BYTES_PER_S, H100_FP32_FLOPS

STATE = 22  # staged floats per member body and env
_J_BYTES = {"bf16": 2, "f32": 4}


def flops(member: dict, num_envs: int) -> float:
    m = member
    per_env = 2 * m["m"] * m["v"] * m["f"] * 6
    if m["edge"]:
        per_env += m["m"] * m["ne"] * m["ne"] * 2 * m["nsupp"] * 5
    return float(per_env * num_envs)


def bytes_moved(member: dict, num_envs: int) -> float:
    m = member
    points = m["p"] * m["k"]
    read = 4 * m["u"] * STATE + points * (4 + 3 * 4)
    rows = 3 * points * (12 * _J_BYTES[m["row_dtype"]] + 4 * 4)
    written = rows + points * 5 * 4 + m["nb"] * 6 * 4  # act, vid, lam_n0, lam_t0 x 2; imp6
    return float((read + written) * num_envs)


def least_seconds(member: dict, num_envs: int) -> float:
    """The least time of one call on an H100: the larger of its operations
    over the float32 peak and its bytes over the HBM bandwidth."""
    return max(flops(member, num_envs) / H100_FP32_FLOPS,
               bytes_moved(member, num_envs) / H100_BYTES_PER_S)

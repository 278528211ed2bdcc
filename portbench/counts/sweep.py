"""Kernel #1, the fused sequential-impulse sweep (``kernels/csrc/sweep_envlast_slim.cu``):
its float32 operations and the bytes it must move for one call, from the
configuration's shapes (``config["sweep"]``: the solver rows by kind, the
bodies, the solver iterations and the row dtype) and the env batch; never
from the tensors the program hands the kernel, so the count is the same
whatever implements the sweep.

Operations per row visit, as the kernel counts them: 61 for body A with the
impulse update and 56 more for body B (it recomputes Minv J^T and 1/eff),
the clamp by kind (joint 2, normal 1, friction 4), and a contact normal
row's split-impulse pass (29, and 25 more with body B). Bytes: each input
read once (J columns, scalars, velocities, warm-start impulses, world
inverse inertia, the per-row table of 12 words), each output written once
(velocities, impulses, push velocities).
"""

from __future__ import annotations

H100_FP32_FLOPS = 67e12  # float32 outside the tensor cores, SXM data sheet
H100_BYTES_PER_S = 3.35e12  # HBM3

_CLAMP = {"joint": 2, "normal": 1, "friction": 4}
_J_BYTES = {"bf16": 2, "f32": 4}


def _row_flops(kind: str, has_b: bool, push: bool) -> int:
    return (61 + _CLAMP[kind] + (56 if has_b else 0)
            + ((29 + (25 if has_b else 0)) if push else 0))


def flops(sweep: dict, num_envs: int) -> float:
    """Float32 operations of one call over ``num_envs`` envs. ``sweep["rows"]``
    maps ``<kind>_<a|ab>[_push]`` to a row count."""
    per_iter = 0
    for key, n in sweep["rows"].items():
        parts = key.split("_")
        per_iter += n * _row_flops(parts[0], parts[1] == "ab", parts[-1] == "push")
    return float(per_iter * sweep["n_iterations"] * num_envs)


def n_rows(sweep: dict) -> int:
    return sum(sweep["rows"].values())


def bytes_moved(sweep: dict, num_envs: int) -> float:
    rows, bodies, b = n_rows(sweep), sweep["bodies"], num_envs
    j = _J_BYTES[sweep["row_dtype"]]
    table = -(-rows // 8) * 8 * 12 * 4
    read = rows * 12 * b * j + rows * 4 * b * 4 + bodies * 6 * b * 4 + rows * b * 4 \
        + bodies * 9 * b * 4 + table
    written = 2 * bodies * 6 * b * 4 + rows * b * 4
    return float(read + written)


def least_seconds(sweep: dict, num_envs: int) -> float:
    """The least time of one call on an H100: the larger of its operations
    over the float32 peak and its bytes over the HBM bandwidth."""
    return max(flops(sweep, num_envs) / H100_FP32_FLOPS,
               bytes_moved(sweep, num_envs) / H100_BYTES_PER_S)

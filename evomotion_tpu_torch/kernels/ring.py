"""Launch plans of the two env-last sweep kernels (``csrc/envlast_ring.cuh``).

A block of either kernel takes ``envs`` envs (a power of two, at most 16)
and runs a consumer warp, two threads per env, and a producer warp that
streams the rows through a ring of ``stages`` stages of :data:`STAGE_ROWS`
rows each (kernel #1 adds a warp that computes each stage's 1/eff). Everything the dependent chain touches stays
in shared memory for the whole call (velocities, push velocities, impulses,
push impulses, and kernel #1's inverse-inertia table), so a block's shared
memory is

    ALIGN + stages * stage_bytes(envs) + ALIGN + 4 * envs * resident_words

where ``resident_words`` counts the floats one env keeps. :func:`plan` takes
the most envs per block that fit the card's opt-in with at least two stages,
then the most stages (up to four). It is a pure function of the shapes: the
same shapes always give the same plan, and no plan raises ValueError. The
kernels recompute the sum from the same shapes and refuse a plan whose
bytes differ.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np

STAGE_ROWS = 8  # rows per ring stage, the TPU kernels' chunk
ALIGN = 128  # TMA destinations and the mbarrier block
ENVS = (16, 8, 4, 2, 1)  # envs per block, most first
STAGES = (4, 3, 2)  # ring depth, most first (the kernels take at most 4)
# A model of one H100 SM for the CPU tests of the planner: its shared
# memory (228 KiB), what the runtime keeps per resident block, and the most
# blocks it holds. On the card the kernels' ``*_blocks_per_sm`` entry points
# give the runtime's own count, which tests/test_torch_gpu.py holds this
# model against.
SMEM_PER_SM = 233_472
BLOCK_RESERVED = 1_024
MAX_BLOCKS_PER_SM = 32


def align(n: int) -> int:
    return -(-n // ALIGN) * ALIGN


def stage_table(mi: np.ndarray, floats: np.ndarray, width: int) -> np.ndarray:
    """The per-row metadata a ring stage carries, int32 [ceil8(n), width],
    from the row table ``mi`` [n, 6] (ia6, ib6, kind, parent, skip_b,
    push_slot) and ``floats`` [n, k]: per row body A, body B (-1 where
    skip_b), kind, the row whose impulse bounds it (the friction parent, else
    the row itself), push slot (-1 on rows without one), 0, then the bits of
    the floats, zero-padded to ``width`` words (a multiple of 4, so a row is
    whole 16-byte words) and to whole stages of STAGE_ROWS rows."""
    n = mi.shape[0]
    friction = mi[:, 2] > 1
    out = np.zeros((-(-n // STAGE_ROWS) * STAGE_ROWS, width), np.int32)
    out[:n, 0] = mi[:, 0] // 6
    out[:n, 1] = np.where(mi[:, 4] != 0, -1, mi[:, 1] // 6)
    out[:n, 2] = mi[:, 2]
    out[:n, 3] = np.where(friction, mi[:, 3], np.arange(n))
    out[:n, 4] = mi[:, 5]
    out[:n, 6:6 + floats.shape[1]] = np.ascontiguousarray(floats, np.float32).view(np.int32)
    return out


class Plan(NamedTuple):
    """One launch of an env-last sweep kernel."""

    envs: int  # envs per block
    stages: int  # ring stages of STAGE_ROWS rows
    threads: int  # threads per block
    smem_bytes: int  # dynamic shared memory per block
    stage_bytes: int  # one ring stage
    elt_bytes: tuple  # element bytes of each streamed array

    def blocks(self, b: int) -> int:
        return -(-b // self.envs)

    def masked(self, b: int) -> int:
        """Env slots of the last block beyond ``b`` (computed on zeros, never stored)."""
        return self.blocks(b) * self.envs - b

    def blocks_per_sm(self) -> int:
        """Resident blocks per SM in the H100 model above."""
        return min(SMEM_PER_SM // (self.smem_bytes + BLOCK_RESERVED), MAX_BLOCKS_PER_SM)

    def waves(self, b: int, n_sms: int) -> int:
        return -(-self.blocks(b) // (n_sms * self.blocks_per_sm()))

    def copy(self, b: int) -> str:
        """How the producer fills a stage at ``b`` envs: ``"tma"`` where every
        streamed array's env stride and box width are multiples of 16 bytes,
        else ``"plain"`` loads."""
        ok = all((b * e) % 16 == 0 and (self.envs * e) % 16 == 0 for e in self.elt_bytes)
        return "tma" if ok else "plain"

    def describe(self, b: int) -> dict:
        """What a launch at ``b`` envs passes to the kernel."""
        return {"blocks": self.blocks(b), "envs_per_block": self.envs,
                "masked_envs": self.masked(b), "threads": self.threads,
                "smem_bytes": self.smem_bytes, "stages": self.stages,
                "stage_rows": STAGE_ROWS, "copy": self.copy(b)}


def plan(stage_bytes: Callable[[int], int], resident_words: int, elt_bytes: tuple,
         threads: int, smem_optin: int, what: str) -> Plan:
    """The plan with the most envs per block, then the most stages, whose
    shared memory fits ``smem_optin``; ``stage_bytes(envs)`` is one stage,
    ``resident_words`` the floats one env keeps resident, ``threads`` the
    kernel's block."""
    for envs in ENVS:
        for stages in STAGES:
            total = 2 * ALIGN + stages * stage_bytes(envs) + 4 * envs * resident_words
            if total <= smem_optin:
                return Plan(envs, stages, threads, total, stage_bytes(envs), tuple(elt_bytes))
    least = 2 * ALIGN + STAGES[-1] * stage_bytes(1) + 4 * resident_words
    raise ValueError(f"{what}: no launch plan fits {smem_optin} B of shared memory "
                     f"(1 env per block and {STAGES[-1]} stages need {least} B)")

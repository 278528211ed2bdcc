"""Headless trajectory recording + replay rendering.

Port of ``evomotion_tpu/viewer/recorder.py``: the recorder reads the port's
env states (a leading env axis on every field; the sequential tier is a
batch of one) and stores one world's poses, with the keys, shapes and
dtypes of the JAX recording. ``render_frames`` imports matplotlib when
called; where matplotlib is missing (the card's machine) the call raises
ImportError.

Reference counterpart: evo_motion_view's GL renderer + the infer window
(renderer.cpp, infer.cpp:43-105). TPU-native replacement: record per-step
body transforms to .npz and render offline (matplotlib) — no GL context in
the training loop, no host round-trips while simulating.
"""

from __future__ import annotations

import numpy as np


class TrajectoryRecorder:
    """Accumulates body poses from env states that carry a ``physics``
    PhysicsState with the env axis first: world 0 of each state, the
    sequential tier's only world."""

    def __init__(self, env):
        self.env = env
        self.model = env.model
        self.frames_pos: list[np.ndarray] = []
        self.frames_quat: list[np.ndarray] = []

    def add(self, env_state) -> None:
        phys = env_state.physics
        self.frames_pos.append(phys.pos[0].detach().cpu().numpy())
        self.frames_quat.append(phys.quat[0].detach().cpu().numpy())

    def save(self, path: str) -> None:
        np.savez_compressed(
            path,
            pos=np.stack(self.frames_pos),
            quat=np.stack(self.frames_quat),
            body_names=np.array(self.model.body_names),
            hull=self.model.hull,
            hull_mask=self.model.hull_mask,
        )


def render_frames(npz_path: str, out_path: str, every: int = 4, max_frames: int = 64):
    """Render a recorded trajectory to a PNG contact sheet (matplotlib)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    data = np.load(npz_path, allow_pickle=True)
    pos = data["pos"][::every][:max_frames]  # [F, NB, 3]
    n = len(pos)
    cols = min(8, n)
    rows = (n + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(2.2 * cols, 2.2 * rows))
    axes = np.atleast_1d(axes).reshape(-1)
    for i in range(len(axes)):
        ax = axes[i]
        ax.set_axis_off()
        if i >= n:
            continue
        p = pos[i]
        ax.scatter(p[:, 2], p[:, 1], s=8)
        ax.set_xlim(p[:, 2].mean() - 3, p[:, 2].mean() + 3)
        ax.set_ylim(-1.5, 2.5)
        ax.set_title(f"t={i * every}", fontsize=7)
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)

"""Offline 3D rendering of recorded trajectories.

Port copy of ``evomotion_tpu/viewer/render3d.py`` (no JAX): the port keeps
its own copy so that it imports no module of the JAX package; keep the two
in step (tests/test_torch_viewer.py holds their output equal). Nothing in
the repo calls it. ``render_trajectory`` imports matplotlib when called;
where matplotlib is missing (the card's machine) the call raises
ImportError.

Reference counterpart: the OpenGL renderer + FollowCamera (evo_motion_view:
specular-shaded meshes, checkerboard ground, camera tracking the robot root).
Headless re-design: convex-hull meshes per body rendered with matplotlib's
Poly3DCollection from a recorded .npz trajectory (viewer/recorder.py), with a
follow-camera that tracks a chosen body. Produces PNG frames or an animated
GIF — viewable anywhere, no GL context required.
"""

from __future__ import annotations

import numpy as np


def _hull_faces(points: np.ndarray) -> list[np.ndarray]:
    from scipy.spatial import ConvexHull

    if len(points) < 4:
        return []
    hull = ConvexHull(points, qhull_options="QJ")
    return [points[s] for s in hull.simplices]


def _quat_to_mat3(q):
    x, y, z, w = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def render_trajectory(
    npz_path: str,
    out_path: str,
    track_body: int | str | None = None,
    every: int = 2,
    max_frames: int = 120,
    elev: float = 18.0,
    azim: float = -60.0,
    fps: int = 30,
    skip_bodies: tuple = (),
):
    """Render a recorded trajectory to an animated GIF (or a PNG if out_path
    ends with .png — last frame only)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.animation import PillowWriter
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    data = np.load(npz_path, allow_pickle=True)
    pos = data["pos"][::every][:max_frames]  # [F, NB, 3]
    quat = data["quat"][::every][:max_frames]
    hull = data["hull"]
    hull_mask = data["hull_mask"]
    names = [str(n) for n in data["body_names"]]
    nb = pos.shape[1]

    if isinstance(track_body, str):
        track_body = names.index(track_body)

    # precompute local faces per body; huge static bodies become a ground tile
    local_faces: list[list[np.ndarray]] = []
    is_ground = []
    for i in range(nb):
        pts = hull[i][hull_mask[i] > 0]
        extent = pts.max(0) - pts.min(0)
        ground = bool((extent > 50).any())
        is_ground.append(ground)
        local_faces.append([] if ground else _hull_faces(pts))

    colors = plt.cm.tab20(np.linspace(0, 1, nb))

    fig = plt.figure(figsize=(6, 5), dpi=90)
    ax = fig.add_subplot(111, projection="3d")

    def draw(f):
        ax.cla()
        ax.set_axis_off()
        center = pos[f, track_body] if track_body is not None else pos[f].mean(0)
        for i in range(nb):
            if i in skip_bodies:
                continue
            if is_ground[i]:
                # checkerboard-ish ground plane patch around the camera target
                top = (hull[i][hull_mask[i] > 0] @ _quat_to_mat3(quat[f, i]).T)[:, 1].max()
                top += pos[f, i, 1]
                g = 4.0
                xs = center[0] + np.array([-g, g, g, -g])
                zs = center[2] + np.array([-g, -g, g, g])
                ax.add_collection3d(
                    Poly3DCollection(
                        [np.stack([xs, np.full(4, top), zs], -1)],
                        facecolor="#dddddd", edgecolor="#bbbbbb", alpha=0.6,
                    )
                )
                continue
            rot = _quat_to_mat3(quat[f, i])
            faces = [fc @ rot.T + pos[f, i] for fc in local_faces[i]]
            if faces:
                ax.add_collection3d(
                    Poly3DCollection(
                        faces, facecolor=colors[i], edgecolor="none", alpha=0.9
                    )
                )
        r = 2.2
        ax.set_xlim(center[0] - r, center[0] + r)
        ax.set_ylim(center[2] - r, center[2] + r)
        ax.set_zlim(center[1] - 1.2, center[1] + 1.8)
        ax.view_init(elev=elev, azim=azim)
        # matplotlib 3d: swap axes so y (up) renders vertically
        ax.set_box_aspect((1, 1, 0.7))

    # note: we plot (x, z, y) by feeding lims accordingly; faces use raw
    # coordinates, so transpose y/z in the artists instead
    def draw_swapped(f):
        ax.cla()
        ax.set_axis_off()
        center = pos[f, track_body] if track_body is not None else pos[f].mean(0)
        for i in range(nb):
            if i in skip_bodies:
                continue
            rot = _quat_to_mat3(quat[f, i])
            if is_ground[i]:
                pts = hull[i][hull_mask[i] > 0] @ rot.T + pos[f, i]
                top = pts[:, 1].max()
                g = 4.0
                xs = center[0] + np.array([-g, g, g, -g])
                zs = center[2] + np.array([-g, -g, g, g])
                ax.add_collection3d(
                    Poly3DCollection(
                        [np.stack([xs, zs, np.full(4, top)], -1)],
                        facecolor="#e8e8e8", edgecolor="#cccccc", alpha=0.7,
                    )
                )
                continue
            faces = [
                (fc @ rot.T + pos[f, i])[:, [0, 2, 1]] for fc in local_faces[i]
            ]
            if faces:
                ax.add_collection3d(
                    Poly3DCollection(
                        faces, facecolor=colors[i], edgecolor="k",
                        linewidths=0.2, alpha=0.95,
                    )
                )
        r = 2.2
        ax.set_xlim(center[0] - r, center[0] + r)
        ax.set_ylim(center[2] - r, center[2] + r)
        ax.set_zlim(center[1] - 1.2, center[1] + 1.2)
        ax.view_init(elev=elev, azim=azim)
        ax.set_box_aspect((1, 1, 0.6))

    if out_path.endswith(".png"):
        draw_swapped(len(pos) - 1)
        fig.savefig(out_path, bbox_inches="tight")
    else:
        writer = PillowWriter(fps=fps)
        with writer.saving(fig, out_path, dpi=90):
            for f in range(len(pos)):
                draw_swapped(f)
                writer.grab_frame()
    plt.close(fig)
    return out_path

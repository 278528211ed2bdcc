"""Shape library: OBJ parsing, procedural primitives, convex-hull point sets.

Port copy of ``evomotion_tpu/physics/shapes.py`` (numpy only): the port keeps
its own copy so that it imports no module of the JAX package; keep the two
in step (tests/test_torch_front_end.py compares them).

The reference builds every collision shape as a ``btConvexHullShape`` from the
raw vertices of a Wavefront OBJ file (evo_motion_model/src/item.cpp:17-35,
shapes.cpp:23-62). Shape kinds are name-mapped to OBJ assets
(robot/member.cpp:17-22: sphere/cube/cylinder/feet).

TPU-first re-design: a shape is a fixed-size array of convex-hull vertices in
local (unscaled) coordinates. Scaling is the per-body ``local_scaling`` vector
applied at model-compile time (Bullet applies it inside the shape). Hull point
sets are reduced to their extreme points with scipy at load time — the hull of
the hull is identical, and fewer points means cheaper support-function and
contact kernels on device.

Primitives are generated procedurally (unit cube corner points, UV-sphere and
Z-axis cylinder matching the reference meshes' parameterization: radius 1,
cylinder half-height 1 along Z).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

# shape kind enum matching reference ShapeKind (evo_motion_model/include/.../shapes.h)
SPHERE = "sphere"
CUBE = "cube"
CYLINDER = "cylinder"
FEET = "feet"

_RESOURCE_DIR = os.path.join(os.path.dirname(__file__), "resources")


@dataclasses.dataclass(frozen=True)
class Shape:
    """Convex shape defined by hull vertices (and optional render mesh)."""

    name: str
    hull_verts: np.ndarray  # [V, 3] float32, local unscaled coordinates
    render_verts: np.ndarray | None = None  # [T*3, 3] triangle soup for the viewer
    render_normals: np.ndarray | None = None


def parse_obj(path: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Minimal Wavefront OBJ reader (v/vn/f triangles).

    Returns (unique_vertices [V,3], tri_vertices [F*3,3], tri_normals [F*3,3])
    — the same data the reference's ObjShape exposes
    (evo_motion_model/src/shapes.cpp:23-62).
    """
    verts: list[list[float]] = []
    norms: list[list[float]] = []
    tri_v: list[list[float]] = []
    tri_n: list[list[float]] = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "vn":
                norms.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                idx = []
                for token in parts[1:]:
                    comp = token.split("/")
                    vi = int(comp[0]) - 1
                    ni = int(comp[2]) - 1 if len(comp) >= 3 and comp[2] else -1
                    idx.append((vi, ni))
                # fan-triangulate
                for k in range(1, len(idx) - 1):
                    for vi, ni in (idx[0], idx[k], idx[k + 1]):
                        tri_v.append(verts[vi])
                        tri_n.append(norms[ni] if ni >= 0 else [0.0, 0.0, 0.0])
    v = np.array(verts, dtype=np.float32)
    return (
        np.unique(v, axis=0) if len(v) else v.reshape(0, 3),
        np.array(tri_v, dtype=np.float32).reshape(-1, 3),
        np.array(tri_n, dtype=np.float32).reshape(-1, 3),
    )


def reduce_to_hull(points: np.ndarray, max_verts: int = 48) -> np.ndarray:
    """Reduce a point cloud to a compact convex-hull vertex set.

    First keeps only hull extreme points; if still above ``max_verts``,
    decimates by farthest-point sampling and re-hulls — the same role as
    Bullet's btShapeHull simplification (Bullet reduces convex hulls to ~42
    vertices); collision behavior is preserved to within the hull margin."""
    from scipy.spatial import ConvexHull

    if len(points) <= 4:
        return points.astype(np.float32)
    hull = ConvexHull(points.astype(np.float64), qhull_options="QJ")
    verts = points[np.unique(hull.vertices)].astype(np.float64)
    if len(verts) > max_verts:
        # farthest-point sampling seeded at the extremes of each axis
        chosen = list(
            {int(np.argmin(verts[:, k])) for k in range(3)}
            | {int(np.argmax(verts[:, k])) for k in range(3)}
        )
        d = np.linalg.norm(verts[:, None] - verts[chosen][None], axis=-1).min(1)
        while len(chosen) < max_verts:
            nxt = int(np.argmax(d))
            chosen.append(nxt)
            d = np.minimum(d, np.linalg.norm(verts - verts[nxt], axis=-1))
        verts = verts[sorted(chosen)]
        hull2 = ConvexHull(verts, qhull_options="QJ")
        verts = verts[np.unique(hull2.vertices)]
    return verts.astype(np.float32)


def make_cube() -> Shape:
    """Unit cube, half-extent 1 (reference cube.obj spans [-1, 1]^3)."""
    corners = np.array(
        [[sx, sy, sz] for sx in (-1.0, 1.0) for sy in (-1.0, 1.0) for sz in (-1.0, 1.0)],
        dtype=np.float32,
    )
    return Shape(CUBE, corners)


def make_sphere(n_seg: int = 32, n_ring: int = 16) -> Shape:
    """Unit UV-sphere hull points (reference sphere.obj: radius-1 UV sphere)."""
    pts = [np.array([0.0, 1.0, 0.0]), np.array([0.0, -1.0, 0.0])]
    for ri in range(1, n_ring):
        phi = np.pi * ri / n_ring
        y = np.cos(phi)
        r = np.sin(phi)
        for si in range(n_seg):
            th = 2 * np.pi * si / n_seg
            pts.append(np.array([r * np.sin(th), y, -r * np.cos(th)]))
    return Shape(SPHERE, np.array(pts, dtype=np.float32))


def make_cylinder(n_seg: int = 32) -> Shape:
    """Radius-1 cylinder along Z with half-height 1 (reference cylinder.obj)."""
    pts = []
    for z in (-1.0, 1.0):
        for si in range(n_seg):
            th = 2 * np.pi * si / n_seg
            pts.append([np.cos(th), np.sin(th), z])
    return Shape(CYLINDER, np.array(pts, dtype=np.float32))


def _load_resource_hull(kind: str) -> np.ndarray | None:
    path = os.path.join(_RESOURCE_DIR, "hulls", f"{kind}.npy")
    if os.path.exists(path):
        return np.load(path).astype(np.float32)
    return None


_CACHE: dict[str, Shape] = {}


def get_shape(kind: str) -> Shape:
    """Shape registry keyed by kind name (reference member.cpp:17-22)."""
    if kind in _CACHE:
        return _CACHE[kind]
    if kind == CUBE:
        s = make_cube()
    elif kind == SPHERE:
        s = Shape(SPHERE, reduce_to_hull(make_sphere().hull_verts))
    elif kind == CYLINDER:
        s = Shape(CYLINDER, reduce_to_hull(make_cylinder().hull_verts))
    else:
        hull = _load_resource_hull(kind)
        if hull is None:
            raise KeyError(f"unknown shape kind: {kind!r}")
        s = Shape(kind, reduce_to_hull(hull))
    _CACHE[kind] = s
    return s


def shape_from_obj(name: str, path: str) -> Shape:
    verts, tri_v, tri_n = parse_obj(path)
    return Shape(name, reduce_to_hull(verts), tri_v, tri_n)

"""Triangle-mesh utilities — the cloud_tools mesh converters.

Replaces:
- `triangular_mesh_to_vtk` (cloud_tools): mesh → legacy-VTK polydata file.
- `mesh_to_pointcloud` (cloud_tools): uniform point sampling over mesh
  triangles (area-weighted).
- the virtual-view core of `laser_camera_virtual_view_calibration`
  (cloud_tools, VTK offscreen render of a mesh into a virtual camera
  image): here one call into the JAX depth rasterizer
  (realtime.render_depth_mesh) instead of a VTK render window.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def write_vtk_mesh(path: str, vertices: np.ndarray, triangles: np.ndarray,
                   scalars: Optional[np.ndarray] = None) -> None:
    """Legacy VTK ASCII polydata (the triangular_mesh_to_vtk output).
    ``scalars`` adds the per-vertex POINT_DATA intensity block the
    cloud_tools viewer reads (me.cpp:160-191)."""
    v = np.asarray(vertices, np.float64)
    t = np.asarray(triangles, np.int64)
    with open(path, "w") as fp:
        fp.write("# vtk DataFile Version 3.0\nmapping_private_tpu mesh\n")
        fp.write("ASCII\nDATASET POLYDATA\n")
        fp.write(f"POINTS {len(v)} float\n")
        for p in v:
            fp.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
        fp.write(f"POLYGONS {len(t)} {4 * len(t)}\n")
        for tri in t:
            fp.write(f"3 {tri[0]} {tri[1]} {tri[2]}\n")
        if scalars is not None:
            s = np.asarray(scalars, np.float64)
            fp.write(f"POINT_DATA {len(s)}\n")
            fp.write("SCALARS scalars double\nLOOKUP_TABLE default\n")
            for val in s:
                fp.write(f"{val:g}\n")


def read_vtk_mesh(
    path: str, with_scalars: bool = False
):
    """Read back a legacy VTK ASCII polydata mesh (optionally with the
    per-vertex POINT_DATA scalars block)."""
    tokens = open(path).read().split()
    verts = tris = scalars = None
    i = 0
    while i < len(tokens):
        tk = tokens[i].upper()
        if tk == "POINTS":
            n = int(tokens[i + 1])
            vals = tokens[i + 3 : i + 3 + 3 * n]
            verts = np.asarray(vals, np.float64).reshape(n, 3)
            i += 3 + 3 * n
        elif tk == "POLYGONS":
            n = int(tokens[i + 1])
            vals = tokens[i + 3 : i + 3 + 4 * n]
            arr = np.asarray(vals, np.int64).reshape(n, 4)
            tris = arr[:, 1:]
            i += 3 + 4 * n
        elif tk == "SCALARS":
            n = len(verts) if verts is not None else 0
            # skip: SCALARS <name> <type> [comps] LOOKUP_TABLE <name>
            j = i + 3
            if tokens[j].upper() == "LOOKUP_TABLE":
                j += 2
            elif tokens[j + 1].upper() == "LOOKUP_TABLE":
                j += 3
            scalars = np.asarray(tokens[j : j + n], np.float64)
            i = j + n
        else:
            i += 1
    if verts is None or tris is None:
        raise ValueError(f"{path}: not a polydata mesh")
    if with_scalars:
        return verts, tris, scalars
    return verts, tris


def sample_mesh_points(
    vertices: np.ndarray,
    triangles: np.ndarray,
    num_points: int,
    seed: int = 0,
) -> np.ndarray:
    """Area-weighted uniform sampling on the surface (mesh_to_pointcloud)."""
    v = np.asarray(vertices, np.float64)
    t = np.asarray(triangles, np.int64)
    a, b, c = v[t[:, 0]], v[t[:, 1]], v[t[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)
    total = areas.sum()
    if total <= 0:
        raise ValueError("degenerate mesh (zero area)")
    rng = np.random.default_rng(seed)
    pick = rng.choice(len(t), num_points, p=areas / total)
    u = rng.random(num_points)
    w = rng.random(num_points)
    flip = u + w > 1
    u[flip], w[flip] = 1 - u[flip], 1 - w[flip]
    pts = a[pick] + u[:, None] * (b[pick] - a[pick]) + w[:, None] * (c[pick] - a[pick])
    return pts.astype(np.float32)


def virtual_view_depth(
    vertices: np.ndarray,
    triangles: np.ndarray,
    camera_pose: np.ndarray,
    image_shape: Tuple[int, int] = (480, 640),
    fx: float = 525.0,
    fy: float = 525.0,
) -> np.ndarray:
    """Render the mesh from a virtual camera (world→camera pose (4,4));
    the laser↔camera calibration view generator, on the JAX rasterizer."""
    import jax.numpy as jnp
    from mapping_private_tpu.realtime.render import render_depth_mesh

    d = render_depth_mesh(
        jnp.asarray(np.asarray(vertices, np.float32)),
        jnp.asarray(np.asarray(triangles, np.int32)),
        image_shape, fx=fx, fy=fy,
        pose=jnp.asarray(np.asarray(camera_pose, np.float32)),
    )
    return np.asarray(d)


def virtual_view_intensity(
    vertices: np.ndarray,
    triangles: np.ndarray,
    intensities: np.ndarray,
    camera_pose: np.ndarray,
    image_shape: Tuple[int, int] = (480, 640),
    fx: float = 525.0,
    fy: float = 525.0,
) -> np.ndarray:
    """Render per-vertex intensities from a virtual camera — the
    render-to-image half of the cloud_tools mesh viewer (me.cpp:227-302:
    GL_SMOOTH triangles → framebuffer → PPM), on the JAX rasterizer.
    Returns (H, W) uint8 (clamped at 255 like the tool's maxval)."""
    import jax.numpy as jnp
    from mapping_private_tpu.realtime.render import render_intensity_mesh

    img = render_intensity_mesh(
        jnp.asarray(np.asarray(vertices, np.float32)),
        jnp.asarray(np.asarray(triangles, np.int32)),
        jnp.asarray(np.asarray(intensities, np.float32)),
        image_shape, fx=fx, fy=fy,
        pose=jnp.asarray(np.asarray(camera_pose, np.float32)),
    )
    return np.clip(np.asarray(img), 0, 255).astype(np.uint8)


def write_ppm(path: str, image: np.ndarray) -> None:
    """ASCII P3 grayscale-as-RGB PPM, the me.cpp image() output format
    (me.cpp:236-258 — each intensity repeated into r g b)."""
    img = np.asarray(image)
    h, w = img.shape
    with open(path, "w") as fp:
        fp.write(f"P3\n{w} {h}\n255\n")
        for row in img:
            fp.write(" ".join(f"{int(v)} {int(v)} {int(v)}" for v in row))
            fp.write("\n")


def read_ppm(path: str) -> np.ndarray:
    """Read back an ASCII P3 PPM as (H, W) grayscale (red channel)."""
    tokens = open(path).read().split()
    assert tokens[0] == "P3", "not an ASCII PPM"
    w, h = int(tokens[1]), int(tokens[2])
    vals = np.asarray(tokens[4 : 4 + 3 * w * h], np.int64).reshape(h, w, 3)
    return vals[..., 0].astype(np.uint8)

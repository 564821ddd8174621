"""Mesh depth rendering — the URDF self-filter renderer, JAX-native.

Replaces realtime_perception's OpenGL FBO pipeline (`URDFRenderer::
process_link/render`, src/urdf_renderer.cpp:67-135 + FrameBufferObject.cpp):
the robot's link meshes are rasterized into a depth buffer that
`background_subtract` compares against the live Kinect depth.

Array formulation: a gather-free barycentric rasterizer — triangles are
processed in fixed-size chunks under `lax.scan`; each chunk tests every
pixel against every triangle in one broadcast (edge functions are three
fused multiply-adds per pixel-triangle pair) and min-reduces the
perspective-correct depth.  No scanline serialization, no z-buffer
contention: the min over chunks IS the z-buffer.
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def _raster_mesh(
    vertices, triangles, image_shape, fx, fy, cx, cy, pose, chunk,
    z_near, z_far, intensities=None,
):
    """Shared chunked barycentric raster core: returns (zbuf, ibuf) —
    ibuf is None without ``intensities``.  One broadcast of edge
    functions per (chunk, H, W); the min over chunks IS the z-buffer."""
    h, w = image_shape
    cx = (w - 1) / 2.0 if cx is None else cx
    cy = (h - 1) / 2.0 if cy is None else cy
    v = jnp.asarray(vertices, jnp.float32)
    if pose is not None:
        v = v @ pose[:3, :3].T + pose[:3, 3]
    inten = (None if intensities is None
             else jnp.asarray(intensities, jnp.float32))
    tri = jnp.asarray(triangles, jnp.int32)
    t_total = tri.shape[0]
    pad = (-t_total) % chunk
    if pad:
        tri = jnp.concatenate([tri, jnp.zeros((pad, 3), jnp.int32)], axis=0)
    tri_valid = jnp.arange(tri.shape[0]) < t_total
    tri = tri.reshape(-1, chunk, 3)
    tri_valid = tri_valid.reshape(-1, chunk)

    # pixel grid
    uu, vv = jnp.meshgrid(
        jnp.arange(w, dtype=jnp.float32), jnp.arange(h, dtype=jnp.float32)
    )  # (H, W)

    def raster_chunk(carry, args):
        zbuf, ibuf = carry
        ids, ok = args  # (C,3), (C,)
        p = v[ids]  # (C, 3, 3)
        z = p[..., 2]  # (C, 3)
        in_front = jnp.all(z > z_near, axis=-1) & ok  # (C,)
        # project
        px = p[..., 0] / jnp.maximum(z, 1e-6) * fx + cx  # (C, 3)
        py = p[..., 1] / jnp.maximum(z, 1e-6) * fy + cy
        x0, x1, x2 = px[:, 0], px[:, 1], px[:, 2]
        y0, y1, y2 = py[:, 0], py[:, 1], py[:, 2]
        area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)  # (C,)
        nz_area = jnp.abs(area) > 1e-9
        area_s = jnp.where(nz_area, area, 1.0)

        # edge functions for every pixel × triangle: (C, H, W)
        def edge(ax, ay, bx, by):
            return (
                (bx - ax)[:, None, None] * (vv[None] - ay[:, None, None])
                - (by - ay)[:, None, None] * (uu[None] - ax[:, None, None])
            )

        w0 = edge(x1, y1, x2, y2) / area_s[:, None, None]
        w1 = edge(x2, y2, x0, y0) / area_s[:, None, None]
        w2 = edge(x0, y0, x1, y1) / area_s[:, None, None]
        inside = (
            (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
            & nz_area[:, None, None] & in_front[:, None, None]
        )
        # perspective-correct depth: interpolate 1/z with barycentrics
        inv_z = (
            w0 / jnp.maximum(z[:, 0, None, None], 1e-6)
            + w1 / jnp.maximum(z[:, 1, None, None], 1e-6)
            + w2 / jnp.maximum(z[:, 2, None, None], 1e-6)
        )
        depth = jnp.where(inside, 1.0 / jnp.maximum(inv_z, 1e-9), z_far)
        if ibuf is None:
            return (jnp.minimum(zbuf, jnp.min(depth, axis=0)), None), None
        # screen-space Gouraud of the nearest triangle's vertex values
        ivals = inten[ids]  # (C, 3)
        gouraud = (
            w0 * ivals[:, 0, None, None]
            + w1 * ivals[:, 1, None, None]
            + w2 * ivals[:, 2, None, None]
        )
        kmin = jnp.argmin(depth, axis=0)  # (H, W)
        dmin = jnp.take_along_axis(depth, kmin[None], axis=0)[0]
        imin = jnp.take_along_axis(gouraud, kmin[None], axis=0)[0]
        closer = dmin < zbuf
        return (jnp.where(closer, dmin, zbuf),
                jnp.where(closer, imin, ibuf)), None

    zbuf0 = jnp.full((h, w), z_far, jnp.float32)
    ibuf0 = None if inten is None else jnp.zeros((h, w), jnp.float32)
    (zbuf, ibuf), _ = jax.lax.scan(
        raster_chunk, (zbuf0, ibuf0), (tri, tri_valid))
    return zbuf, ibuf


def render_depth_mesh(
    vertices: jax.Array,
    triangles: jax.Array,
    image_shape: Tuple[int, int],
    fx: float = 580.0,
    fy: float = 580.0,
    cx: Optional[float] = None,
    cy: Optional[float] = None,
    pose: Optional[jax.Array] = None,
    chunk: int = 64,
    z_near: float = 0.1,
    z_far: float = 100.0,
) -> jax.Array:
    """Rasterize a triangle mesh into a (H, W) metric depth image.

    Args:
      vertices: (V, 3) mesh vertices (model frame).
      triangles: (T, 3) int32 vertex indices.
      pose: optional (4, 4) model→camera transform (the URDF link pose).
      chunk: triangles per scan step (memory/throughput knob).

    Returns (H, W) depth in metres; 0 where nothing was hit.
    """
    zbuf, _ = _raster_mesh(vertices, triangles, image_shape, fx, fy,
                           cx, cy, pose, chunk, z_near, z_far)
    return jnp.where(zbuf < z_far, zbuf, 0.0)


def render_intensity_mesh(
    vertices: jax.Array,
    triangles: jax.Array,
    intensities: jax.Array,
    image_shape: Tuple[int, int],
    fx: float = 580.0,
    fy: float = 580.0,
    cx: Optional[float] = None,
    cy: Optional[float] = None,
    pose: Optional[jax.Array] = None,
    chunk: int = 64,
    z_near: float = 0.1,
    z_far: float = 100.0,
    background: float = 0.0,
) -> jax.Array:
    """Rasterize per-vertex intensities into a (H, W) grayscale image.

    The render half of the cloud_tools mesh viewer's image dump
    (cloud_tools/src/me.cpp:227-259 `image()` + :279-299 — GL_SMOOTH
    triangles colored by per-vertex scalar, framebuffer red channel read
    back): the shared z-buffered rasterizer, with the carry also holding
    the barycentric (Gouraud) interpolation of the nearest triangle's
    vertex intensities — screen-space interpolation, like the
    fixed-function GL path the reference reads back.
    """
    zbuf, ibuf = _raster_mesh(vertices, triangles, image_shape, fx, fy,
                              cx, cy, pose, chunk, z_near, z_far,
                              intensities=intensities)
    return jnp.where(zbuf < z_far, ibuf, jnp.float32(background))


def ray_box_tmin(
    origin: jax.Array,
    dirs: jax.Array,
    box_min: jax.Array,
    box_max: jax.Array,
) -> jax.Array:
    """(R, B) slab-method entry distances of R rays against B AABBs.

    The working JAX counterpart of realtime_perception's attic CUDA
    kernel (realtime_segmentation/src/attic/boxlist_ray_intersection.cu:
    52-101 hitbox — per-axis slab entry/exit with sign-ordered bounds;
    the upstream kernel's ray setup was left a TODO stub, so only its
    slab core defines the contract).  One broadcast over rays × boxes —
    no per-box loop.  Misses (empty slab overlap, or a box entirely
    behind the origin) return +inf.
    """
    o = jnp.asarray(origin, jnp.float32)
    d = jnp.asarray(dirs, jnp.float32)[:, None, :]        # (R, 1, 3)
    lo = jnp.asarray(box_min, jnp.float32)[None]          # (1, B, 3)
    hi = jnp.asarray(box_max, jnp.float32)[None]
    # sign-ordered slab bounds; a zero direction component is replaced
    # by 1e-30 (NOT left to divide to IEEE ±inf: a true inf would give
    # 0*inf = NaN when the origin lies exactly ON a slab plane) — the
    # ±1e30 pseudo-slab bounds behave like the CUDA kernel's ±inf for
    # every off-plane case and stay NaN-free on the boundary
    inv = 1.0 / jnp.where(jnp.abs(d) > 0, d, jnp.float32(1e-30))
    t1 = (lo - o) * inv
    t2 = (hi - o) * inv
    tmin = jnp.max(jnp.minimum(t1, t2), axis=-1)          # (R, B)
    tmax = jnp.min(jnp.maximum(t1, t2), axis=-1)
    hit = (tmax >= jnp.maximum(tmin, 0.0))
    return jnp.where(hit, jnp.maximum(tmin, 0.0), jnp.inf)


def boxlist_ray_intersection(
    box_min: jax.Array,
    box_max: jax.Array,
    origin,
    focallength: float,
    width: int,
    height: int,
    cx: Optional[float] = None,
    cy: Optional[float] = None,
) -> Tuple[jax.Array, jax.Array]:
    """Per-pixel nearest-box image over a pinhole ray grid.

    Completes the attic kernel's intended operator() contract
    (boxlist_ray_intersection.cu:15-49 + URDF::compute's per-pixel
    thrust::transform): returns ((H, W) int32 box ids — 0 for a miss,
    boxid + 1 for a hit, like the kernel's return — and the (H, W)
    float32 entry depth along the ray, inf on miss)."""
    cx = (width - 1) / 2.0 if cx is None else cx
    cy = (height - 1) / 2.0 if cy is None else cy
    uu, vv = jnp.meshgrid(
        jnp.arange(width, dtype=jnp.float32),
        jnp.arange(height, dtype=jnp.float32))
    dirs = jnp.stack(
        [(uu - cx) / focallength, (vv - cy) / focallength,
         jnp.ones_like(uu)], axis=-1).reshape(-1, 3)
    t = ray_box_tmin(jnp.asarray(origin, jnp.float32), dirs,
                     box_min, box_max)                    # (R, B)
    best = jnp.argmin(t, axis=1)
    tbest = jnp.take_along_axis(t, best[:, None], axis=1)[:, 0]
    ids = jnp.where(jnp.isfinite(tbest), best.astype(jnp.int32) + 1, 0)
    return (ids.reshape(height, width),
            tbest.reshape(height, width))

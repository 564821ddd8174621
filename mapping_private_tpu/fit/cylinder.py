"""Cylinder RANSAC + triangulation — `CylinderEstimation` JAX-native.

Replaces reference cloud_algos/src/cylinder_fit_algo.cpp: RANSAC over
`SACModelCylinder` with threshold 0.01 on points+normals (:45-47), k=20
kd-NN normal estimation if the cloud has none (:138-204, handled by
ops.normals.estimate_normals upstream), then triangulation of the fitted
cylinder into a mesh (:117-122, triangulate_cylinder).

Hypothesis generation follows the classical 2-point-with-normals
formulation the reference's SAC model uses: the axis direction is the
cross product of the two normals; the axis point is the closest point of
approach of the two normal lines; the radius is the distance of either
sample to the axis.  All H hypotheses are drawn, scored (H, N), and
argmax-selected in one traced program; refinement re-estimates the
radius and axis point from the inlier set.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mapping_private_tpu.fit.ransac import sample_live_indices, score_hypotheses


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Cylinder:
    """point: (3,) a point on the axis; axis: (3,) unit direction;
    radius: scalar; height bounds along axis relative to ``point``."""

    point: jax.Array
    axis: jax.Array
    radius: jax.Array
    k_min: jax.Array
    k_max: jax.Array


def point_to_axis_distance(
    xyz: jax.Array, point: jax.Array, axis: jax.Array
) -> jax.Array:
    """(..., 3) → (...) distance to the line (point, axis). axis unit."""
    rel = xyz - point
    along = jnp.sum(rel * axis, axis=-1, keepdims=True)
    perp = rel - along * axis
    return jnp.linalg.norm(perp, axis=-1)


def _closest_point_between_lines(
    p1: jax.Array, d1: jax.Array, p2: jax.Array, d2: jax.Array
) -> jax.Array:
    """Midpoint of the common-perpendicular segment of two lines (batched).

    Mirrors LineToLineSegment (sac_model_rotational.cpp:110-160) but
    returns the midpoint (both endpoints coincide when lines intersect).
    """
    w = p1 - p2
    a = jnp.sum(d1 * d1, -1)
    b = jnp.sum(d1 * d2, -1)
    c = jnp.sum(d2 * d2, -1)
    d = jnp.sum(d1 * w, -1)
    e = jnp.sum(d2 * w, -1)
    den = a * c - b * b
    ok = den > 1e-12
    den = jnp.where(ok, den, 1.0)
    sc = jnp.where(ok, (b * e - c * d) / den, 0.0)
    tc = jnp.where(ok, (a * e - b * d) / den, 0.0)
    q1 = p1 + sc[..., None] * d1
    q2 = p2 + tc[..., None] * d2
    return 0.5 * (q1 + q2)


def fit_cylinder_ransac(
    xyz: jax.Array,
    normals: jax.Array,
    mask: jax.Array,
    key: jax.Array,
    num_hypotheses: int = 512,
    threshold: float = 0.01,
    normal_weight: float = 0.1,
    min_radius: float = 0.0,
    max_radius: float = jnp.inf,
    method: str = "msac",
) -> Tuple[Cylinder, jax.Array]:
    """RANSAC cylinder over a masked point set with normals.

    Distance per point = (1−w)·|dist_to_axis − r| + w·r·angle(n, radial),
    matching the normal-distance-weight blend of the reference's SAC
    cylinder model (threshold 0.01 at cylinder_fit_algo.cpp:46).

    Returns (Cylinder, inliers (N,) bool).
    """
    idx = sample_live_indices(key, mask, (num_hypotheses, 2))
    p1, p2 = xyz[idx[:, 0]], xyz[idx[:, 1]]
    n1, n2 = normals[idx[:, 0]], normals[idx[:, 1]]

    ax = jnp.cross(n1, n2)  # (H,3)
    axlen = jnp.linalg.norm(ax, axis=-1, keepdims=True)
    degenerate = axlen[:, 0] < 1e-6  # parallel normals
    ax = ax / jnp.maximum(axlen, 1e-30)
    apt = _closest_point_between_lines(p1, n1, p2, n2)  # (H,3)
    rad = point_to_axis_distance(p1, apt, ax)  # (H,)

    # (H, N) geometric distance
    rel = xyz[None, :, :] - apt[:, None, :]  # (H,N,3)
    along = jnp.sum(rel * ax[:, None, :], axis=-1)  # (H,N)
    perp = rel - along[..., None] * ax[:, None, :]
    pd = jnp.linalg.norm(perp, axis=-1)  # (H,N) dist to axis
    geo = jnp.abs(pd - rad[:, None])
    if normal_weight > 0.0:
        radial = perp / jnp.maximum(pd[..., None], 1e-12)
        cosang = jnp.clip(
            jnp.abs(jnp.sum(radial * normals[None, :, :], axis=-1)), 0.0, 1.0
        )
        ang = jnp.arccos(cosang)
        dists = (1.0 - normal_weight) * geo + normal_weight * rad[:, None] * ang
    else:
        dists = geo
    scores = score_hypotheses(dists, mask, threshold, method)
    bad = degenerate | (rad < min_radius) | (rad > max_radius)
    scores = jnp.where(bad, -1.0, scores)
    best = jnp.argmax(scores)
    apt_b, ax_b, rad_b = apt[best], ax[best], rad[best]

    # refinement: inlier-mean radius + axis point recentering (2 sweeps)
    def refine(carry, _):
        apt_c, ax_c, rad_c = carry
        d = point_to_axis_distance(xyz, apt_c, ax_c)
        inl = (jnp.abs(d - rad_c) < threshold) & mask
        w = inl.astype(xyz.dtype)
        cnt = jnp.maximum(jnp.sum(w), 3.0)
        rad_n = jnp.sum(d * w) / cnt
        # re-center axis point at the inlier centroid projected to the axis
        cen = jnp.sum(xyz * w[:, None], axis=0) / cnt
        apt_n = apt_c + jnp.dot(cen - apt_c, ax_c) * ax_c
        return (apt_n, ax_c, rad_n), None

    (apt_b, ax_b, rad_b), _ = jax.lax.scan(
        refine, (apt_b, ax_b, rad_b), None, length=2
    )

    d = point_to_axis_distance(xyz, apt_b, ax_b)
    inliers = (jnp.abs(d - rad_b) < threshold) & mask
    k = jnp.sum((xyz - apt_b) * ax_b, axis=-1)
    big = jnp.float32(1e9)
    k_min = jnp.min(jnp.where(inliers, k, big))
    k_max = jnp.max(jnp.where(inliers, k, -big))
    cyl = Cylinder(point=apt_b, axis=ax_b, radius=rad_b, k_min=k_min, k_max=k_max)
    return cyl, inliers


def cylinder_mesh(
    point: np.ndarray,
    axis: np.ndarray,
    radius: float,
    k_min: float,
    k_max: float,
    segments: int = 24,
) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side triangulation of a fitted cylinder (the reference's
    `triangulate_cylinder`, cylinder_fit_algo.cpp): returns
    (vertices (2*segments, 3), triangles (2*segments, 3) int32)."""
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    seed = np.array([1.0, 0.0, 0.0]) if abs(axis[0]) < 0.9 else np.array([0.0, 1.0, 0.0])
    u = np.cross(axis, seed)
    u /= np.linalg.norm(u)
    v = np.cross(axis, u)
    ang = 2.0 * np.pi * np.arange(segments) / segments
    ring = radius * (np.outer(np.cos(ang), u) + np.outer(np.sin(ang), v))
    bot = point + k_min * axis + ring
    top = point + k_max * axis + ring
    verts = np.vstack([bot, top]).astype(np.float32)
    tris = []
    for i in range(segments):
        j = (i + 1) % segments
        tris.append([i, j, segments + i])
        tris.append([j, segments + j, segments + i])
    return verts, np.asarray(tris, np.int32)

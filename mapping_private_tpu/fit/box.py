"""Robust oriented-box estimation — `RobustBoxEstimation` JAX-native.

The reference's box fit ops (`box_fit_algo.h` / `box_fit2_algo.h`) migrated
out of the snapshot but remain hard dependencies of the table-memory
reconstruction chain (dyn_obj_store/src/table_memory.cpp:20-25, registered
in the algorithm pool at :277-280 and applied to hull contours at :437-444).
This implements the same capability: a gravity-aligned (z-up) oriented
bounding box from the cluster's planar covariance eigenvectors, plus a
free-orientation 3D PCA variant.

Everything is a masked reduction — one covariance, one closed-form 2×2/3×3
eigendecomposition, two min/max sweeps.  No hypothesis loops needed: the
reference's "robustness" came from operating on RANSAC-cleaned clusters,
which is likewise the expected input here.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mapping_private_tpu.ops.normals import smallest_eigenvector_3x3


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class OrientedBox:
    """center (3,), axes (3,3) rows = unit box axes, extents (3,) full widths."""

    center: jax.Array
    axes: jax.Array
    extents: jax.Array


def _masked_cov(
    pts: jax.Array, mask: jax.Array
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    w = mask.astype(pts.dtype)[:, None]
    cnt = jnp.maximum(jnp.sum(w), 1.0)
    mean = jnp.sum(pts * w, axis=0) / cnt
    d = (pts - mean) * w
    cov = d.T @ d / cnt
    return cov, mean, cnt


def fit_box_zup(xyz: jax.Array, mask: jax.Array) -> OrientedBox:
    """Gravity-aligned box: yaw from the xy covariance's principal axis,
    z extent straight from the height range (the box_fit2 convention for
    tabletop objects standing on a support plane)."""
    cov, mean, _ = _masked_cov(xyz[:, :2], mask)
    # closed-form 2x2 symmetric eigenvector (major axis)
    a, b, c = cov[0, 0], cov[0, 1], cov[1, 1]
    theta = 0.5 * jnp.arctan2(2.0 * b, a - c)
    ct, st = jnp.cos(theta), jnp.sin(theta)
    ax0 = jnp.array([1.0, 0.0, 0.0]) * ct + jnp.array([0.0, 1.0, 0.0]) * st
    ax1 = jnp.array([-1.0, 0.0, 0.0]) * st + jnp.array([0.0, 1.0, 0.0]) * ct
    axes = jnp.stack([ax0, ax1, jnp.array([0.0, 0.0, 1.0])])  # (3,3)
    return _box_from_axes(xyz, mask, axes)


def fit_box_pca(xyz: jax.Array, mask: jax.Array) -> OrientedBox:
    """Free-orientation box from full 3D PCA of the cluster."""
    cov, mean, _ = _masked_cov(xyz, mask)
    # smallest eigenvector + deflation gives all three axes
    _, v0 = smallest_eigenvector_3x3(cov)
    # project out v0, find smallest of the reduced system = middle axis
    P = jnp.eye(3) - jnp.outer(v0, v0)
    cov2 = P @ cov @ P + jnp.outer(v0, v0) * (jnp.trace(cov) + 1.0)
    _, v1 = smallest_eigenvector_3x3(cov2)
    v1 = v1 - jnp.dot(v1, v0) * v0
    v1 = v1 / jnp.maximum(jnp.linalg.norm(v1), 1e-12)
    v2 = jnp.cross(v0, v1)
    axes = jnp.stack([v2, v1, v0])  # major, middle, minor
    return _box_from_axes(xyz, mask, axes)


def _box_from_axes(xyz: jax.Array, mask: jax.Array, axes: jax.Array) -> OrientedBox:
    proj = xyz @ axes.T  # (N,3) coordinates in box frame
    big = jnp.float32(1e9)
    lo = jnp.min(jnp.where(mask[:, None], proj, big), axis=0)
    hi = jnp.max(jnp.where(mask[:, None], proj, -big), axis=0)
    center_box = 0.5 * (lo + hi)
    extents = jnp.maximum(hi - lo, 0.0)
    center = center_box @ axes
    return OrientedBox(center=center, axes=axes, extents=extents)


def box_mesh(box_center, box_axes, box_extents) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side 8-vertex/12-triangle mesh of an OrientedBox."""
    c = np.asarray(box_center, np.float64)
    A = np.asarray(box_axes, np.float64)
    e = 0.5 * np.asarray(box_extents, np.float64)
    corners = np.array(
        [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]
    )
    verts = (c + (corners * e) @ A).astype(np.float32)
    tris = np.array(
        [
            [0, 1, 3], [0, 3, 2],  # -x
            [4, 7, 5], [4, 6, 7],  # +x
            [0, 5, 1], [0, 4, 5],  # -y
            [2, 3, 7], [2, 7, 6],  # +y
            [0, 2, 6], [0, 6, 4],  # -z
            [1, 5, 7], [1, 7, 3],  # +z
        ],
        np.int32,
    )
    return verts, tris

"""Point-cloud filters — noise removal, box clipping, normal-direction gates.

JAX-native equivalents of:
- `StatisticalNoiseRemoval` (reference cloud_algos/src/noise_removal.cpp:73-150):
  kNN mean-distance outlier rejection with a global mean ± alpha·std gate and
  a min-output-size validity check.  The reference's per-point kd-tree loop
  (and its "TODO parallelize!" at noise_removal.cpp:99) becomes one batched
  kNN + two masked reductions.
- `box_filter` node (cloud_tools/src/box_filter.cpp): axis-aligned box clip.
- `cloud_geometry::getPointIndicesAxisParallelNormals` /
  `getPointIndicesAxisPerpendicularNormals` (used at
  table_object_detector_passive.cpp:396, wall_filter.cpp:228): normal-angle
  gates against a fixed axis.

All filters are mask transforms — shapes stay static, no compaction.
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from mapping_private_tpu.core.cloud import PointCloud
from mapping_private_tpu.ops.neighbors import knn_bruteforce, build_grid_hash, knn_grid


def statistical_outlier_mask(
    xyz: jax.Array,
    mask: jax.Array,
    k: int = 30,
    alpha: float = 1.0,
    use_grid: bool = False,
    cell_size: float = 0.05,
) -> jax.Array:
    """Keep-mask for the mean-kNN-distance outlier filter.

    Per point: mean distance to its k nearest live neighbors (self
    excluded, matching noise_removal.cpp:104 which skips index 0).
    Globally: keep |d_i − mean| < alpha · std (noise_removal.cpp:130).
    """
    if use_grid:
        grid = build_grid_hash(xyz, mask, cell_size)
        idx, sq = knn_grid(
            grid, xyz, k=k, self_idx=jnp.arange(xyz.shape[0], dtype=jnp.int32)
        )
    else:
        idx, sq = knn_bruteforce(xyz, xyz, mask, k=k, exclude_self=True)
    valid = (idx >= 0) & jnp.isfinite(sq)
    d = jnp.where(valid, jnp.sqrt(jnp.maximum(sq, 0.0)), 0.0)
    cnt = jnp.maximum(jnp.sum(valid.astype(jnp.float32), axis=1), 1.0)
    avg = jnp.sum(d, axis=1) / cnt  # (N,)

    live = mask.astype(jnp.float32)
    n_live = jnp.maximum(jnp.sum(live), 1.0)
    mean = jnp.sum(avg * live) / n_live
    var = jnp.sum(avg * avg * live) / n_live - mean * mean
    std = jnp.sqrt(jnp.maximum(var, 0.0))
    return mask & (jnp.abs(avg - mean) < alpha * std)


def remove_statistical_outliers(
    cloud: PointCloud,
    k: int = 30,
    alpha: float = 1.0,
    min_nr_pts: int = 0,
    use_grid: bool = False,
    cell_size: float = 0.05,
) -> Tuple[PointCloud, jax.Array]:
    """Filtered cloud + validity flag (count ≥ min_nr_pts, the reference's
    `min_nr_pts_` output gate at noise_removal.cpp:145-150)."""
    keep = statistical_outlier_mask(
        cloud.padded_xyz(), cloud.mask, k=k, alpha=alpha,
        use_grid=use_grid, cell_size=cell_size,
    )
    out = cloud.select(keep)
    valid = out.count() >= min_nr_pts
    return out, valid


def box_filter_mask(
    xyz: jax.Array,
    mask: jax.Array,
    min_corner: jax.Array,
    max_corner: jax.Array,
) -> jax.Array:
    """Axis-aligned box clip (cloud_tools box_filter node)."""
    lo = jnp.asarray(min_corner, xyz.dtype)
    hi = jnp.asarray(max_corner, xyz.dtype)
    inside = jnp.all((xyz >= lo) & (xyz <= hi), axis=-1)
    return mask & inside


def box_filter(cloud: PointCloud, min_corner, max_corner) -> PointCloud:
    return cloud.select(
        box_filter_mask(
            cloud.xyz, cloud.mask,
            jnp.asarray(min_corner, jnp.float32),
            jnp.asarray(max_corner, jnp.float32),
        )
    )


def axis_parallel_normal_mask(
    normals: jax.Array, mask: jax.Array, axis: jax.Array, eps_angle: float
) -> jax.Array:
    """Points whose normal is within eps_angle of ±axis
    (getPointIndicesAxisParallelNormals)."""
    a = axis / jnp.linalg.norm(axis)
    cosang = jnp.abs(normals @ a)
    return mask & (cosang >= jnp.cos(eps_angle))


def axis_perpendicular_normal_mask(
    normals: jax.Array, mask: jax.Array, axis: jax.Array, eps_angle: float
) -> jax.Array:
    """Points whose normal is within eps_angle of the plane ⊥ axis
    (getPointIndicesAxisPerpendicularNormals, wall_filter.cpp:228)."""
    a = axis / jnp.linalg.norm(axis)
    sinang = jnp.abs(normals @ a)  # |cos(angle to axis)| = sin(angle to plane)
    return mask & (sinang <= jnp.sin(eps_angle))


def z_band_mask(
    xyz: jax.Array, mask: jax.Array, z_min: float, z_max: float
) -> jax.Array:
    """Height-band filter (table_object_detector_passive.cpp:353-363)."""
    return mask & (xyz[:, 2] >= z_min) & (xyz[:, 2] <= z_max)


def channel_equal_mask(
    cloud: PointCloud, name: str, value: float, atol: float = 0.0
) -> jax.Array:
    """Points whose named channel equals ``value`` (the RegionGrowing
    `setExtraDimensionIgnore` gate, region_growing.cpp:42-43)."""
    ch = cloud.channel(name)
    if atol == 0.0:
        ok = ch == value
    else:
        ok = jnp.abs(ch - value) <= atol
    return cloud.mask & ok


def depth_limit_mask(
    xyz: jax.Array, mask: jax.Array, distance_th: float,
    relative: bool = False,
) -> jax.Array:
    """Depth-limit filter of the training-capture tool
    (color_voxel_recognition/test/save_data.cpp:67-83 limitPoint):
    keep z < distance_th, or — in the tool's RELATIVE MODE used to
    segment the training object — z < min_live_z + distance_th.  A mask
    transform, never compaction (jit-stable shapes)."""
    z = xyz[:, 2]
    th = jnp.float32(distance_th)
    if relative:
        big = jnp.float32(3.4e38)
        th = jnp.min(jnp.where(mask, z, big)) + th
    return mask & (z < th)

"""Room-scale structural segmentation — `pointcloud_segmentation` JAX-native.

Replaces pointcloud_segmentation/src/pointcloud_segmentation.cpp: floor =
points below z_floor (segmentFloor :255+), ceiling = points above z_ceiling
(segmentCeiling :206-252), walls = repeated RANSAC extraction of planes
whose normals are perpendicular to z — i.e. vertical planes, preferring
x/y-aligned ones (segmentVerticalPlanes :161-203).  The per-point
`PointSegmentation` label channel (point type header :1-59) becomes a
'segment' channel on the cloud: 0 unlabeled, 1 floor, 2 ceiling, 3+ walls.

Also provides wall_filter semantics (cloud_tools/src/wall_filter.cpp): drop
every point within the SAC distance of a detected dominant vertical plane.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import jax
import jax.numpy as jnp

from mapping_private_tpu.core.cloud import PointCloud
from mapping_private_tpu.fit.ransac import fit_plane_ransac

FLOOR, CEILING, FIRST_WALL = 1, 2, 3


@dataclasses.dataclass(frozen=True)
class RoomSegmentationConfig:
    z_floor: float = 0.1  # segmentFloor threshold
    z_ceiling: float = 2.7  # segmentCeiling threshold
    max_walls: int = 4
    sac_threshold: float = 0.03  # wall_filter sac_distance_threshold (:155)
    eps_angle: float = 15.0 * 3.14159265 / 180.0  # normal_eps_angle (:142)
    min_wall_inliers: int = 300
    num_hypotheses: int = 256


@dataclasses.dataclass
class RoomSegmentation:
    labels: jax.Array  # (N,) int32 segment ids
    wall_planes: List[jax.Array]  # list of (4,) plane coefficients


def segment_room(
    cloud: PointCloud,
    key: jax.Array,
    cfg: RoomSegmentationConfig = RoomSegmentationConfig(),
) -> RoomSegmentation:
    """Label floor/ceiling/walls.  Walls are extracted sequentially: fit a
    z-perpendicular plane on the remaining unlabeled points, claim inliers,
    repeat up to max_walls or until a fit falls under min_wall_inliers."""
    xyz = cloud.padded_xyz()
    n = cloud.capacity
    labels = jnp.zeros((n,), jnp.int32)
    live = cloud.mask

    floor = live & (xyz[:, 2] < cfg.z_floor)
    ceiling = live & (xyz[:, 2] > cfg.z_ceiling)
    labels = jnp.where(floor, FLOOR, labels)
    labels = jnp.where(ceiling, CEILING, labels)
    live = live & ~floor & ~ceiling

    z_axis = jnp.array([0.0, 0.0, 1.0])
    walls: List[jax.Array] = []
    for wi in range(cfg.max_walls):
        key, sub = jax.random.split(key)
        # vertical plane: normal ⊥ z ⇒ constrain |n·z| ≤ sin(eps) via the
        # axis/eps gate with an in-plane axis is awkward; instead fit free
        # planes and reject non-vertical winners (the reference checks the
        # plane-to-z angle ≈ 90°, wall_filter.cpp:262)
        plane, inl = fit_plane_ransac(
            xyz, live, sub, num_hypotheses=cfg.num_hypotheses,
            threshold=cfg.sac_threshold,
        )
        vertical = jnp.abs(plane[:3] @ z_axis) <= jnp.sin(cfg.eps_angle)
        count = int(jnp.sum(inl.astype(jnp.int32)))
        if count < cfg.min_wall_inliers:
            break
        if not bool(vertical):
            # dominant plane is horizontal (e.g. a table) — stop extracting
            break
        labels = jnp.where(inl, FIRST_WALL + wi, labels)
        live = live & ~inl
        walls.append(plane)
    return RoomSegmentation(labels=labels, wall_planes=walls)


def wall_filter(
    cloud: PointCloud,
    key: jax.Array,
    cfg: RoomSegmentationConfig = RoomSegmentationConfig(),
) -> PointCloud:
    """Remove dominant vertical planes (cloud_tools wall_filter node):
    every point within sac_threshold of a detected wall plane is dropped
    from the ORIGINAL cloud (the reference filters cloud_in_ by
    pointToPlaneDistance, wall_filter.cpp:268)."""
    seg = segment_room(cloud, key, cfg)
    keep = cloud.mask
    xyz = cloud.padded_xyz()
    for plane in seg.wall_planes:
        d = jnp.abs(xyz @ plane[:3] + plane[3])
        keep = keep & (d >= cfg.sac_threshold)
    return cloud.select(keep)

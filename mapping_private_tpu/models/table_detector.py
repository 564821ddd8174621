"""Tabletop detector — the end-to-end perception slice, one jit.

Array re-design of `table_object_detector_passive`
(cloud_tools/src/table_object_detector_passive.cpp): z-band filter →
voxel downsample (:372) → kNN normals (:392) → z-parallel normal gate
(:396) → Euclidean clustering with normal-angle edges (:401) → per-cluster
RANSAC plane (:415) → hull (:485) → object clusters above the table
(:528, findObjectClusters :254-341).

Where the reference chains five ROS nodes over TCP, this is one traced
program: every stage is a masked dense op, candidate tables are fitted
*in parallel* via vmap instead of the reference's per-cluster loop, and
the whole thing compiles once for a given capacity.

Default parameters mirror the reference's ROS param defaults
(constructor :150-210): leaf 0.03, k=10, eps_angle 15°, region angle 30°,
cluster tolerance 0.5 m / min 10 pts, object tolerance 0.05 m / min 30
pts, SAC threshold 0.03, delta_z 0.03, support distance 0.10, min table
inliers 100, z band [0.5, 1.5].
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from mapping_private_tpu.core.cloud import PAD_COORD, PointCloud
from mapping_private_tpu.fit.ransac import fit_plane_ransac
from mapping_private_tpu.ops.cluster import euclidean_cluster, top_clusters
from mapping_private_tpu.ops.hull import RadialHull, in_radial_hull, radial_hull
from mapping_private_tpu.ops.normals import estimate_normals
from mapping_private_tpu.ops.voxel import voxel_downsample


@dataclasses.dataclass(frozen=True)
class TableDetectorConfig:
    table_min_height: float = 0.5
    table_max_height: float = 1.5
    leaf_size: float = 0.03
    k_normals: int = 10
    eps_angle: float = 15.0 * jnp.pi / 180.0
    region_angle_threshold: float = 30.0 * jnp.pi / 180.0
    clusters_growing_tolerance: float = 0.5
    clusters_min_pts: int = 10
    object_cluster_tolerance: float = 0.05
    object_cluster_min_pts: int = 30
    sac_distance_threshold: float = 0.03
    sac_hypotheses: int = 256
    delta_z: float = 0.03
    object_min_distance_from_table: float = 0.10
    min_table_inliers: int = 100
    # `one_table` wanted-table gating
    # (table_object_detector_passive_one_table.cpp:201-206, :434-445):
    # when set, a candidate plane is accepted only if its inlier centroid
    # lies within sqrt(max_sqr_dist_to_wanted_table) of this (x, y).
    wanted_table_center: Optional[Tuple[float, float]] = None
    max_sqr_dist_to_wanted_table: float = 1.0
    # static capacities
    down_capacity: int = 8192
    max_table_candidates: int = 4
    max_objects: int = 16
    hull_bins: int = 72
    cluster_knn: int = 16


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TableDetection:
    """All arrays refer to rows of ``cloud_down``."""

    found: jax.Array  # () bool
    plane: jax.Array  # (4,) [n, d]
    table_inliers: jax.Array  # (M,) bool
    table_min: jax.Array  # (3,)
    table_max: jax.Array  # (3,)
    hull: RadialHull
    object_masks: jax.Array  # (O, M) bool
    object_sizes: jax.Array  # (O,) int32
    object_centers: jax.Array  # (O, 3)
    object_min: jax.Array  # (O, 3)
    object_max: jax.Array  # (O, 3)

    def num_objects(self) -> jax.Array:
        return jnp.sum((self.object_sizes > 0).astype(jnp.int32))


def _masked_minmax(xyz: jax.Array, mask: jax.Array) -> Tuple[jax.Array, jax.Array]:
    big = jnp.float32(PAD_COORD)
    mn = jnp.min(jnp.where(mask[:, None], xyz, big), axis=0)
    mx = jnp.max(jnp.where(mask[:, None], xyz, -big), axis=0)
    return mn, mx


@functools.partial(jax.jit, static_argnames=("config",))
def detect_table(
    cloud: PointCloud, key: jax.Array, config: TableDetectorConfig = TableDetectorConfig()
) -> Tuple[TableDetection, PointCloud]:
    """Run the detector.  Returns (detection, downsampled cloud)."""
    cfg = config
    # 1. z-band filter (reference cloud_cb :353-363)
    band = (cloud.xyz[:, 2] >= cfg.table_min_height) & (
        cloud.xyz[:, 2] <= cfg.table_max_height
    )
    cloud_band = cloud.select(band)

    # 2. voxel downsample (:372)
    down = voxel_downsample(cloud_band, cfg.leaf_size, cfg.down_capacity)
    m = down.capacity

    # 3. normals (:392)
    down = estimate_normals(down, k=cfg.k_normals, viewpoint=jnp.zeros(3))
    normals = down.channel("normal")

    # 4. z-parallel normal selection (:396)
    z_par = jnp.abs(normals[:, 2]) >= jnp.cos(cfg.eps_angle)
    cand_mask = down.mask & z_par

    # 5. cluster candidate surface points (:401)
    labels = euclidean_cluster(
        down.padded_xyz(),
        cand_mask,
        cfg.clusters_growing_tolerance,
        k=cfg.cluster_knn,
        normals=normals,
        angle_threshold=cfg.region_angle_threshold,
    )
    members, sizes = top_clusters(
        labels, cand_mask, cfg.max_table_candidates, min_size=cfg.clusters_min_pts
    )

    # 6. per-candidate RANSAC plane, fitted for all candidates in parallel
    keys = jax.random.split(key, cfg.max_table_candidates)

    def fit_one(k, memb):
        plane, inl = fit_plane_ransac(
            down.padded_xyz(),
            memb,
            k,
            num_hypotheses=cfg.sac_hypotheses,
            threshold=cfg.sac_distance_threshold,
        )
        count = jnp.sum(inl.astype(jnp.int32))
        z_ok = jnp.abs(plane[2]) >= jnp.cos(cfg.eps_angle)
        ok = z_ok
        if cfg.wanted_table_center is not None:
            # one_table gate: candidate centroid near the wanted table
            w = inl.astype(jnp.float32)
            centroid = jnp.sum(
                down.padded_xyz()[:, :2] * w[:, None], axis=0
            ) / jnp.maximum(jnp.sum(w), 1.0)
            d2 = jnp.sum(
                (centroid - jnp.asarray(cfg.wanted_table_center)) ** 2
            )
            ok = ok & (d2 < cfg.max_sqr_dist_to_wanted_table)
        return plane, inl, jnp.where(ok, count, -1)

    planes, inlier_sets, counts = jax.vmap(fit_one)(keys, members)
    best = jnp.argmax(counts)
    plane = planes[best]
    # orient plane normal +z for a consistent "above table" side
    flip = jnp.sign(plane[2])
    flip = jnp.where(flip == 0, 1.0, flip)
    plane = plane * flip
    table_inliers = inlier_sets[best]
    found = counts[best] >= cfg.min_table_inliers

    # 7. table bounds + hull (:485)
    t_min, t_max = _masked_minmax(down.xyz, table_inliers)
    hull = radial_hull(down.xyz[:, :2], table_inliers, num_bins=cfg.hull_bins)

    # 8. object candidates above the table (findObjectClusters :254-341)
    xyz = down.padded_xyz()
    above = (
        down.mask
        & (xyz[:, 0] > t_min[0])
        & (xyz[:, 0] < t_max[0])
        & (xyz[:, 1] > t_min[1])
        & (xyz[:, 1] < t_max[1])
        & (xyz[:, 2] > t_max[2] + cfg.delta_z)
    )
    dist_to_plane = xyz @ plane[:3] + plane[3]
    proj = xyz - dist_to_plane[:, None] * plane[:3][None, :]
    above = above & in_radial_hull(hull, proj[:, :2])

    # 9. cluster objects
    obj_labels = euclidean_cluster(
        xyz, above, cfg.object_cluster_tolerance, k=cfg.cluster_knn
    )
    obj_masks, obj_sizes = top_clusters(
        obj_labels, above, cfg.max_objects, min_size=cfg.object_cluster_min_pts
    )

    # 10. support check: cluster must start near the table surface
    def obj_stats(memb):
        mn, mx = _masked_minmax(down.xyz, memb)
        w = memb.astype(jnp.float32)[:, None]
        c = jnp.sum(down.xyz * w, axis=0) / jnp.maximum(jnp.sum(w), 1.0)
        return mn, mx, c

    obj_min, obj_max, obj_centers = jax.vmap(obj_stats)(obj_masks)
    supported = obj_min[:, 2] <= t_max[2] + cfg.object_min_distance_from_table
    keep = supported & (obj_sizes > 0) & found
    obj_masks = obj_masks & keep[:, None]
    obj_sizes = jnp.where(keep, obj_sizes, 0)

    det = TableDetection(
        found=found,
        plane=plane,
        table_inliers=table_inliers & found,
        table_min=t_min,
        table_max=t_max,
        hull=hull,
        object_masks=obj_masks,
        object_sizes=obj_sizes,
        object_centers=obj_centers,
        object_min=obj_min,
        object_max=obj_max,
    )
    return det, down

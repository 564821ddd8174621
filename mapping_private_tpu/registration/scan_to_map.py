"""Scan-to-map registration — the incremental mapping loop.

The reference's `Registration` op chains scan-to-scan (the previous scan
becomes the next target, registration.cpp:167) so error compounds scan
over scan.  This module adds the production formulation: scans register
against an accumulated voxel-deduplicated MAP (drift stops compounding
through intermediate scans), keyframes enter a pose graph, and loop
closures relax the whole trajectory (registration/pose_graph.py).

Array design: the map is a fixed-capacity masked point set (static shapes —
insertion is concat → voxel-key sort → unique-first compaction, all
dense array ops), so the whole track step jits once and reruns at
constant cost regardless of map fill.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from mapping_private_tpu.core.cloud import PAD_COORD
from mapping_private_tpu.core.se3 import se3_apply, se3_compose, se3_inverse, se3_log
from mapping_private_tpu.ops.neighbors import _cell_key
from mapping_private_tpu.registration.icp import icp_point_to_plane

_KEY_SENTINEL = jnp.int32(1 << 30)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class VoxelMap:
    """Fixed-capacity world-frame map: one representative point per voxel."""

    xyz: jax.Array  # (M, 3)
    normals: jax.Array  # (M, 3)
    mask: jax.Array  # (M,)
    voxel_size: jax.Array  # scalar

    @staticmethod
    def empty(capacity: int, voxel_size: float) -> "VoxelMap":
        return VoxelMap(
            xyz=jnp.full((capacity, 3), PAD_COORD, jnp.float32),
            normals=jnp.zeros((capacity, 3), jnp.float32),
            mask=jnp.zeros((capacity,), bool),
            voxel_size=jnp.float32(voxel_size),
        )

    def count(self) -> jax.Array:
        return jnp.sum(self.mask.astype(jnp.int32))


@jax.jit
def integrate_scan(
    vmap_: VoxelMap,
    scan_xyz: jax.Array,
    scan_normals: jax.Array,
    scan_mask: jax.Array,
) -> VoxelMap:
    """Insert world-frame scan points; one point per voxel, existing map
    points win ties (stable first-occurrence after a composite-key sort).
    Overflow beyond capacity drops the newest points."""
    M = vmap_.xyz.shape[0]
    xyz = jnp.concatenate([vmap_.xyz, scan_xyz])
    nrm = jnp.concatenate([vmap_.normals, scan_normals])
    mask = jnp.concatenate([vmap_.mask, scan_mask])
    cell = jnp.floor(xyz / vmap_.voxel_size).astype(jnp.int32)
    keys = jnp.where(mask, _cell_key(cell), _KEY_SENTINEL)
    # stable sort keeps map entries (lower original index) ahead of scan
    order = jnp.argsort(keys, stable=True)
    ks = keys[order]
    first = jnp.concatenate([jnp.array([True]), ks[1:] != ks[:-1]])
    keep = first & (ks != _KEY_SENTINEL)
    # compact: winners first (stable), then truncate to capacity
    comp = jnp.argsort(~keep, stable=True)
    sel = order[comp][:M]
    keep_m = keep[comp][:M]
    return VoxelMap(
        xyz=jnp.where(keep_m[:, None], xyz[sel], PAD_COORD),
        normals=jnp.where(keep_m[:, None], nrm[sel], 0.0),
        mask=keep_m,
        voxel_size=vmap_.voxel_size,
    )


@dataclasses.dataclass
class TrackerConfig:
    map_capacity: int = 65536
    map_voxel: float = 0.02
    icp_iters: int = 15
    max_corr_dist: float = 0.3
    keyframe_trans: float = 0.10  # insert keyframe beyond this motion
    keyframe_rot: float = 0.17  # ~10°
    nn_backend: str = "auto"


class ScanToMapTracker:
    """Host-side orchestration; each track step is jitted device work."""

    def __init__(self, cfg: TrackerConfig = TrackerConfig()):
        self.cfg = cfg
        self.map: Optional[VoxelMap] = None
        self.pose = jnp.eye(4)
        self.keyframe_poses = [jnp.eye(4)]
        self.edges = []  # (i, j, Z_ij)

    def track(
        self,
        scan_xyz: jax.Array,
        scan_normals: jax.Array,
        scan_mask: jax.Array,
    ) -> Tuple[jax.Array, bool]:
        """Register one scan.  Returns (world pose (4,4), made_keyframe)."""
        cfg = self.cfg
        if self.map is None:
            self.map = VoxelMap.empty(cfg.map_capacity, cfg.map_voxel)
            world = se3_apply(self.pose, scan_xyz)
            self.map = integrate_scan(
                self.map, jnp.where(scan_mask[:, None], world, PAD_COORD),
                scan_normals, scan_mask,
            )
            return self.pose, True

        res = icp_point_to_plane(
            scan_xyz, scan_mask,
            self.map.xyz, self.map.mask, self.map.normals,
            init_T=self.pose,
            iters=cfg.icp_iters, max_corr_dist=cfg.max_corr_dist,
            nn_backend=cfg.nn_backend,
        )
        self.pose = res.transform
        # keyframe decision: motion since the last keyframe
        delta = se3_log(se3_compose(se3_inverse(self.keyframe_poses[-1]), self.pose))
        trans = float(jnp.linalg.norm(delta[:3]))
        rot = float(jnp.linalg.norm(delta[3:]))
        made_kf = trans > cfg.keyframe_trans or rot > cfg.keyframe_rot
        if made_kf:
            Z = se3_compose(se3_inverse(self.keyframe_poses[-1]), self.pose)
            self.edges.append((len(self.keyframe_poses) - 1,
                               len(self.keyframe_poses), Z))
            self.keyframe_poses.append(self.pose)
            world = se3_apply(self.pose, scan_xyz)
            nrm_w = scan_normals @ self.pose[:3, :3].T
            self.map = integrate_scan(
                self.map, jnp.where(scan_mask[:, None], world, PAD_COORD),
                nrm_w, scan_mask,
            )
        return self.pose, made_kf

    # -- checkpoint / resume (SURVEY §5.3-5.4: the reference loses all
    # in-memory state on crash; the tracker persists map + trajectory) ----
    def checkpoint(self, path: str) -> None:
        import numpy as np

        arrays = dict(
            pose=np.asarray(self.pose),
            keyframes=np.stack([np.asarray(p) for p in self.keyframe_poses]),
        )
        if self.map is not None:
            arrays.update(
                map_xyz=np.asarray(self.map.xyz),
                map_normals=np.asarray(self.map.normals),
                map_mask=np.asarray(self.map.mask),
                map_voxel=np.asarray(self.map.voxel_size),
            )
        if self.edges:
            arrays["edge_ij"] = np.asarray([[i, j] for i, j, _ in self.edges])
            arrays["edge_Z"] = np.stack([np.asarray(Z) for _, _, Z in self.edges])
        np.savez_compressed(path, **arrays)

    @staticmethod
    def restore(path: str, cfg: Optional[TrackerConfig] = None) -> "ScanToMapTracker":
        import numpy as np

        data = np.load(path)
        t = ScanToMapTracker(cfg or TrackerConfig())
        t.pose = jnp.asarray(data["pose"])
        t.keyframe_poses = [jnp.asarray(p) for p in data["keyframes"]]
        if "map_xyz" in data:
            t.map = VoxelMap(
                xyz=jnp.asarray(data["map_xyz"]),
                normals=jnp.asarray(data["map_normals"]),
                mask=jnp.asarray(data["map_mask"]),
                voxel_size=jnp.asarray(data["map_voxel"]),
            )
        if "edge_ij" in data:
            t.edges = [
                (int(i), int(j), jnp.asarray(Z))
                for (i, j), Z in zip(data["edge_ij"], data["edge_Z"])
            ]
        return t

    def add_loop_closure(self, i: int, j: int, Z_ij: jax.Array) -> None:
        self.edges.append((i, j, Z_ij))

    def relax(self, iters: int = 8) -> jax.Array:
        """Pose-graph relaxation over the keyframes; returns (K,4,4)."""
        from mapping_private_tpu.registration.pose_graph import optimize_pose_graph

        K = len(self.keyframe_poses)
        if K < 2 or not self.edges:
            return jnp.stack(self.keyframe_poses)
        poses = jnp.stack(self.keyframe_poses)
        edges = jnp.asarray([[i, j] for i, j, _ in self.edges], jnp.int32)
        meas = jnp.stack([Z for _, _, Z in self.edges])
        relaxed, _ = optimize_pose_graph(poses, edges, meas, iters=iters)
        self.keyframe_poses = [relaxed[k] for k in range(K)]
        self.pose = self.keyframe_poses[-1]
        return relaxed

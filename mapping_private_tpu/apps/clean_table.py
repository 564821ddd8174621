"""Tabletop pick-and-place planning — `ias_pr2_pick_and_place_demos`.

The reference's clean_table.py drives the WG object-manipulation stack on
a PR2: detect the table, iterate objects, grasp each, drop it in a bin.
The robot-arm execution is hardware-specific; the perception/planning
content — detect → per-object grasp pose → ordered plan — is what this
CLI reproduces: each detected cluster gets a top-down grasp at its
centroid (gripper yaw aligned with the object's minor box axis, pregrasp
standoff above), and the plan orders objects nearest-first.
"""
from __future__ import annotations

import argparse
import json

import numpy as np


def grasp_pose_for_cluster(points: np.ndarray, standoff: float = 0.10) -> dict:
    """Top-down grasp: position above the centroid, gripper yaw across the
    object's minor footprint axis (so the fingers straddle the thin side)."""
    import jax.numpy as jnp
    from mapping_private_tpu.core.cloud import PointCloud
    from mapping_private_tpu.fit.box import fit_box_zup

    cloud = PointCloud.from_numpy(np.asarray(points, np.float32))
    box = fit_box_zup(cloud.padded_xyz(), cloud.mask)
    center = np.asarray(box.center)
    axes = np.asarray(box.axes)
    ext = np.asarray(box.extents)
    minor = axes[int(np.argmin(ext[:2]))]  # thinner footprint axis
    yaw = float(np.arctan2(minor[1], minor[0]))
    top_z = center[2] + ext[2] / 2
    return dict(
        position=[float(center[0]), float(center[1]), float(top_z)],
        pregrasp=[float(center[0]), float(center[1]), float(top_z + standoff)],
        yaw=yaw,
        width=float(np.min(ext[:2])),
        extents=ext.tolist(),
    )


def plan_clean_table(pcd_path: str, bin_position=(0.0, -0.6, 0.5)) -> dict:
    import jax
    from mapping_private_tpu.io.pcd import load_pcd
    from mapping_private_tpu.models.table_detector import (
        TableDetectorConfig, detect_table,
    )

    cloud = load_pcd(pcd_path, capacity_bucket=2048)
    det, down = detect_table(cloud, jax.random.PRNGKey(0), TableDetectorConfig())
    if not bool(det.found):
        return dict(table_found=False, grasps=[])
    xyz = np.asarray(down.xyz)
    grasps = []
    for oi in range(det.object_masks.shape[0]):
        if int(det.object_sizes[oi]) <= 0:
            continue
        pts = xyz[np.asarray(det.object_masks[oi])]
        g = grasp_pose_for_cluster(pts)
        g["object"] = oi
        g["place"] = list(bin_position)
        grasps.append(g)
    # nearest-first execution order (the demo's pick ordering)
    grasps.sort(key=lambda g: np.hypot(g["position"][0], g["position"][1]))
    return dict(
        table_found=True,
        table_height=float(np.asarray(det.table_min)[2]),
        grasps=grasps,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("pcd")
    ap.add_argument("--bin", nargs=3, type=float, default=[0.0, -0.6, 0.5])
    args = ap.parse_args(argv)
    print(json.dumps(plan_clean_table(args.pcd, tuple(args.bin))))
    return 0


if __name__ == "__main__":
    from mapping_private_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    raise SystemExit(main())

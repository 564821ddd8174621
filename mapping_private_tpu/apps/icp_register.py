"""Pairwise/sequence scan registration CLI — `cloud_algos Registration`.

Registers consecutive PCDs with point-to-plane ICP and (for 3+ scans)
relaxes the chain with the pose-graph optimizer; prints per-pair
transforms and the final trajectory.
"""
from __future__ import annotations

import argparse
import json

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("pcds", nargs="+")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--max-corr-dist", type=float, default=0.25)
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    if len(args.pcds) < 2:
        ap.error("need at least two PCDs")

    import jax.numpy as jnp
    from mapping_private_tpu.io.pcd import load_pcd
    from mapping_private_tpu.ops.normals import estimate_normals
    from mapping_private_tpu.registration.icp import icp_point_to_plane
    from mapping_private_tpu.registration.pose_graph import optimize_pose_graph

    clouds = [load_pcd(p) for p in args.pcds]
    cap = max(c.capacity for c in clouds)
    transforms = []
    for k in range(len(clouds) - 1):
        src, tgt = clouds[k + 1], clouds[k]
        tgt_n = estimate_normals(tgt, k=12)
        res = icp_point_to_plane(
            src.padded_xyz(), src.mask,
            tgt.padded_xyz(), tgt.mask, tgt_n.channel("normal"),
            iters=args.iters, max_corr_dist=args.max_corr_dist,
        )
        transforms.append(np.asarray(res.transform))
    poses = [np.eye(4, dtype=np.float32)]
    for T in transforms:
        poses.append(poses[-1] @ T)
    if len(clouds) > 2:
        edges = jnp.asarray(
            [[k, k + 1] for k in range(len(clouds) - 1)], jnp.int32
        )
        meas = jnp.asarray(np.stack(transforms))
        relaxed, _ = optimize_pose_graph(
            jnp.asarray(np.stack(poses)), edges, meas, iters=5
        )
        poses = [np.asarray(p) for p in relaxed]
    out = {
        "pairwise": [T.tolist() for T in transforms],
        "trajectory": [np.asarray(p).tolist() for p in poses],
    }
    if args.json:
        print(json.dumps(out))
    else:
        for k, p in enumerate(poses):
            t = np.asarray(p)[:3, 3]
            print(f"scan {k}: t = ({t[0]:+.4f}, {t[1]:+.4f}, {t[2]:+.4f})")
    return 0


if __name__ == "__main__":
    from mapping_private_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    raise SystemExit(main())

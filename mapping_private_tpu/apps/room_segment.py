"""Room segmentation CLI — `pointcloud_segmentation` + `wall_filter`.

Labels floor/ceiling/walls in a room PCD; optionally writes the filtered
cloud with walls removed (the wall_filter node's output topic) and a
labeled PCD with a 'segment' channel (the reference's PointSegmentation
point type).
"""
from __future__ import annotations

import argparse
import json

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("pcd")
    ap.add_argument("--z-floor", type=float, default=0.1)
    ap.add_argument("--z-ceiling", type=float, default=2.7)
    ap.add_argument("--max-walls", type=int, default=4)
    ap.add_argument("--out-labeled", default=None)
    ap.add_argument("--out-filtered", default=None,
                    help="cloud with wall points removed (wall_filter)")
    args = ap.parse_args(argv)

    import jax
    from mapping_private_tpu.io.pcd import load_pcd, save_pcd
    from mapping_private_tpu.models.room_segmentation import (
        RoomSegmentationConfig, segment_room, wall_filter,
    )

    cfg = RoomSegmentationConfig(
        z_floor=args.z_floor, z_ceiling=args.z_ceiling,
        max_walls=args.max_walls,
    )
    cloud = load_pcd(args.pcd, capacity_bucket=2048)
    seg = segment_room(cloud, jax.random.PRNGKey(0), cfg)
    lab = np.asarray(seg.labels)
    live = np.asarray(cloud.mask)
    counts = {
        "floor": int((lab[live] == 1).sum()),
        "ceiling": int((lab[live] == 2).sum()),
        "walls": int((lab[live] >= 3).sum()),
        "unlabeled": int((lab[live] == 0).sum()),
    }
    if args.out_labeled:
        xyz = np.asarray(cloud.xyz)[live]
        save_pcd(args.out_labeled, {"xyz": xyz, "segment": lab[live].astype(np.float32)})
    if args.out_filtered:
        filt = wall_filter(cloud, jax.random.PRNGKey(1), cfg)
        m = np.asarray(filt.mask)
        save_pcd(args.out_filtered, {"xyz": np.asarray(filt.xyz)[m]})
    print(json.dumps(dict(
        counts=counts,
        wall_planes=[np.asarray(p).tolist() for p in seg.wall_planes],
    )))
    return 0


if __name__ == "__main__":
    from mapping_private_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    raise SystemExit(main())

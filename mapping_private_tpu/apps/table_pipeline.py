"""Tabletop perception pipeline CLI — `dyn_obj_store/table_pipeline.launch`.

Runs the reference's end-to-end chain on PCD files instead of ROS topics
(SURVEY §3.1): box filter → statistical denoise → table detection
(downsample/normals/z-gate/cluster/RANSAC/hull/objects) → TableMemory
update (matching, reconstruction, naming) → belief state out.
"""
from __future__ import annotations

import argparse
import json

import numpy as np


def run_pipeline(paths, box=None, checkpoint=None, resume=None, verbose=True):
    import jax
    import jax.numpy as jnp
    from mapping_private_tpu.io.pcd import load_pcd
    from mapping_private_tpu.ops.filters import box_filter, remove_statistical_outliers
    from mapping_private_tpu.models.table_detector import (
        TableDetectorConfig, detect_table,
    )
    from mapping_private_tpu.models.table_memory import TableMemory

    mem = TableMemory.restore(resume) if resume else TableMemory()
    key = jax.random.PRNGKey(0)
    cfg = TableDetectorConfig()
    for stamp, path in enumerate(paths):
        cloud = load_pcd(path)
        if box is not None:
            lo, hi = box[:3], box[3:]
            cloud = box_filter(cloud, lo, hi)
        cloud, valid = remove_statistical_outliers(cloud, k=20, alpha=2.0,
                                                   min_nr_pts=100)
        if not bool(valid):
            if verbose:
                print(f"{path}: denoise output invalid, skipped")
            continue
        key, sub = jax.random.split(key)
        det, down = detect_table(cloud, sub, cfg)
        if not bool(det.found):
            if verbose:
                print(f"{path}: no table found")
            continue
        # collect object clusters as host arrays
        xyz = np.asarray(down.xyz)
        clusters = []
        for oi in range(det.object_masks.shape[0]):
            m = np.asarray(det.object_masks[oi])
            if int(det.object_sizes[oi]) > 0:
                clusters.append(xyz[m])
        hull_xy = xyz[np.asarray(det.table_inliers)][:, :2]
        height = float(np.asarray(det.table_min)[2])
        key, sub = jax.random.split(key)
        tid = mem.update(hull_xy, height, clusters, stamp=float(stamp), key=sub)
        if verbose:
            print(f"{path}: table {tid}, {len(clusters)} objects")
    if checkpoint:
        mem.checkpoint(checkpoint)
    return mem


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("pcds", nargs="+")
    ap.add_argument("--box", nargs=6, type=float, default=None,
                    help="min_x min_y min_z max_x max_y max_z clip")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--resume", default=None)
    ap.add_argument("--dump-viz", default=None, metavar="DIR",
                    help="write the belief-state markers JSON (the analog "
                         "of TableMemory's PolygonalMap/PositionStringList "
                         "publications, table_memory.cpp:1222-1260)")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    mem = run_pipeline(args.pcds, args.box, args.checkpoint, args.resume,
                       verbose=not args.json)
    if args.dump_viz:
        import os

        from mapping_private_tpu.io.viz import save_markers_json, table_memory_viz

        os.makedirs(args.dump_viz, exist_ok=True)
        mpath = os.path.join(args.dump_viz, "table_memory_markers.json")
        save_markers_json(mpath, table_memory_viz(mem))
        if not args.json:
            print(f"viz: {mpath}")
    print(json.dumps(mem.belief_state(), indent=None if args.json else 2))
    return 0


if __name__ == "__main__":
    from mapping_private_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    raise SystemExit(main())

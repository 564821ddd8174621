"""Object-classification benchmark harness — `color_feature_classification`.

Replaces the reference's computeFeature / computeSubspace_from_file /
test_classify_from_file executables and the calcRate.sh accuracy scripts
(color_feature_classification/README:1-40, scripts/demos/{all.sh,
2.test_classify.sh,calcRate.sh}): compute per-view features over the
63-object Kinect corpus, train one PCA subspace per object, classify every
view by maximum subspace projection, report the rate table.

Feature types mirror the reference's c/d/g/r switches
(test/computeFeature.cpp:40-160, dims per the 2.leave_one_out.sh banner):
  c → ColorCHLAC-981 (rotation-variant)
  d → GRSD-20 ++ ColorCHLAC-981 (1001)
  g → GRSD-20
  r → GRSD-20 ++ ColorCHLAC-117 (137, rotation-invariant)

The full reference-protocol evaluation (leave-one-out, SVM) lives in
classify/evaluate.py; results: EVALUATION.md.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

DEFAULT_DATA = "/root/reference/color_feature_classification/demos/data"


def compute_feature(path: str, feature_type: str = "d") -> np.ndarray:
    from mapping_private_tpu.classify.evaluate import (
        compute_feature as _compute,
    )

    return _compute(path, feature_type)


def corpus_views(
    data_dir: str, objects: Optional[Sequence[str]] = None,
    max_views: int = 0,
) -> Dict[str, List[str]]:
    dirs = sorted(d for d in os.listdir(data_dir) if d.startswith("obj"))
    if objects:
        dirs = [d for d in dirs if d in set(objects)]
    out = {}
    for d in dirs:
        views = sorted(glob.glob(os.path.join(data_dir, d, "*.pcd")))
        if max_views:
            views = views[:max_views]
        out[d] = views
    return out


def classification_rate(
    data_dir: str = DEFAULT_DATA,
    feature_type: str = "d",
    dim_subspace: int = 5,
    objects: Optional[Sequence[str]] = None,
    max_views: int = 0,
    leave_one_out: bool = False,
    verbose: bool = False,
) -> Tuple[float, Dict[str, float]]:
    """Train per-object subspaces and classify every view.

    Returns (overall rate, per-object rates).  leave_one_out excludes the
    query view from its class's training set (2.leave_one_out.sh)."""
    from mapping_private_tpu.classify import train_subspaces, classify_subspace
    import jax.numpy as jnp

    views = corpus_views(data_dir, objects, max_views)
    names = sorted(views)
    feats = {
        n: np.stack([compute_feature(p, feature_type) for p in views[n]])
        for n in names
    }
    per_obj: Dict[str, float] = {}
    correct_total = 0
    count_total = 0
    if not leave_one_out:
        clf = train_subspaces([feats[n] for n in names], dim_subspace)
        for ci, n in enumerate(names):
            pred, _ = classify_subspace(clf, jnp.asarray(feats[n]))
            ok = (np.asarray(pred) == ci).sum()
            per_obj[n] = ok / len(feats[n])
            correct_total += int(ok)
            count_total += len(feats[n])
    else:
        for ci, n in enumerate(names):
            ok = 0
            for vi in range(len(feats[n])):
                train = [
                    np.delete(feats[m], vi, axis=0) if m == n else feats[m]
                    for m in names
                ]
                clf = train_subspaces(train, dim_subspace)
                pred, _ = classify_subspace(
                    clf, jnp.asarray(feats[n][vi:vi+1])
                )
                ok += int(np.asarray(pred)[0] == ci)
            per_obj[n] = ok / len(feats[n])
            correct_total += ok
            count_total += len(feats[n])
    rate = correct_total / max(count_total, 1)
    if verbose:
        for n in names:
            print(f"{n}: {per_obj[n]*100:.1f}%")
        print(f"overall: {rate*100:.2f}% ({correct_total}/{count_total})")
    return rate, per_obj


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("command", choices=["rate"])
    ap.add_argument("--data-dir", default=DEFAULT_DATA)
    ap.add_argument("--feature", default="d", choices=list("cdgr"))
    ap.add_argument("--dim", type=int, default=5)
    ap.add_argument("--objects", nargs="*", default=None)
    ap.add_argument("--max-views", type=int, default=0)
    ap.add_argument("--leave-one-out", action="store_true")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    rate, per_obj = classification_rate(
        args.data_dir, args.feature, args.dim, args.objects,
        args.max_views, args.leave_one_out, verbose=not args.json,
    )
    if args.json:
        print(json.dumps({"rate": rate, "per_object": per_obj}))
    return 0


if __name__ == "__main__":
    from mapping_private_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    raise SystemExit(main())

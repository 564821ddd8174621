"""Reference-protocol classification evaluation over the 63-object corpus.

Implements the color_feature_classification demo workflow
(color_feature_classification/README:1-13, scripts/demos/{all.sh,
2.leave_one_out.sh,calcRate.sh}) natively in JAX:

  0.computeFeature.sh  → extract_corpus_features (per-view descriptors;
      feature types per test/computeFeature.cpp and the leave_one_out
      banner dims: c=981 ColorCHLAC, d=1001 GRSD-20++ColorCHLAC-981,
      g=20 GRSD, r=137 GRSD-20++ColorCHLAC-117)
  0.compute_compress_axis.sh → one global PCA compression axis
  1.compute_subspace.sh → per-object PCA subspaces; for c/d the training
      set is augmented with the 24 proper 90°-rotation permutations of
      the 981 part (computeFeature.cpp TRAIN_90_ROTATION block :120-160;
      the GRSD-20 part is invariant under 90° rotations — the 26-offset
      transition matrix is a rotation-symmetric set)
  2.leave_one_out.sh   → per (object, view) fold: ONLY the test object's
      subspace is retrained on its other 23 views (the reference swaps
      in a fold model for $num and leaves the other 62 untouched);
      classification = max ‖W_c f‖/‖f‖ over the 63 subspaces
  calcRate.sh          → per-object and overall rates

All 63×24 fold subspaces are computed as one vmapped eigh batch instead
of the reference's 1,512 sequential process invocations.

Protocol deviation (documented): the reference trains on per-subdivision
histograms (-subdiv 7 -offset 2); this harness uses whole-object
descriptors for train and test.  Everything else follows the scripts.
"""
from __future__ import annotations

import dataclasses
import functools
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

DEFAULT_DATA = "/root/reference/color_feature_classification/demos/data"
FEATURE_DIMS = {"c": 981, "d": 1001, "g": 20, "r": 137}
# subspace protocol per 2.leave_one_out.sh: (compress dim or None, sub dim)
PROTOCOL = {"c": (100, 50), "d": (100, 50), "g": (None, 10), "r": (100, 50)}


def compute_all_features(path: str) -> Dict[str, np.ndarray]:
    """One view → all four descriptors in one pass (d = g ++ c and
    r = g ++ ColorCHLAC-117, so voxelization, normals and RSD types are
    shared; grid dims floored to 32 so one jit compilation serves the
    whole corpus)."""
    from mapping_private_tpu.io.pcd import load_pcd
    from mapping_private_tpu.features import (
        voxelize_for_features, voxel_types, grsd20_from_types,
    )
    from mapping_private_tpu.features.colorchlac import (
        colorchlac117, colorchlac981,
    )

    cloud = load_pcd(path, capacity_bucket=2048)
    grid = voxelize_for_features(cloud, dim_floor=32)
    types = voxel_types(cloud, grid)
    g = np.asarray(grsd20_from_types(types, grid.occupancy()))
    c = np.asarray(colorchlac981(grid))
    r117 = np.asarray(colorchlac117(grid))
    return {
        "g": g,
        "c": c,
        "d": np.concatenate([g, c]),
        "r": np.concatenate([g, r117]),
    }


def compute_feature(path: str, feature_type: str) -> np.ndarray:
    """One view → descriptor, types per the reference banner dims."""
    return compute_all_features(path)[feature_type]


def extract_corpus_features(
    data_dir: str = DEFAULT_DATA,
    feature_type: str = "g",
    cache_path: Optional[str] = None,
    objects: Optional[Sequence[str]] = None,
    max_views: int = 0,
    verbose: bool = False,
) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """(features (N, D), labels (N,), object names).  Cached as npz."""
    if cache_path and os.path.exists(cache_path):
        z = np.load(cache_path, allow_pickle=True)
        return z["features"], z["labels"], list(z["names"])
    F, L, dirs = extract_corpus_features_all(
        data_dir, None, objects, max_views, verbose
    )
    Ft = F[feature_type]
    if cache_path:
        np.savez_compressed(cache_path, features=Ft, labels=L, names=dirs)
    return Ft, L, dirs


def extract_corpus_features_all(
    data_dir: str = DEFAULT_DATA,
    cache_path: Optional[str] = None,
    objects: Optional[Sequence[str]] = None,
    max_views: int = 0,
    verbose: bool = False,
) -> Tuple[Dict[str, np.ndarray], np.ndarray, List[str]]:
    """All four feature types in one corpus pass.  Cached as one npz with
    keys features_c/d/g/r."""
    if cache_path and os.path.exists(cache_path):
        z = np.load(cache_path, allow_pickle=True)
        return (
            {t: z[f"features_{t}"] for t in "cdgr"},
            z["labels"], list(z["names"]),
        )
    import glob
    import time

    dirs = sorted(d for d in os.listdir(data_dir) if d.startswith("obj"))
    if objects:
        dirs = [d for d in dirs if d in set(objects)]
    feats = {t: [] for t in "cdgr"}
    labels = []
    for ci, d in enumerate(dirs):
        t0 = time.time()
        views = sorted(glob.glob(os.path.join(data_dir, d, "*.pcd")))
        if max_views:
            views = views[:max_views]
        for p in views:
            out = compute_all_features(p)
            for t in "cdgr":
                feats[t].append(out[t])
            labels.append(ci)
        if verbose:
            print(f"{d}: {len(views)} views {time.time()-t0:.1f}s",
                  flush=True)
    F = {t: np.stack(feats[t]).astype(np.float32) for t in "cdgr"}
    L = np.asarray(labels, np.int32)
    if cache_path:
        np.savez_compressed(
            cache_path, labels=L, names=dirs,
            **{f"features_{t}": F[t] for t in "cdgr"},
        )
    return F, L, dirs


@functools.lru_cache(maxsize=None)
def _rotation_orbit_perms_981() -> np.ndarray:
    """(24, 981) permutations: the full proper-rotation orbit generated by
    the x/y/z 90° feature permutations (rotate_feature_981)."""
    from mapping_private_tpu.features.colorchlac import (
        _rotation_permutation_981,
    )

    gens = [_rotation_permutation_981(m) for m in ("x", "y", "z")]
    seen = {tuple(range(981)): np.arange(981)}
    frontier = [np.arange(981)]
    while frontier:
        nxt = []
        for p in frontier:
            for g in gens:
                q = p[g]
                t = tuple(q)
                if t not in seen:
                    seen[t] = q
                    nxt.append(q)
        frontier = nxt
    perms = np.stack(list(seen.values()))
    assert perms.shape[0] == 24, perms.shape
    return perms


def _augment_rotations(F: np.ndarray, L: np.ndarray, feature_type: str):
    """24× rotation augmentation for c (981) / d (20++981) training sets."""
    if feature_type not in ("c", "d"):
        return F, L
    perms = _rotation_orbit_perms_981()
    off = 20 if feature_type == "d" else 0
    out = []
    for p in perms:
        f = F.copy()
        f[:, off:] = F[:, off:][:, p]
        out.append(f)
    return np.concatenate(out), np.tile(L, len(perms))


@dataclasses.dataclass
class EvalResult:
    rate: float
    per_object: Dict[str, float]
    n_correct: int
    n_total: int


def leave_one_out_subspace(
    F: np.ndarray,
    L: np.ndarray,
    names: Sequence[str],
    feature_type: str,
    verbose: bool = False,
    whiten: bool = False,
    bin_normalize: bool = False,
) -> EvalResult:
    """2.leave_one_out.sh semantics, fully batched.

    ``whiten`` applies the reference compressFeature's FILE_MODE
    WHITENING (each compressed coordinate divided by sqrt of its
    compress-axis eigenvalue); ``bin_normalize`` applies the
    0.calcNormalization per-bin max scaling.  The recorded headline runs
    with both off — see EVALUATION.md for the measured effect and the
    train-side oracle (tests/test_subspace_train_oracle.py) anchoring
    both variants' core computation."""
    import jax
    import jax.numpy as jnp

    compress_dim, sub_dim = PROTOCOL[feature_type]
    C = len(names)
    if bin_normalize:
        F = F / np.maximum(F.max(0), 1e-12)
    Fa, La = _augment_rotations(F, L, feature_type)
    Xall = jnp.asarray(Fa)

    # global compression axis (0.compute_compress_axis.sh): PCA over the
    # full (augmented) training corpus, WITH mean subtraction disabled —
    # computeSubspace_from_file passes the features straight to PCA::solve
    # whose mean is subtracted internally but the projection used at
    # classify time is axis^T * f (no centering), pca.cpp:73-107.
    def pca_axes(X, dim):
        cov = X.T @ X
        w, v = jnp.linalg.eigh(cov)
        return v[:, ::-1][:, :dim]  # descending eigenvalue order

    if compress_dim is not None:
        cov = Xall.T @ Xall
        w_all, v_all = jnp.linalg.eigh(cov)
        comp = v_all[:, ::-1][:, :compress_dim]  # (D, dim)
        if whiten:
            scale = 1.0 / jnp.sqrt(
                jnp.maximum(w_all[::-1][:compress_dim], 1e-12))
            comp = comp * scale[None, :]
        Fc = np.asarray(jnp.asarray(F) @ comp)
        Fac = np.asarray(Xall @ comp)
    else:
        Fc, Fac = F, np.asarray(Xall)

    aug = len(Fac) // len(F)
    V = np.max(np.bincount(L))  # views per object (24)
    D = Fc.shape[1]

    # training tensor (C, V*aug, D) grouped per object
    per_obj = np.zeros((C, V * aug, D), np.float32)
    for c in range(C):
        rows = np.concatenate([
            np.nonzero(L == c)[0] + r * len(F) for r in range(aug)
        ])
        per_obj[c] = Fac[rows]

    X = jnp.asarray(per_obj)

    @jax.jit
    def full_subspaces(X):
        def one(Xc):
            return pca_axes(Xc, sub_dim)
        return jax.vmap(one)(X)  # (C, D, sub)

    W_full = full_subspaces(X)

    # fold subspaces: for object c, view v → train on views != v (all
    # rotation copies of view v removed)
    view_of_row = np.tile(np.arange(V), aug)

    @jax.jit
    def fold_subspaces(X):
        def one_obj(Xc):
            def one_fold(v):
                m = (jnp.asarray(view_of_row) != v).astype(Xc.dtype)
                Xm = Xc * m[:, None]
                return pca_axes(Xm, sub_dim)
            return jax.vmap(one_fold)(jnp.arange(V))
        return jax.vmap(one_obj)(X)  # (C, V, D, sub)

    W_fold = fold_subspaces(X)

    # classify: test feature = UNaugmented view feature
    Ft = jnp.asarray(Fc)

    @jax.jit
    def classify(Ft, W_full, W_fold, L):
        # sims vs full subspaces (N, C)
        proj = jnp.einsum("nd,cds->ncs", Ft, W_full)
        sims = jnp.linalg.norm(proj, axis=-1)
        # own-class sim replaced by the fold subspace of (own class, view)
        N = Ft.shape[0]
        vidx = jnp.arange(N) % V
        Wf_own = W_fold[L, vidx]  # (N, D, sub)
        own = jnp.linalg.norm(jnp.einsum("nd,nds->ns", Ft, Wf_own), axis=-1)
        sims = sims.at[jnp.arange(N), L].set(own)
        den = jnp.maximum(jnp.linalg.norm(Ft, axis=-1, keepdims=True), 1e-20)
        return jnp.argmax(sims / den, axis=-1)

    pred = np.asarray(classify(Ft, W_full, W_fold, jnp.asarray(L)))
    per_object = {}
    for c, n in enumerate(names):
        sel = L == c
        per_object[n] = float((pred[sel] == c).mean())
    n_ok = int((pred == L).sum())
    res = EvalResult(n_ok / len(L), per_object, n_ok, len(L))
    if verbose:
        for n in names:
            print(f"{n}: {per_object[n]*100:.1f}%")
        print(f"overall: {res.rate*100:.2f}% ({n_ok}/{len(L)})")
    return res


def crossval_svm(
    F: np.ndarray,
    L: np.ndarray,
    names: Sequence[str],
    n_folds: int = 4,
    C: float = 10.0,
    verbose: bool = False,
) -> EvalResult:
    """View-held-out cross-validation with the kernel OvO SVM trainer
    (classify/train_svm.py) — the reference's scripts/svm flow trains
    libsvm on the same per-view features.  Fold k holds out views
    v ≡ k (mod n_folds) of every object."""
    from mapping_private_tpu.classify.train_svm import (
        predict_ovo, train_svc_ovo,
    )

    V = np.max(np.bincount(L)) if len(L) else 0
    vidx = np.arange(len(L)) % V
    nC = len(names)
    # scale to [0,1] per dim over the training corpus (libsvm practice)
    mx = np.maximum(np.abs(F).max(axis=0), 1e-12)
    Fs = F / mx
    pred = np.zeros(len(L), np.int64)
    for k in range(n_folds):
        te = vidx % n_folds == k
        m = train_svc_ovo(Fs[~te], L[~te], nC, C=C)
        lab, _ = predict_ovo(m, Fs[te])
        pred[te] = np.asarray(lab)
        if verbose:
            print(f"fold {k}: {float((pred[te]==L[te]).mean())*100:.1f}%",
                  flush=True)
    per_object = {
        n: float((pred[L == c] == c).mean()) for c, n in enumerate(names)
    }
    n_ok = int((pred == L).sum())
    return EvalResult(n_ok / len(L), per_object, n_ok, len(L))


def subspace_split_protocol(
    Xtr: np.ndarray,
    Ltr: np.ndarray,
    Xte: np.ndarray,
    n_class: int,
    sub_dim: int,
    compress_dim: Optional[int] = None,
    whiten: bool = True,
):
    """Train/test-split subspace classification with the reference's exact
    option semantics — the anchorable core of the LOO protocol.

    Mirrors computeSubspace_from_file.cpp:94-132 (global compress axis =
    mean-free PCA over ALL training rows; compressFeature whitens each
    projected coordinate by 1/sqrt(variance) when FILE_MODE WHITENING) +
    test_classify_from_file.cpp:59-152 classify_by_subspace (per-class
    mean-free PCA subspaces; similarity |W_c^T y|^2 / |y|^2, argmax).
    Whitening by eigenvalues of X^T X differs from the reference's
    X^T X / N only by a uniform sqrt(N) scale on y, which cancels in the
    similarity ratio.  Returns (pred (N,) int, sims (N, C))."""
    import jax.numpy as jnp

    def pca_axes_vals(X, dim):
        cov = X.T @ X
        w, v = jnp.linalg.eigh(cov)
        return v[:, ::-1][:, :dim], w[::-1][:dim]

    Xtr = jnp.asarray(Xtr, jnp.float32)
    Xte = jnp.asarray(Xte, jnp.float32)
    if compress_dim is not None:
        comp, var = pca_axes_vals(Xtr, compress_dim)
        Xtr = Xtr @ comp
        Xte = Xte @ comp
        if whiten:
            scale = 1.0 / jnp.sqrt(jnp.maximum(var, 1e-30))
            Xtr = Xtr * scale
            Xte = Xte * scale
    W = []
    for c in range(n_class):
        Xc = Xtr[np.asarray(Ltr) == c]
        W.append(pca_axes_vals(Xc, sub_dim)[0])
    W = jnp.stack(W)  # (C, D, sub)
    proj = jnp.einsum("nd,cds->ncs", Xte, W)
    sims = jnp.sum(proj * proj, axis=-1)
    den = jnp.maximum(jnp.sum(Xte * Xte, axis=-1, keepdims=True), 1e-20)
    sims = sims / den
    return np.asarray(jnp.argmax(sims, axis=-1)), np.asarray(sims)

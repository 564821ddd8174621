"""Point Feature Histograms — `PointFeatureHistogram` JAX-native.

Replaces cloud_algos/src/pfh.cpp (+ the pair-feature math of
include/cloud_algos/pfh.h:105-235): per point, the star topology over its
radius neighborhood — pair features (α, β, γ, δ) between the center and
each neighbor — quantized into either a combined quantum^features joint
histogram or quantum·features separate histograms, each pair contributing
100/neighborhood_size (the reference's `npsqr` increment, pfh.cpp:208).

Pair features (pfh.h getPointPairFeatures, normalizations :218-229):
  source/target chosen so the source normal makes the smaller angle with
  the connecting line (check_flip, :135-154);
  u = n_source; v = (p_t−p_s)×u / ‖·‖; w = u×v;
  γ = u·(p_t−p_s)/δ         → (γ+1)/2       ∈ [0,1]
  β = v·n_target            → (β+1)/2
  α = atan2(w·n_t, u·n_t)   → (α+π)/(2π)
  δ = ‖p_t−p_s‖             → δ/(2·radius)

The reference's serial per-point kd-tree loop ("TODO parallelize!") is one
batched kNN gather + vectorized pair features + a scatter-add histogram.
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from mapping_private_tpu.ops.neighbors import knn_bruteforce


def pair_features(
    p_s: jax.Array, n_s: jax.Array, p_t: jax.Array, n_t: jax.Array,
    check_flip: bool = True,
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array, jax.Array]:
    """Batched (α, β, γ, δ, valid) over (..., 3) source/target pairs,
    all normalized to [0, 1) except δ (returned in metres)."""
    d = p_t - p_s
    delta = jnp.linalg.norm(d, axis=-1)
    ok = delta > 1e-9
    dn = d / jnp.maximum(delta[..., None], 1e-30)

    g_fwd = jnp.sum(n_s * dn, axis=-1)  # source = s
    g_bwd = -jnp.sum(n_t * dn, axis=-1)  # source = t (flipped)
    if check_flip:
        flip = jnp.arccos(jnp.clip(g_fwd, -1, 1)) > jnp.arccos(jnp.clip(g_bwd, -1, 1))
    else:
        flip = jnp.ones(delta.shape, bool)
    ns = jnp.where(flip[..., None], n_t, n_s)
    nt = jnp.where(flip[..., None], n_s, n_t)
    dvec = jnp.where(flip[..., None], -dn, dn)
    gamma = jnp.where(flip, g_bwd, g_fwd)

    u = ns
    v = jnp.cross(dvec, u)
    vlen = jnp.linalg.norm(v, axis=-1)
    ok = ok & (vlen > 1e-9)
    v = v / jnp.maximum(vlen[..., None], 1e-30)
    w = jnp.cross(u, v)
    beta = jnp.sum(v * nt, axis=-1)
    alpha = jnp.arctan2(jnp.sum(w * nt, axis=-1), jnp.sum(u * nt, axis=-1))

    alpha = (alpha + jnp.pi) / (2.0 * jnp.pi)
    beta = (beta + 1.0) / 2.0
    gamma = (gamma + 1.0) / 2.0
    return alpha, beta, gamma, delta, ok


def pfh_histograms(
    xyz: jax.Array,
    normals: jax.Array,
    mask: jax.Array,
    radius: float = 0.02,
    k: int = 16,
    quantum: int = 4,
    use_dist: bool = False,
    combine: bool = True,
    check_flip: bool = True,
) -> jax.Array:
    """(N, nr_bins) per-point PFH.

    nr_bins = quantum^features if combine else quantum·features
    (pfh.cpp:98-106); features = 4 with use_dist else 3.  Combined-bin
    index order matches the reference's a_/b_/c_/d_ assignment (:113-120).
    """
    nr_features = 4 if use_dist else 3
    nr_bins = quantum ** nr_features if combine else quantum * nr_features
    n_pts = xyz.shape[0]

    idx, sq = knn_bruteforce(xyz, xyz, mask, k=k, exclude_self=True)
    valid = (idx >= 0) & (sq <= radius * radius) & mask[:, None]
    idx_c = jnp.maximum(idx, 0)
    p_t = xyz[idx_c]
    n_t = normals[idx_c]
    a, b, g, d, ok = pair_features(
        xyz[:, None, :], normals[:, None, :], p_t, n_t, check_flip=check_flip
    )
    ok = ok & valid  # (N, k)

    q = quantum
    fa = jnp.clip(jnp.floor(q * a), 0, q - 1).astype(jnp.int32)
    fb = jnp.clip(jnp.floor(q * b), 0, q - 1).astype(jnp.int32)
    fg = jnp.clip(jnp.floor(q * g), 0, q - 1).astype(jnp.int32)
    fd = jnp.clip(jnp.floor(q * d / (2.0 * radius)), 0, q - 1).astype(jnp.int32)

    # per-point neighbor count → increment 100/size (pfh.cpp:208)
    cnt = jnp.maximum(jnp.sum(ok.astype(jnp.float32), axis=1), 1.0)
    inc = 100.0 / cnt  # (N,)

    rows = jnp.broadcast_to(jnp.arange(n_pts)[:, None], ok.shape)
    if combine:
        # reference order (pfh.cpp:113-120): with dist  fi[3]=α fi[0]=β fi[2]=γ fi[1]=δ
        # without dist: fi[2]=α fi[0]=β fi[1]=γ ; index = Σ fi[j]·q^j
        if use_dist:
            f0, f1, f2, f3 = fb, fd, fg, fa
            flat = f0 + q * (f1 + q * (f2 + q * f3))
        else:
            f0, f1, f2 = fb, fg, fa
            flat = f0 + q * (f1 + q * f2)
        hist = jnp.zeros((n_pts, nr_bins), jnp.float32)
        hist = hist.at[rows, flat].add(jnp.where(ok, inc[:, None], 0.0))
    else:
        hist = jnp.zeros((n_pts, nr_bins), jnp.float32)
        feats = [fa, fb, fg] + ([fd] if use_dist else [])
        for fi_idx, f in enumerate(feats):
            hist = hist.at[rows, fi_idx * q + f].add(
                jnp.where(ok, inc[:, None], 0.0)
            )
    return hist

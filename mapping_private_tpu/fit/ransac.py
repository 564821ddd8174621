"""Vmapped hypothesis RANSAC — serial SAC loops turned into one batch.

The reference runs `sample_consensus::RANSAC::computeModel()` style loops:
draw a minimal sample, fit, count inliers, repeat (fitSACPlane at
table_object_detector_passive.cpp:415, cylinder_fit_algo.cpp:45-47, the
hand-rolled loop in rotational_estimation.cpp:30-160, and the adaptive 2D
fitters in hough_segmentation/include/ransac.hpp:75-191).  Here all H
hypotheses are drawn at once, every point is scored against every
hypothesis as one (H, N) computation, and argmax picks the winner —
no data-dependent trip counts.

Scoring supports plain inlier counting ('ransac') and truncated-loss
MSAC ('msac', lower score = better converted to negated gain) — MSAC
dominates for near-tie model selection.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp


def sample_live_indices(
    key: jax.Array, mask: jax.Array, shape: Tuple[int, ...]
) -> jax.Array:
    """Draw indices uniformly from live rows (mask True), any static shape.

    Inverse-CDF over the mask: u ~ U[0, count) → searchsorted(cumsum).
    """
    cdf = jnp.cumsum(mask.astype(jnp.float32))
    total = cdf[-1]
    u = jax.random.uniform(key, shape) * total
    idx = jnp.searchsorted(cdf, u, side="right")
    return jnp.clip(idx, 0, mask.shape[0] - 1).astype(jnp.int32)


def score_hypotheses(
    dists: jax.Array,
    mask: jax.Array,
    threshold: float,
    method: str = "ransac",
) -> jax.Array:
    """(H, N) absolute distances → (H,) score (higher = better)."""
    valid = mask[None, :]
    if method == "ransac":
        inl = (dists < threshold) & valid
        return jnp.sum(inl.astype(jnp.float32), axis=1)
    elif method == "msac":
        t2 = threshold * threshold
        loss = jnp.minimum(dists * dists, t2)
        loss = jnp.where(valid, loss, 0.0)
        # negate so higher is better; add constant N*t2 to keep positive
        return jnp.sum(t2 - loss, axis=1) / t2
    raise ValueError(method)


def fit_plane_ransac(
    xyz: jax.Array,
    mask: jax.Array,
    key: jax.Array,
    num_hypotheses: int = 256,
    threshold: float = 0.02,
    axis: Optional[jax.Array] = None,
    eps_angle: Optional[float] = None,
    method: str = "msac",
    refine_iters: int = 2,
) -> Tuple[jax.Array, jax.Array]:
    """RANSAC plane fit over a masked point set.

    Args:
      xyz: (N, 3); mask: (N,) live rows.
      axis/eps_angle: optional constraint — hypothesis normal must be within
        eps_angle (radians) of ``axis`` (the reference gates table planes to
        z-parallel normals the same way, SACMODEL_NORMAL_PLANE usage).
      refine_iters: total-least-squares re-fits on the inlier set.

    Returns:
      plane: (4,) [nx, ny, nz, d] with unit normal, n·p + d = 0.
      inliers: (N,) bool.
    """
    n_pts = xyz.shape[0]
    idx = sample_live_indices(key, mask, (num_hypotheses, 3))
    p0, p1, p2 = xyz[idx[:, 0]], xyz[idx[:, 1]], xyz[idx[:, 2]]
    nrm = jnp.cross(p1 - p0, p2 - p0)
    nlen = jnp.linalg.norm(nrm, axis=-1, keepdims=True)
    degenerate = nlen[:, 0] < 1e-12
    nrm = nrm / jnp.maximum(nlen, 1e-30)
    d = -jnp.sum(nrm * p0, axis=-1)  # (H,)

    dists = jnp.abs(xyz @ nrm.T + d[None, :]).T  # (H, N)
    scores = score_hypotheses(dists, mask, threshold, method)
    scores = jnp.where(degenerate, -1.0, scores)
    if axis is not None and eps_angle is not None:
        cos_ok = jnp.abs(nrm @ axis) >= jnp.cos(eps_angle)
        scores = jnp.where(cos_ok, scores, -1.0)
    best = jnp.argmax(scores)
    plane = jnp.concatenate([nrm[best], d[best][None]])

    def refine(plane, _):
        dist = jnp.abs(xyz @ plane[:3] + plane[3])
        inl = (dist < threshold) & mask
        w = inl.astype(xyz.dtype)[:, None]
        cnt = jnp.maximum(jnp.sum(w), 3.0)
        mean = jnp.sum(xyz * w, axis=0) / cnt
        dcentered = (xyz - mean) * w
        cov = dcentered.T @ dcentered / cnt
        from mapping_private_tpu.ops.normals import smallest_eigenvector_3x3

        _, n2 = smallest_eigenvector_3x3(cov)
        # keep orientation consistent with previous estimate
        n2 = n2 * jnp.sign(jnp.dot(n2, plane[:3]) + 1e-30)
        d2 = -jnp.dot(n2, mean)
        return jnp.concatenate([n2, d2[None]]), None

    if refine_iters > 0:
        plane, _ = jax.lax.scan(refine, plane, None, length=refine_iters)
    final_dist = jnp.abs(xyz @ plane[:3] + plane[3])
    inliers = (final_dist < threshold) & mask
    return plane, inliers


def fit_line2d_ransac(
    xy: jax.Array,
    mask: jax.Array,
    key: jax.Array,
    num_hypotheses: int = 256,
    threshold: float = 0.01,
    method: str = "msac",
) -> Tuple[jax.Array, jax.Array]:
    """RANSAC 2D line (replaces hough_segmentation/include/ransac.hpp:75-104).

    Returns line (3,) [nx, ny, c] with n·p + c = 0 (unit normal), inliers.
    """
    idx = sample_live_indices(key, mask, (num_hypotheses, 2))
    p0, p1 = xy[idx[:, 0]], xy[idx[:, 1]]
    t = p1 - p0
    tlen = jnp.linalg.norm(t, axis=-1, keepdims=True)
    degenerate = tlen[:, 0] < 1e-12
    t = t / jnp.maximum(tlen, 1e-30)
    nrm = jnp.stack([-t[:, 1], t[:, 0]], axis=-1)  # (H,2)
    c = -jnp.sum(nrm * p0, axis=-1)
    dists = jnp.abs(xy @ nrm.T + c[None, :]).T
    scores = score_hypotheses(dists, mask, threshold, method)
    scores = jnp.where(degenerate, -1.0, scores)
    best = jnp.argmax(scores)
    line = jnp.concatenate([nrm[best], c[best][None]])
    inliers = (jnp.abs(xy @ line[:2] + line[2]) < threshold) & mask
    return line, inliers


def fit_circle2d_ransac(
    xy: jax.Array,
    mask: jax.Array,
    key: jax.Array,
    num_hypotheses: int = 256,
    threshold: float = 0.01,
    min_radius: float = 0.0,
    max_radius: float = jnp.inf,
    method: str = "msac",
) -> Tuple[jax.Array, jax.Array]:
    """RANSAC 2D circle from 3-point circumcircles (replaces
    hough_segmentation ransac.hpp:127-191 fitCircle).

    Returns circle (3,) [cx, cy, r], inliers.
    """
    idx = sample_live_indices(key, mask, (num_hypotheses, 3))
    a, b, c = xy[idx[:, 0]], xy[idx[:, 1]], xy[idx[:, 2]]
    # Circumcenter via perpendicular bisector solve.
    d = 2.0 * (
        a[:, 0] * (b[:, 1] - c[:, 1])
        + b[:, 0] * (c[:, 1] - a[:, 1])
        + c[:, 0] * (a[:, 1] - b[:, 1])
    )
    degenerate = jnp.abs(d) < 1e-12
    d = jnp.where(degenerate, 1.0, d)
    a2 = jnp.sum(a * a, -1)
    b2 = jnp.sum(b * b, -1)
    c2 = jnp.sum(c * c, -1)
    ux = (a2 * (b[:, 1] - c[:, 1]) + b2 * (c[:, 1] - a[:, 1]) + c2 * (a[:, 1] - b[:, 1])) / d
    uy = (a2 * (c[:, 0] - b[:, 0]) + b2 * (a[:, 0] - c[:, 0]) + c2 * (b[:, 0] - a[:, 0])) / d
    center = jnp.stack([ux, uy], -1)  # (H,2)
    radius = jnp.linalg.norm(a - center, axis=-1)  # (H,)
    dc = jnp.linalg.norm(xy[None, :, :] - center[:, None, :], axis=-1)  # (H,N)
    dists = jnp.abs(dc - radius[:, None])
    scores = score_hypotheses(dists, mask, threshold, method)
    bad = degenerate | (radius < min_radius) | (radius > max_radius)
    scores = jnp.where(bad, -1.0, scores)
    best = jnp.argmax(scores)
    circle = jnp.array([center[best, 0], center[best, 1], radius[best]])
    dist = jnp.abs(jnp.linalg.norm(xy - circle[:2], axis=-1) - circle[2])
    inliers = (dist < threshold) & mask
    return circle, inliers

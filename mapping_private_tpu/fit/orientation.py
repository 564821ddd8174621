"""Orientation RANSAC — `SACModelOrientation` JAX-native.

Replaces ias_sample_consensus/include/ias_sample_consensus/sac_model_orientation.h
(:59-213) + src/sac_model_orientation.cpp: find the dominant pair of
perpendicular directions (⊥ to a fixed axis, usually gravity z) that most
point normals align with — the Manhattan-frame estimator used for box-like
furniture.

Reference semantics kept exactly:
- a hypothesis is a single sampled normal (computeModelCoefficients :124-138);
- it is dismissed unless ⊥ axis within the threshold (selectWithinDistance
  :206-217);
- inliers are normals within Euclidean distance 2·sin(θ/2) — in unit-normal
  space — of any of {d, −d, axis×d, −axis×d} (the four radiusSearch calls
  :226-256);
- refit = average of inliers rotated into the front direction (refitModel
  :141+), re-orthogonalized against the axis.

The kd-tree in normal space becomes a dense (H, N) dot-product block — one
matmul scores every hypothesis against every normal.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from mapping_private_tpu.fit.ransac import sample_live_indices


def _four_direction_alignment(
    normals: jax.Array, dirs: jax.Array, axis: jax.Array
) -> Tuple[jax.Array, jax.Array]:
    """For each (hypothesis dir, normal): max |cosine| against the 4 cardinal
    directions and which of the 4 matched.

    normals: (N,3) unit; dirs: (H,3) unit (⊥ axis); axis: (3,) unit.
    Returns (best_cos (H,N), which (H,N) in {0:±front, 1:±left}).
    """
    left = jnp.cross(jnp.broadcast_to(axis, dirs.shape), dirs)  # (H,3)
    cf = jnp.abs(dirs @ normals.T)  # (H,N) |cos| vs ±front
    cl = jnp.abs(left @ normals.T)  # (H,N) |cos| vs ±left
    best = jnp.maximum(cf, cl)
    which = (cl > cf).astype(jnp.int32)
    return best, which


def fit_orientation_ransac(
    normals: jax.Array,
    mask: jax.Array,
    key: jax.Array,
    axis: jax.Array | None = None,
    num_hypotheses: int = 128,
    eps_angle: float = 0.1745,  # 10°
    refine_iters: int = 2,
) -> Tuple[jax.Array, jax.Array]:
    """Dominant perpendicular-direction estimation over unit normals.

    Returns:
      direction: (3,) unit vector ⊥ axis (the "front" direction).
      inliers: (N,) bool — normals aligned (±, or ±90° about axis) with it.
    """
    if axis is None:
        axis = jnp.array([0.0, 0.0, 1.0], normals.dtype)
    axis = axis / jnp.linalg.norm(axis)

    idx = sample_live_indices(key, mask, (num_hypotheses, 1))[:, 0]
    dirs = normals[idx]  # (H,3)
    # dismissal gate: |angle(dir, axis) − 90°| ≤ eps (selectWithinDistance :210)
    perp_ok = jnp.abs(dirs @ axis) <= jnp.sin(eps_angle)
    # project onto the plane ⊥ axis and renormalize (stabilizes scoring)
    dirs = dirs - (dirs @ axis)[:, None] * axis
    dlen = jnp.linalg.norm(dirs, axis=-1, keepdims=True)
    degenerate = dlen[:, 0] < 1e-6
    dirs = dirs / jnp.maximum(dlen, 1e-30)

    cos_thr = jnp.cos(eps_angle)
    best_cos, _ = _four_direction_alignment(normals, dirs, axis)
    inl = (best_cos >= cos_thr) & mask[None, :]
    scores = jnp.sum(inl.astype(jnp.float32), axis=1)
    scores = jnp.where(perp_ok & ~degenerate, scores, -1.0)
    best = jnp.argmax(scores)
    direction = dirs[best]

    def refine(d, _):
        left = jnp.cross(axis, d)
        cf = normals @ d
        cl = normals @ left
        use_left = jnp.abs(cl) > jnp.abs(cf)
        c_best = jnp.where(use_left, jnp.abs(cl), jnp.abs(cf))
        ok = (c_best >= cos_thr) & mask
        # rotate every inlier normal into the front frame:
        #   ±front → ±1·n ; ±left → rotate −90° about axis = n×axis-ish
        front_equiv = jnp.where(
            use_left[:, None],
            jnp.sign(cl)[:, None] * jnp.cross(normals, jnp.broadcast_to(axis, normals.shape)),
            jnp.sign(cf)[:, None] * normals,
        )
        w = ok.astype(normals.dtype)[:, None]
        avg = jnp.sum(front_equiv * w, axis=0)
        avg = avg - jnp.dot(avg, axis) * axis
        nlen = jnp.linalg.norm(avg)
        return jnp.where(nlen > 1e-9, avg / jnp.maximum(nlen, 1e-30), d), None

    if refine_iters > 0:
        direction, _ = jax.lax.scan(refine, direction, None, length=refine_iters)

    best_cos_f, _ = _four_direction_alignment(normals, direction[None, :], axis)
    inliers = (best_cos_f[0] >= cos_thr) & mask
    return direction, inliers

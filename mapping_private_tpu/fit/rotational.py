"""Rotational-surface RANSAC — `SACModelRotational` JAX-native.

Replaces ias_sample_consensus/src/sac_model_rotational.cpp and the
hand-rolled RANSAC loop in cloud_algos/src/rotational_estimation.cpp:30-160.

Model (mirroring PointToRotationalDistance, sac_model_rotational.cpp:73-97):
an axis line + a polynomial radius profile r(k) of the distance-to-axis as
a function of position k along the axis; the residual of a point is
|dist_to_axis − |r(k)||.

The reference estimates the axis from sample normals (EstimateAxisFromSamples
:398+), refines it with cminpack `lmdif1` Levenberg-Marquardt over squared
line-to-line distances between the axis and each point-normal line
(functionToOptimizeAxis :176-223, lmdif1 call :267), and fits the contour
polynomial by LLT least squares (EstimateContourFromSamples :357).

Array formulation: H hypotheses at once — each takes S sampled points with
normals, builds the axis from closest-approach midpoints of normal lines
(every normal of a surface of revolution intersects the axis), solves the
(order+1)² contour normal equations per hypothesis with the unrolled
Cholesky, and scores all points against all hypotheses as one (H, N) pass.
The winner is polished by a fixed-iteration damped Gauss–Newton on the
axis (replacing lmdif1) + an inlier-set contour re-fit.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

from mapping_private_tpu.core.linalg import cholesky_solve_unrolled
from mapping_private_tpu.fit.ransac import sample_live_indices, score_hypotheses
from mapping_private_tpu.fit.cylinder import _closest_point_between_lines

POLY_ORDER = 5  # the reference's polynomial_order (degree-5 contour)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class RotationalSurface:
    """point (3,) on axis, axis (3,) unit, coeffs (POLY_ORDER+1,) radius
    polynomial in the scaled coordinate k/k_scale, k_scale scalar."""

    point: jax.Array
    axis: jax.Array
    coeffs: jax.Array
    k_scale: jax.Array


def _axis_coords(
    xyz: jax.Array, point: jax.Array, axis: jax.Array
) -> Tuple[jax.Array, jax.Array]:
    """k (position along axis) and y (distance to axis) per point."""
    rel = xyz - point
    k = rel @ axis
    perp = rel - k[..., None] * axis
    y = jnp.linalg.norm(perp, axis=-1)
    return k, y


def _poly_eval(coeffs: jax.Array, t: jax.Array) -> jax.Array:
    """coeffs (D+1,), t (...) → sum coeffs[w] t^w (Horner)."""
    r = jnp.zeros_like(t)
    for c in coeffs[::-1]:
        r = r * t + c
    return r


def _fit_contour(
    k: jax.Array, y: jax.Array, w: jax.Array, k_scale: jax.Array
) -> jax.Array:
    """Weighted LS radius polynomial (order POLY_ORDER) of y against
    t = k/k_scale (the reference's EstimateContourFromSamples LLT solve)."""
    t = k / k_scale
    powers = jnp.stack([t**i for i in range(POLY_ORDER + 1)], axis=-1)  # (N,D+1)
    bw = powers * w[..., None]
    H = bw.T @ powers
    g = bw.T @ (y * w)
    return cholesky_solve_unrolled(H, g, jitter=1e-6)


def rotational_distance(
    surf: RotationalSurface, xyz: jax.Array
) -> jax.Array:
    """|y − |r(k)|| per point (PointToRotationalDistance :73-97)."""
    k, y = _axis_coords(xyz, surf.point, surf.axis)
    r = _poly_eval(surf.coeffs, k / surf.k_scale)
    return jnp.abs(y - jnp.abs(r))


def _line_line_distance(
    a_pt: jax.Array, a_dir: jax.Array, p: jax.Array, n: jax.Array
) -> jax.Array:
    """Distance between the axis line and each point-normal line (batched
    over p/n) — the residual lmdif1 minimized (functionToOptimizeAxis)."""
    cross = jnp.cross(
        jnp.broadcast_to(a_dir, n.shape), n
    )  # (N,3)
    cl = jnp.linalg.norm(cross, axis=-1)
    w = p - a_pt
    num = jnp.abs(jnp.sum(w * cross, axis=-1))
    # parallel lines: distance of p to the axis line
    perp = w - (w @ a_dir)[..., None] * a_dir
    par_d = jnp.linalg.norm(perp, axis=-1)
    return jnp.where(cl > 1e-9, num / jnp.maximum(cl, 1e-12), par_d)


def fit_rotational_ransac(
    xyz: jax.Array,
    normals: jax.Array,
    mask: jax.Array,
    key: jax.Array,
    num_hypotheses: int = 256,
    samples_per_hyp: int = 8,
    threshold: float = 0.01,
    gn_iters: int = 6,
    method: str = "msac",
) -> Tuple[RotationalSurface, jax.Array]:
    """Vmapped rotational-surface RANSAC.

    Returns (RotationalSurface, inliers (N,) bool).
    """
    n_pts = xyz.shape[0]
    S = samples_per_hyp
    idx = sample_live_indices(key, mask, (num_hypotheses, S))
    sp = xyz[idx]  # (H,S,3)
    sn = normals[idx]

    # axis from closest-approach midpoints of normal-line pairs (0,1) & (0,2):
    # both midpoints lie on the axis for exact surfaces of revolution.
    m01 = _closest_point_between_lines(sp[:, 0], sn[:, 0], sp[:, 1], sn[:, 1])
    m02 = _closest_point_between_lines(sp[:, 0], sn[:, 0], sp[:, 2], sn[:, 2])
    ax = m02 - m01
    axlen = jnp.linalg.norm(ax, axis=-1, keepdims=True)
    # fallback for coincident midpoints: cross of the two normals
    alt = jnp.cross(sn[:, 0], sn[:, 1])
    altlen = jnp.linalg.norm(alt, axis=-1, keepdims=True)
    use_alt = axlen[:, 0] < 1e-6
    ax = jnp.where(use_alt[:, None], alt / jnp.maximum(altlen, 1e-30),
                   ax / jnp.maximum(axlen, 1e-30))
    degenerate = use_alt & (altlen[:, 0] < 1e-9)
    apt = m01  # (H,3)

    # per-hypothesis contour through the S samples
    def contour_of(apt_h, ax_h, sp_h):
        rel = sp_h - apt_h
        k = rel @ ax_h
        y = jnp.linalg.norm(rel - k[:, None] * ax_h, axis=-1)
        ks = jnp.maximum(jnp.max(jnp.abs(k)), 1e-3)
        c = _fit_contour(k, y, jnp.ones_like(k), ks)
        return c, ks

    coeffs, kscale = jax.vmap(contour_of)(apt, ax, sp)  # (H,D+1), (H,)

    # score all points against all hypotheses
    rel = xyz[None, :, :] - apt[:, None, :]  # (H,N,3)
    k = jnp.sum(rel * ax[:, None, :], axis=-1)  # (H,N)
    y = jnp.linalg.norm(rel - k[..., None] * ax[:, None, :], axis=-1)
    t = k / kscale[:, None]
    r = jax.vmap(_poly_eval)(coeffs, t)  # (H,N)
    dists = jnp.abs(y - jnp.abs(r))
    scores = score_hypotheses(dists, mask, threshold, method)
    scores = jnp.where(degenerate, -1.0, scores)
    best = jnp.argmax(scores)
    apt_b, ax_b = apt[best], ax[best]
    coeffs_b, ks_b = coeffs[best], kscale[best]

    # ---- polish: damped GN on the axis over current inliers ---------------
    def axis_residuals(params, w):
        a_pt, a_raw = params[:3], params[3:]
        a_dir = a_raw / jnp.maximum(jnp.linalg.norm(a_raw), 1e-12)
        return _line_line_distance(a_pt, a_dir, xyz, normals) * w

    def gn_body(carry, _):
        a_pt, a_dir, c_cur, ks_cur = carry
        surf = RotationalSurface(point=a_pt, axis=a_dir, coeffs=c_cur, k_scale=ks_cur)
        inl = (rotational_distance(surf, xyz) < threshold) & mask
        w = inl.astype(xyz.dtype)
        params = jnp.concatenate([a_pt, a_dir])
        res = axis_residuals(params, w)
        J = jax.jacfwd(axis_residuals)(params, w)  # (N,6)
        H = J.T @ J
        g = J.T @ res
        step = cholesky_solve_unrolled(H, g, jitter=1e-6)
        params = params - step
        a_pt_n = params[:3]
        a_dir_n = params[3:] / jnp.maximum(jnp.linalg.norm(params[3:]), 1e-12)
        # contour re-fit on the inliers with the new axis
        k_n, y_n = _axis_coords(xyz, a_pt_n, a_dir_n)
        ks_n = jnp.maximum(jnp.max(jnp.abs(k_n) * w), 1e-3)
        c_n = _fit_contour(k_n, y_n, w, ks_n)
        return (a_pt_n, a_dir_n, c_n, ks_n), None

    (apt_b, ax_b, coeffs_b, ks_b), _ = jax.lax.scan(
        gn_body, (apt_b, ax_b, coeffs_b, ks_b), None, length=gn_iters
    )

    surf = RotationalSurface(point=apt_b, axis=ax_b, coeffs=coeffs_b, k_scale=ks_b)
    inliers = (rotational_distance(surf, xyz) < threshold) & mask
    return surf, inliers

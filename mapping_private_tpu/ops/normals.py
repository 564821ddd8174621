"""Normal & curvature estimation — batched closed-form 3×3 eigenanalysis.

Replaces the reference's per-point kd-tree loop
(`cloud_geometry::nearest::computePointNormal`, called from
table_object_detector_passive.cpp:392 and cylinder_fit_algo.cpp:138-204)
with one fused pass: kNN gather → masked covariance → analytic smallest
eigenvector (Eberly's trigonometric method — pure elementwise arithmetic, no
LAPACK-style iteration), then viewpoint-consistent sign flip.

Curvature follows the reference's convention: λ₀ / (λ₀+λ₁+λ₂)
(cf. the column legend in cloud_algos/data/cylinder_small.pcd header).
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from mapping_private_tpu.core.cloud import PointCloud
from mapping_private_tpu.ops.neighbors import knn_bruteforce, knn_grid, build_grid_hash


def eigvals_sym3x3(A: jax.Array) -> jax.Array:
    """Analytic eigenvalues of symmetric (..., 3, 3), ascending order."""
    q = jnp.trace(A, axis1=-2, axis2=-1) / 3.0
    B = A - q[..., None, None] * jnp.eye(3, dtype=A.dtype)
    p2 = jnp.sum(B * B, axis=(-2, -1)) / 6.0
    p = jnp.sqrt(jnp.maximum(p2, 1e-30))
    detB = jnp.linalg.det(B)
    r = jnp.clip(detB / (2.0 * p**3), -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    e1 = q + 2.0 * p * jnp.cos(phi)
    e3 = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)
    e2 = 3.0 * q - e1 - e3
    return jnp.stack([e3, e2, e1], axis=-1)  # ascending


def smallest_eigenvector_3x3(A: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Smallest eigenpair of symmetric (..., 3, 3).

    Returns (eigvals ascending (...,3), eigvec (...,3) unit-norm).
    The eigenvector for λ_min is extracted from the column space of
    (A−λ₁I)(A−λ₂I): its columns are parallel to the λ₀-eigenvector
    (Cayley–Hamilton).  Degenerate (isotropic) neighborhoods fall back to
    a fixed axis — their curvature flags them as unreliable anyway.
    """
    ev = eigvals_sym3x3(A)
    l0, l1, l2 = ev[..., 0], ev[..., 1], ev[..., 2]
    I = jnp.eye(3, dtype=A.dtype)
    M = (A - l1[..., None, None] * I) @ (A - l2[..., None, None] * I)
    # Pick the largest-norm column for stability.
    norms = jnp.sum(M * M, axis=-2)  # (..., 3) column squared norms
    col = jnp.argmax(norms, axis=-1)
    vec = jnp.take_along_axis(M, col[..., None, None], axis=-1)[..., 0]
    n = jnp.linalg.norm(vec, axis=-1, keepdims=True)
    fallback = jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0], A.dtype), vec.shape)
    vec = jnp.where(n > 1e-12, vec / jnp.maximum(n, 1e-30), fallback)
    return ev, vec


def normals_from_neighbors(
    xyz: jax.Array,
    nbr_idx: jax.Array,
    nbr_valid: jax.Array,
    viewpoint: Optional[jax.Array] = None,
) -> Tuple[jax.Array, jax.Array]:
    """Covariance normals from precomputed neighbor lists.

    Args:
      xyz: (N, 3) positions.
      nbr_idx: (N, k) int32 neighbor rows (−1 invalid).
      nbr_valid: (N, k) bool.
      viewpoint: (3,) sensor origin for sign disambiguation (default 0).

    Returns (normals (N,3), curvature (N,)).
    """
    idx = jnp.maximum(nbr_idx, 0)
    pts = xyz[idx]  # (N,k,3)
    w = nbr_valid.astype(xyz.dtype)[..., None]
    cnt = jnp.maximum(jnp.sum(w, axis=1), 1.0)  # (N,1)
    mean = jnp.sum(pts * w, axis=1) / cnt
    d = (pts - mean[:, None, :]) * w
    cov = jnp.einsum("nki,nkj->nij", d, d) / cnt[..., None]
    ev, nrm = smallest_eigenvector_3x3(cov)
    lam_sum = jnp.maximum(jnp.sum(ev, axis=-1), 1e-30)
    curvature = jnp.maximum(ev[..., 0], 0.0) / lam_sum
    vp = jnp.zeros((3,), xyz.dtype) if viewpoint is None else viewpoint
    to_vp = vp[None, :] - xyz
    flip = jnp.sign(jnp.sum(nrm * to_vp, axis=-1, keepdims=True))
    flip = jnp.where(flip == 0, 1.0, flip)
    return nrm * flip, curvature


def estimate_normals_radius(
    cloud: PointCloud,
    radius: float,
    k_cap: int = 64,
    viewpoint: Optional[jax.Array] = None,
) -> PointCloud:
    """Radius-search normal estimation — PCL `NormalEstimation`
    parity path (the reference's `computeNormal`,
    color_chlac/include/color_chlac/grsd_colorCHLAC_tools.hpp:157-186,
    radius = normals_radius_search = 0.02).

    The covariance runs over ALL neighbors within ``radius`` *including
    the query point itself* (PCL's radius search returns it at distance
    0).  ``k_cap`` must exceed the densest neighborhood for exactness.
    """
    xyz = cloud.padded_xyz()
    idx, sq = knn_bruteforce(xyz, xyz, cloud.mask, k=k_cap)
    valid = (idx >= 0) & (sq <= radius * radius) & cloud.mask[:, None]
    nrm, curv = normals_from_neighbors(xyz, idx, valid, viewpoint)
    return cloud.with_channel("normal", nrm).with_channel("curvature", curv)


def estimate_normals(
    cloud: PointCloud,
    k: int = 20,
    viewpoint: Optional[jax.Array] = None,
    use_grid: bool = False,
    cell_size: float = 0.05,
) -> PointCloud:
    """Attach 'normal' (N,3) and 'curvature' (N,) channels.

    k matches the reference default (cylinder_fit_algo.cpp k=20 normal
    estimation).  ``use_grid`` switches to the grid-hash path for large
    clouds.
    """
    xyz = cloud.padded_xyz()
    if use_grid:
        grid = build_grid_hash(xyz, cloud.mask, cell_size)
        idx, sq = knn_grid(
            grid, xyz, k=k, self_idx=jnp.arange(xyz.shape[0], dtype=jnp.int32)
        )
    else:
        idx, sq = knn_bruteforce(xyz, xyz, cloud.mask, k=k, exclude_self=True)
    valid = (idx >= 0) & cloud.mask[:, None]
    nrm, curv = normals_from_neighbors(xyz, idx, valid, viewpoint)
    return cloud.with_channel("normal", nrm).with_channel("curvature", curv)

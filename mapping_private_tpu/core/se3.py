"""SE(3) rigid transforms as 4x4 matrices + tangent-space maps.

The reference composes Euler-angle rotations inside its ICP solve
(cloud_algos/src/registration.cpp:80-102); here poses live on the SE(3)
manifold with exp/log maps so Gauss-Newton updates are chart-free and
batched cleanly under vmap (used by ICP, pose-graph BA, and RANSAC
refinement).  All functions are jit/vmap-safe with static shapes.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-9


def se3_identity(dtype=jnp.float32) -> jax.Array:
    return jnp.eye(4, dtype=dtype)


def skew(w: jax.Array) -> jax.Array:
    """(3,) -> (3,3) cross-product matrix."""
    wx, wy, wz = w[0], w[1], w[2]
    z = jnp.zeros_like(wx)
    return jnp.array([[z, -wz, wy], [wz, z, -wx], [-wy, wx, z]])


def so3_exp(w: jax.Array) -> jax.Array:
    """Rodrigues: (3,) axis-angle -> (3,3) rotation. Taylor-safe at 0."""
    theta2 = jnp.dot(w, w)
    theta = jnp.sqrt(theta2 + _EPS)
    W = skew(w)
    # sin(t)/t and (1-cos t)/t^2 with small-angle series fallback
    a = jnp.where(theta2 > 1e-8, jnp.sin(theta) / theta, 1.0 - theta2 / 6.0)
    b = jnp.where(theta2 > 1e-8, (1.0 - jnp.cos(theta)) / theta2, 0.5 - theta2 / 24.0)
    return jnp.eye(3) + a * W + b * (W @ W)


def so3_log(R: jax.Array) -> jax.Array:
    """(3,3) rotation -> (3,) axis-angle.

    Differentiation-safe at the identity: `arccos` has an unbounded
    derivative at cos θ = 1 and `jnp.where` does not stop gradients from
    the untaken branch, so the small-angle series is written in cos θ and
    arccos is only ever *evaluated* (and differentiated) at a clamped-away
    argument (the standard safe-where pattern; needed by the pose-graph
    Jacobians, which differentiate through log at convergence)."""
    cos_t = jnp.clip((jnp.trace(R) - 1.0) * 0.5, -1.0, 1.0)
    small = cos_t > 1.0 - 1e-6
    cos_safe = jnp.where(small, 0.0, cos_t)  # derivative-finite arccos input
    theta = jnp.arccos(cos_safe)
    w_hat = jnp.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    s_large = theta / (2.0 * jnp.sin(theta) + _EPS)
    # θ² ≈ 2(1−cos θ):  θ/(2 sin θ) ≈ 1/2 + θ²/12 = 1/2 + (1−cos θ)/6
    s_small = 0.5 + (1.0 - cos_t) / 6.0
    s = jnp.where(small, s_small, s_large)
    return s * w_hat


def se3_exp(xi: jax.Array) -> jax.Array:
    """(6,) twist [v, w] -> (4,4) transform (translation first, rotation last
    three — the ICP/GN convention used throughout this package)."""
    v, w = xi[:3], xi[3:]
    theta2 = jnp.dot(w, w)
    theta = jnp.sqrt(theta2 + _EPS)
    W = skew(w)
    R = so3_exp(w)
    b = jnp.where(theta2 > 1e-8, (1.0 - jnp.cos(theta)) / theta2, 0.5 - theta2 / 24.0)
    c = jnp.where(theta2 > 1e-8, (theta - jnp.sin(theta)) / (theta2 * theta), 1.0 / 6.0 - theta2 / 120.0)
    V = jnp.eye(3) + b * W + c * (W @ W)
    T = jnp.eye(4, dtype=xi.dtype)
    T = T.at[:3, :3].set(R)
    T = T.at[:3, 3].set(V @ v)
    return T


def se3_log(T: jax.Array) -> jax.Array:
    """(4,4) -> (6,) twist [v, w]."""
    R = T[:3, :3]
    t = T[:3, 3]
    w = so3_log(R)
    theta2 = jnp.dot(w, w)
    theta = jnp.sqrt(theta2 + _EPS)
    W = skew(w)
    b = jnp.where(theta2 > 1e-8, (1.0 - jnp.cos(theta)) / theta2, 0.5 - theta2 / 24.0)
    c = jnp.where(theta2 > 1e-8, (theta - jnp.sin(theta)) / (theta2 * theta), 1.0 / 6.0 - theta2 / 120.0)
    V = jnp.eye(3) + b * W + c * (W @ W)
    v = jnp.linalg.solve(V, t)
    return jnp.concatenate([v, w])


def se3_compose(a: jax.Array, b: jax.Array) -> jax.Array:
    return a @ b


def se3_inverse(T: jax.Array) -> jax.Array:
    R = T[:3, :3]
    t = T[:3, 3]
    Ti = jnp.eye(4, dtype=T.dtype)
    Ti = Ti.at[:3, :3].set(R.T)
    Ti = Ti.at[:3, 3].set(-R.T @ t)
    return Ti


def se3_apply(T: jax.Array, pts: jax.Array) -> jax.Array:
    """Apply (4,4) transform to (..., 3) points.

    Written as broadcast arithmetic, NOT a matmul: a (N,3)@(3,3) product
    may run at reduced precision (bf16 or TF32 passes), whose ~1e-3
    absolute coordinate error puts a millimetre floor under ICP
    convergence; exact f32 elementwise math keeps the ~1e-7 fixed point."""
    R = T[:3, :3]
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    out = jnp.stack(
        [
            R[0, 0] * x + R[0, 1] * y + R[0, 2] * z + T[0, 3],
            R[1, 0] * x + R[1, 1] * y + R[1, 2] * z + T[1, 3],
            R[2, 0] * x + R[2, 1] * y + R[2, 2] * z + T[2, 3],
        ],
        axis=-1,
    )
    return out

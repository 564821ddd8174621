"""Linear SVM training in JAX — the `liblinear_asako` capability.

The reference vendors a liblinear fork with a TRON (trust-region Newton)
solver (color_feature_classification/src/libsvm_and_linear/liblinear_asako/
libLINEAR.cpp + libLINEAR_tron.cpp) used for L2-regularized L2-loss SVC.

Array formulation: the same objective —

    min_w  ½‖w‖² + C Σ_i max(0, 1 − y_i wᵀx_i)²

— optimized by full-batch Newton-ish gradient descent with a fixed
iteration count inside `lax.scan` (the squared hinge is differentiable,
the Hessian-free fixed step with line-search-free Barzilai–Borwein
scaling converges fast on these small dense problems).  One-vs-rest over
classes is a single vmapped solve.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def _solve_binary(
    X: jax.Array, y: jax.Array, C: float, iters: int
) -> jax.Array:
    """y ∈ {−1, +1}; returns (D+1,) weights with bias last."""
    n, d = X.shape
    Xb = jnp.concatenate([X, jnp.ones((n, 1), X.dtype)], axis=1)

    def obj_grad(w):
        m = 1.0 - y * (Xb @ w)
        active = m > 0
        loss_g = -2.0 * C * Xb.T @ (y * jnp.where(active, m, 0.0))
        reg = w.at[-1].set(0.0)  # bias unregularized
        return reg + loss_g

    def body(carry, _):
        w, w_prev, g_prev = carry
        g = obj_grad(w)
        # Barzilai–Borwein step size (safeguarded)
        sdiff = w - w_prev
        gdiff = g - g_prev
        num = jnp.sum(sdiff * sdiff)
        den = jnp.sum(sdiff * gdiff)
        step = jnp.where(den > 1e-12, num / jnp.maximum(den, 1e-12), 1e-3)
        step = jnp.clip(step, 1e-6, 10.0)
        return (w - step * g, w, g), None

    w0 = jnp.zeros((d + 1,), X.dtype)
    g0 = obj_grad(w0)
    w1 = w0 - 1e-4 * g0
    (w, _, _), _ = jax.lax.scan(body, (w1, w0, g0), None, length=iters)
    return w


def train_linear_svm(
    X: jax.Array, labels: jax.Array, num_classes: int, C: float = 1.0,
    iters: int = 200,
) -> jax.Array:
    """One-vs-rest L2-loss linear SVC.  Returns (num_classes, D+1)."""
    X = jnp.asarray(X, jnp.float32)

    def one_class(c):
        y = jnp.where(labels == c, 1.0, -1.0).astype(jnp.float32)
        return _solve_binary(X, y, C, iters)

    return jax.vmap(one_class)(jnp.arange(num_classes))


def predict_linear(W: jax.Array, X: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Returns (labels (N,), decision values (N, C))."""
    X = jnp.asarray(X, jnp.float32)
    Xb = jnp.concatenate([X, jnp.ones((X.shape[0], 1), X.dtype)], axis=1)
    dec = Xb @ W.T
    return jnp.argmax(dec, axis=-1), dec

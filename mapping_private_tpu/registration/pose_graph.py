"""Pose-graph optimization — the new global-consistency layer.

The reference has NO pose-graph/BA machinery: its ICP chains scan-to-scan
(registration.cpp:167 slides the target) and drift is unbounded; its world
model stores per-table instances with no global relaxation.  This module
adds the capability the BASELINE north star asks for: keyframe poses tied
by relative SE(3) measurements (ICP results, odometry, loop closures),
relaxed by damped Gauss-Newton.

Array formulation: all E edge residuals r_e = log(Z_e⁻¹ T_i⁻¹ T_j) and
their Jacobians (forward-mode, batched via vmap — replacing the
cminpack/Eigen sparse solvers a CPU stack would use) are computed at
once; the 6K×6K normal equations assemble by scatter-adding 6×6 blocks
(K = keyframes, small; the dense solve is one LAPACK/XLA call).  Gauge
freedom is fixed by a strong prior on node 0.

The sharded variant splits EDGES over the device mesh: each device builds
partial (H, g) from its edge shard; one psum over the mesh assembles the
full system; the solve is replicated.  This is the Schur-style
reduce-then-solve pattern of distributed GN.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from mapping_private_tpu.core.se3 import (
    se3_exp,
    se3_log,
    se3_inverse,
)


def edge_residual(
    Ti: jax.Array, Tj: jax.Array, Zij: jax.Array
) -> jax.Array:
    """r = log(Z⁻¹ · Ti⁻¹ · Tj) ∈ R⁶ (zero when Tj = Ti·Z)."""
    return se3_log(se3_inverse(Zij) @ se3_inverse(Ti) @ Tj)


def _edge_system(Ti, Tj, Zij, weight):
    """Residual + Jacobians wrt right-perturbations of (Ti, Tj)."""

    def r_of(xi_i, xi_j):
        return edge_residual(Ti @ se3_exp(xi_i), Tj @ se3_exp(xi_j), Zij)

    z6 = jnp.zeros((6,))
    r = r_of(z6, z6)
    Ji = jax.jacfwd(r_of, argnums=0)(z6, z6)  # (6,6)
    Jj = jax.jacfwd(r_of, argnums=1)(z6, z6)
    w = weight
    return r * w, Ji * w, Jj * w


def build_normal_equations(
    poses: jax.Array,  # (K, 4, 4)
    edges: jax.Array,  # (E, 2) int32
    measurements: jax.Array,  # (E, 4, 4)
    weights: Optional[jax.Array] = None,  # (E,)
    edge_mask: Optional[jax.Array] = None,  # (E,) bool
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """(H (K,K,6,6) block matrix, g (K,6), total squared error)."""
    E = edges.shape[0]
    K = poses.shape[0]
    w = jnp.ones((E,)) if weights is None else weights
    if edge_mask is not None:
        w = w * edge_mask.astype(w.dtype)
    Ti = poses[edges[:, 0]]
    Tj = poses[edges[:, 1]]
    r, Ji, Jj = jax.vmap(_edge_system)(Ti, Tj, measurements, w)  # (E,6),(E,6,6)²

    H = jnp.zeros((K, K, 6, 6))
    g = jnp.zeros((K, 6))
    i, j = edges[:, 0], edges[:, 1]
    H = H.at[i, i].add(jnp.einsum("eab,eac->ebc", Ji, Ji))
    H = H.at[j, j].add(jnp.einsum("eab,eac->ebc", Jj, Jj))
    H = H.at[i, j].add(jnp.einsum("eab,eac->ebc", Ji, Jj))
    H = H.at[j, i].add(jnp.einsum("eab,eac->ebc", Jj, Ji))
    g = g.at[i].add(jnp.einsum("eab,ea->eb", Ji, r))
    g = g.at[j].add(jnp.einsum("eab,ea->eb", Jj, r))
    err = jnp.sum(r * r)
    return H, g, err


def _solve_and_update(poses, H, g, damping, anchor_weight):
    K = poses.shape[0]
    # gauge fix: strong prior on node 0
    H = H.at[0, 0].add(anchor_weight * jnp.eye(6))
    Hd = H.transpose(0, 2, 1, 3).reshape(6 * K, 6 * K)
    Hd = Hd + damping * jnp.eye(6 * K)
    dx = -jnp.linalg.solve(Hd, g.reshape(-1)).reshape(K, 6)
    return jax.vmap(lambda T, xi: T @ se3_exp(xi))(poses, dx)


@functools.partial(jax.jit, static_argnames=("iters",))
def optimize_pose_graph(
    poses: jax.Array,
    edges: jax.Array,
    measurements: jax.Array,
    weights: Optional[jax.Array] = None,
    iters: int = 10,
    damping: float = 1e-6,
    anchor_weight: float = 1e6,
) -> Tuple[jax.Array, jax.Array]:
    """Damped GN relaxation.  Returns (poses (K,4,4), per-iter error (iters,))."""

    def body(p, _):
        H, g, err = build_normal_equations(p, edges, measurements, weights)
        p2 = _solve_and_update(p, H, g, damping, anchor_weight)
        return p2, err

    poses, errs = jax.lax.scan(body, poses, None, length=iters)
    return poses, errs


def make_sharded_pose_graph_step(
    mesh: Mesh,
    damping: float = 1e-6,
    anchor_weight: float = 1e6,
):
    """One GN iteration with EDGES sharded over every mesh axis.

    Returns (step_fn, edge_sharding).  step_fn(poses, edges, measurements,
    weights) → (poses, error); poses replicated, edges/measurements/weights
    sharded along their leading axis.  Pad the edge list to a multiple of
    the mesh size with weight-0 self-edges (0, 0, identity).
    """
    axes = tuple(mesh.axis_names)

    def local_step(poses, edges, measurements, weights):
        # per-device edge shard → partial normal equations
        H, g, err = build_normal_equations(poses, edges, measurements, weights)
        H = jax.lax.psum(H, axes)
        g = jax.lax.psum(g, axes)
        err = jax.lax.psum(err, axes)
        new_poses = _solve_and_update(poses, H, g, damping, anchor_weight)
        return new_poses, err

    specs_in = (
        P(),  # poses replicated
        P(axes),  # edges sharded
        P(axes),  # measurements sharded
        P(axes),  # weights sharded
    )
    specs_out = (P(), P())
    step = jax.jit(
        shard_map(local_step, mesh=mesh, in_specs=specs_in, out_specs=specs_out)
    )
    shardings = tuple(NamedSharding(mesh, s) for s in specs_in)
    return step, shardings

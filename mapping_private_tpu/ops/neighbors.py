"""Neighbor search kernels — the array replacement for `cloud_kdtree::KdTreeANN`.

The reference pointer-chases an ANN kd-tree for every normal estimate,
noise filter, region grow, and ICP correspondence (registration.cpp:174,
noise_removal.cpp:73, region_growing.cpp:109, cylinder_fit_algo.cpp:146).
Here we use two dense formulations instead:

1. ``knn_bruteforce`` — full (Q, N) squared-distance matrix via one
   matmul (‖a‖² + ‖b‖² − 2a·bᵀ) followed by ``lax.top_k``.  Exact up to
   f32 rounding, for the reference's cloud sizes (≤ ~50k points).

2. ``build_grid_hash`` / ``knn_grid`` — grid-hash bucket gather for large
   clouds: points are sorted by a 30-bit packed cell key (10 bits per
   axis, wrap-around mod 1024; aliasing only ever *adds* candidates —
   the exact distance check filters them, so results stay exact as long
   as the true k-th neighbor lies within the 27-cell stencil, i.e.
   cell_size ≥ search radius).  Per query: 27 binary searches into the
   sorted key array + a fixed-fanout gather + top_k.  All shapes static.

Both return (indices, squared distances) with invalid slots marked by
index −1 and distance +inf.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

from mapping_private_tpu.core.cloud import PAD_COORD

_INF = jnp.inf
_KEY_SENTINEL = jnp.int32(1 << 30)
_BITS = 10
_MASKB = (1 << _BITS) - 1


def pairwise_sq_dists(a: jax.Array, b: jax.Array) -> jax.Array:
    """(Q,3),(N,3) -> (Q,N) squared Euclidean distances via one matmul.

    HIGHEST precision is load-bearing: a reduced-precision product (bf16
    or TF32 passes) carries ~1e-2 absolute error, which mis-ranks near-tie
    neighbors — top_k/argmin over these distances must see exact f32.
    Even at f32 the ‖a‖² + ‖b‖² − 2a·b form cancels at large coordinates;
    the GPU kernel of ops.pallas_nn uses broadcast differences instead."""
    a2 = jnp.sum(a * a, axis=-1, keepdims=True)
    b2 = jnp.sum(b * b, axis=-1, keepdims=True).T
    cross = jax.lax.dot_general(
        a, b, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    return jnp.maximum(a2 + b2 - 2.0 * cross, 0.0)


def knn_bruteforce(
    query_xyz: jax.Array,
    ref_xyz: jax.Array,
    ref_mask: jax.Array,
    k: int,
    exclude_self: bool = False,
) -> Tuple[jax.Array, jax.Array]:
    """Exact kNN over a dense distance matrix.

    Args:
      query_xyz: (Q, 3).
      ref_xyz: (N, 3).
      ref_mask: (N,) bool; dead refs never returned.
      k: static neighbor count.
      exclude_self: if True, assumes query i == ref i and masks the diagonal.

    Returns:
      idx: (Q, k) int32, −1 where fewer than k live refs exist.
      sq_dists: (Q, k) float32, +inf in the same slots.
    """
    d2 = pairwise_sq_dists(query_xyz, ref_xyz)
    d2 = jnp.where(ref_mask[None, :], d2, _INF)
    if exclude_self:
        q = query_xyz.shape[0]
        d2 = d2.at[jnp.arange(q), jnp.arange(q)].set(_INF)
    if k == 1:
        # a plain argmin for the NN case instead of top_k
        idx = jnp.argmin(d2, axis=1)[:, None].astype(jnp.int32)
        neg = -jnp.take_along_axis(d2, idx, axis=1)
    else:
        neg, idx = jax.lax.top_k(-d2, k)
    sq = -neg
    valid = jnp.isfinite(sq)
    return jnp.where(valid, idx, -1).astype(jnp.int32), jnp.where(valid, sq, _INF)


def _cell_key(cell: jax.Array) -> jax.Array:
    """(N,3) int32 cell coords -> packed 30-bit key (wrap mod 1024/axis)."""
    cx = cell[..., 0] & _MASKB
    cy = cell[..., 1] & _MASKB
    cz = cell[..., 2] & _MASKB
    return (cx << (2 * _BITS)) | (cy << _BITS) | cz


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class GridHash:
    """Sorted grid-hash index over a fixed-capacity point set."""

    sorted_keys: jax.Array  # (N,) int32, ascending; dead points at sentinel
    sorted_idx: jax.Array  # (N,) int32 original row ids
    sorted_xyz: jax.Array  # (N, 3) gathered positions (dead → PAD_COORD)
    cell_size: jax.Array  # scalar


def build_grid_hash(xyz: jax.Array, mask: jax.Array, cell_size: float) -> GridHash:
    cs = jnp.asarray(cell_size, jnp.float32)
    cell = jnp.floor(xyz / cs).astype(jnp.int32)
    keys = jnp.where(mask, _cell_key(cell), _KEY_SENTINEL)
    order = jnp.argsort(keys)
    sorted_keys = keys[order]
    sorted_xyz = jnp.where(
        (sorted_keys != _KEY_SENTINEL)[:, None], xyz[order], PAD_COORD
    )
    return GridHash(
        sorted_keys=sorted_keys,
        sorted_idx=order.astype(jnp.int32),
        sorted_xyz=sorted_xyz,
        cell_size=cs,
    )


_OFFSETS = jnp.array(
    [[dx, dy, dz] for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)],
    dtype=jnp.int32,
)  # (27, 3)


def _candidate_gather(
    grid: GridHash, query_xyz: jax.Array, cap_per_cell: int
) -> Tuple[jax.Array, jax.Array]:
    """For each query, gather up to 27*cap candidate slots from the stencil.

    Returns (cand_slot (Q, 27*cap) int32 positions into the sorted arrays,
    cand_valid (Q, 27*cap) bool)."""
    qcell = jnp.floor(query_xyz / grid.cell_size).astype(jnp.int32)  # (Q,3)
    cells = qcell[:, None, :] + _OFFSETS[None, :, :]  # (Q,27,3)
    keys = _cell_key(cells)  # (Q,27)
    start = jnp.searchsorted(grid.sorted_keys, keys, side="left")  # (Q,27)
    end = jnp.searchsorted(grid.sorted_keys, keys, side="right")
    lane = jnp.arange(cap_per_cell, dtype=jnp.int32)  # (cap,)
    slots = start[..., None] + lane[None, None, :]  # (Q,27,cap)
    valid = slots < end[..., None]
    n = grid.sorted_keys.shape[0]
    slots = jnp.clip(slots, 0, n - 1)
    q = query_xyz.shape[0]
    return slots.reshape(q, -1), valid.reshape(q, -1)


def nn_grid_1nn(
    grid: GridHash,
    query_xyz: jax.Array,
    cap_per_cell: int = 16,
) -> Tuple[jax.Array, jax.Array]:
    """Scalable exact-within-stencil 1-NN: O(Q·cap) memory.

    The big-cloud replacement for the reference's per-query kd-tree
    (cloud_algos/src/registration.cpp:128): exact whenever the true NN
    lies within cell_size of the query and no stencil cell overflows
    cap_per_cell.  Unrolls the 27 stencil cells as a host loop of
    (Q, cap) chunks with PER-COORDINATE gathers — a single (Q, 27·cap, 3)
    gather with a size-3 minor axis can be padded by the compiler to a
    full vector width and multiply memory traffic.

    Returns (idx (Q,) int32 original row ids or −1, sq_dists (Q,)).
    """
    q = query_xyz.shape[0]
    n = grid.sorted_keys.shape[0]
    qcell = jnp.floor(query_xyz / grid.cell_size).astype(jnp.int32)
    qx, qy, qz = query_xyz[:, 0], query_xyz[:, 1], query_xyz[:, 2]
    sx = grid.sorted_xyz[:, 0]
    sy = grid.sorted_xyz[:, 1]
    sz = grid.sorted_xyz[:, 2]
    lane = jnp.arange(cap_per_cell, dtype=jnp.int32)
    best_d2 = jnp.full((q,), _INF)
    best_slot = jnp.zeros((q,), jnp.int32)
    for off in [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                for dz in (-1, 0, 1)]:
        keys = _cell_key(qcell + jnp.asarray(off, jnp.int32)[None, :])
        start = jnp.searchsorted(grid.sorted_keys, keys, side="left")
        end = jnp.searchsorted(grid.sorted_keys, keys, side="right")
        slots = jnp.clip(start[:, None] + lane[None, :], 0, n - 1)  # (Q,cap)
        valid = start[:, None] + lane[None, :] < end[:, None]
        dx_ = sx[slots] - qx[:, None]
        dy_ = sy[slots] - qy[:, None]
        dz_ = sz[slots] - qz[:, None]
        d2 = jnp.where(valid, dx_ * dx_ + dy_ * dy_ + dz_ * dz_, _INF)
        m = jnp.min(d2, axis=1)
        am = jnp.argmin(d2, axis=1).astype(jnp.int32)
        upd = m < best_d2
        best_slot = jnp.where(upd, jnp.take_along_axis(
            slots, am[:, None], axis=1)[:, 0], best_slot)
        best_d2 = jnp.minimum(best_d2, m)
    idx = grid.sorted_idx[best_slot]
    ok = jnp.isfinite(best_d2)
    return jnp.where(ok, idx, -1).astype(jnp.int32), best_d2


def knn_grid(
    grid: GridHash,
    query_xyz: jax.Array,
    k: int,
    cap_per_cell: int = 16,
    self_idx: jax.Array | None = None,
) -> Tuple[jax.Array, jax.Array]:
    """kNN via grid-hash stencil gather.

    Exact when the k-th neighbor is within cell_size of the query and each
    stencil cell holds ≤ cap_per_cell points; otherwise a high-recall
    approximation (the reference's ANN kd-tree is approximate too).

    self_idx: optional (Q,) original-row ids to exclude (self-match).
    Returns (idx (Q,k) int32 original row ids or −1, sq_dists (Q,k)).
    """
    slots, valid = _candidate_gather(grid, query_xyz, cap_per_cell)  # (Q,C)
    # per-coordinate gathers: a (Q,C,3) gather can pad its 3-wide minor axis
    cx = grid.sorted_xyz[:, 0][slots]
    cy = grid.sorted_xyz[:, 1][slots]
    cz = grid.sorted_xyz[:, 2][slots]
    cand_idx = grid.sorted_idx[slots]  # (Q,C)
    dx = cx - query_xyz[:, 0][:, None]
    dy = cy - query_xyz[:, 1][:, None]
    dz = cz - query_xyz[:, 2][:, None]
    d2 = dx * dx + dy * dy + dz * dz
    d2 = jnp.where(valid, d2, _INF)
    if self_idx is not None:
        d2 = jnp.where(cand_idx == self_idx[:, None], _INF, d2)
    neg, pos = jax.lax.top_k(-d2, k)
    sq = -neg
    idx = jnp.take_along_axis(cand_idx, pos, axis=1)
    ok = jnp.isfinite(sq)
    return jnp.where(ok, idx, -1).astype(jnp.int32), jnp.where(ok, sq, _INF)


def radius_count_grid(
    grid: GridHash, query_xyz: jax.Array, radius: float, cap_per_cell: int = 16
) -> jax.Array:
    """Number of indexed points within ``radius`` of each query (requires
    cell_size ≥ radius for exactness)."""
    slots, valid = _candidate_gather(grid, query_xyz, cap_per_cell)
    cand_xyz = grid.sorted_xyz[slots]
    diff = cand_xyz - query_xyz[:, None, :]
    d2 = jnp.sum(diff * diff, axis=-1)
    hit = valid & (d2 <= radius * radius)
    return jnp.sum(hit.astype(jnp.int32), axis=-1)

"""Point-to-plane ICP — batched correspondence gather + 6×6 Gauss-Newton.

Array re-design of `Registration` (cloud_algos/src/registration.cpp):
the reference samples 1% random correspondences per iteration, runs a
kd-tree NN per sample (:128), builds an n×6 system and solves it with a
full SVD pseudo-inverse (:40-107), 100 fixed iterations (:150).

Here every live source point is matched every iteration (an exact
brute-force argmin, or a bucketed tile engine for big clouds), residuals
are robustly weighted (Huber), the 6×6 normal equations are built by one
einsum reduction, and the pose update is a proper SE(3) exponential
rather than Euler-angle composition (:80-102).  The loop is a
`lax.scan` with a fixed, much smaller iteration count — each iteration
uses all the data, so convergence needs far fewer sweeps.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from mapping_private_tpu.core.se3 import se3_exp, se3_apply
from mapping_private_tpu.core.linalg import cholesky_solve_unrolled
from mapping_private_tpu.ops.neighbors import (
    knn_bruteforce,
    build_grid_hash,
    knn_grid,
    GridHash,
)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ICPResult:
    transform: jax.Array  # (4,4) source → target
    rmse: jax.Array  # () residual RMS over accepted correspondences
    num_corr: jax.Array  # () int32 accepted correspondences (last iter)
    per_iter_rmse: jax.Array  # (iters,)


def _gn_from_corr(
    p: jax.Array,
    idx: jax.Array,
    sq: jax.Array,
    src_mask: jax.Array,
    tgt_xyz: jax.Array,
    tgt_normals: jax.Array,
    T: jax.Array,
    max_corr_dist: float,
    huber_delta: float,
    damping: float,
):
    """The GN update given correspondences (idx, sq) for transformed
    points p — shared by every NN backend."""
    ok = src_mask & (idx >= 0) & (sq <= max_corr_dist * max_corr_dist)
    q = tgt_xyz[jnp.maximum(idx, 0)]
    n = tgt_normals[jnp.maximum(idx, 0)]
    r = jnp.sum(n * (p - q), axis=-1)  # (N,) point-to-plane residual
    # Huber weights
    absr = jnp.abs(r)
    w = jnp.where(absr <= huber_delta, 1.0, huber_delta / jnp.maximum(absr, 1e-12))
    w = jnp.where(ok, w, 0.0)
    # J_i = [n ; p × n] for update T ← exp(ξ)·T
    J = jnp.concatenate([n, jnp.cross(p, n)], axis=-1)  # (N,6)
    Jw = J * w[:, None]
    # HIGHEST precision: a reduced-precision (bf16 or TF32) product biases
    # the GN step
    H = jax.lax.dot_general(
        J, Jw, (((0,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )  # (6,6)
    g = jax.lax.dot_general(
        Jw, r, (((0,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )  # (6,)
    xi = -cholesky_solve_unrolled(H, g, jitter=damping)
    T_new = se3_exp(xi) @ T
    cnt = jnp.sum(ok.astype(jnp.int32))
    rmse = jnp.sqrt(jnp.sum(w * r * r) / jnp.maximum(jnp.sum(w), 1e-12))
    return T_new, rmse, cnt


def _gn_step(
    src_xyz: jax.Array,
    src_mask: jax.Array,
    tgt_xyz: jax.Array,
    tgt_normals: jax.Array,
    T: jax.Array,
    nn_fn,
    max_corr_dist: float,
    huber_delta: float,
    damping: float,
):
    p = se3_apply(T, src_xyz)
    idx, sq = nn_fn(p)  # (N,) int32, (N,)
    return _gn_from_corr(
        p, idx, sq, src_mask, tgt_xyz, tgt_normals, T,
        max_corr_dist, huber_delta, damping,
    )


@functools.partial(
    jax.jit,
    static_argnames=("iters", "nn_backend", "cap_per_cell", "max_corr_dist", "huber_delta", "damping", "grid_cell", "tile_origin", "tile_dims", "max_tiles", "rebucket_sweeps"),
)
def icp_point_to_plane(
    src_xyz: jax.Array,
    src_mask: jax.Array,
    tgt_xyz: jax.Array,
    tgt_mask: jax.Array,
    tgt_normals: jax.Array,
    init_T: Optional[jax.Array] = None,
    iters: int = 20,
    max_corr_dist: float = 0.25,
    huber_delta: float = 0.05,
    damping: float = 1e-6,
    nn_backend: str = "auto",
    grid_cell: float = 0.25,
    cap_per_cell: int = 16,
    tile_origin: Optional[Tuple[float, float, float]] = None,
    tile_dims: Optional[Tuple[int, int, int]] = None,
    max_tiles: int = 0,
    rebucket_sweeps: Optional[int] = None,
) -> ICPResult:
    """Align source onto target.  All shapes static.

    tgt_normals: (N,3) unit normals for the target (estimate via
    ops.normals.estimate_normals if the scan lacks them).

    nn_backend: 'pallas' (the running-argmin GPU kernel of
    ops.pallas_nn), 'xla' (dense distance matrix + argmin), 'tiled'
    (dense per-tile brute blocks — the big-cloud path, N·27·cap work;
    needs CONCRETE target arrays, so don't wrap the call in an outer
    jit), 'grid' (grid-hash stencil).  'auto' → pallas on the GPU, xla
    elsewhere.
    grid_cell doubles as the tile size for 'tiled' (must be ≥ the
    largest correspondence distance you care about).
    """
    T0 = jnp.eye(4, dtype=src_xyz.dtype) if init_T is None else init_T

    if nn_backend == "auto":
        from mapping_private_tpu.ops.pallas_nn import use_gpu_kernel

        nn_backend = "pallas" if use_gpu_kernel() else "xla"

    if nn_backend == "tiled":
        # big-cloud backend: dense per-tile brute blocks (ops/tiled_nn.py)
        # — N·27·cap work in dense batches.  The static lattice
        # (tile_origin, tile_dims) must be passed in (use
        # icp_point_to_plane_tiled to size it from concrete bounds).
        if tile_origin is None or tile_dims is None:
            raise ValueError(
                "nn_backend='tiled' needs static tile_origin/tile_dims — "
                "call icp_point_to_plane_tiled(...) instead"
            )
        if max_tiles > 0:
            # compact occupied-tiles engine with PERSISTENT query buckets:
            # the map is bucketed once; with ``rebucket_sweeps=k`` the
            # query SLOT ASSIGNMENTS are rebuilt only at the entry of k
            # uniform segments (sweeps 0, j, 2j, … with j = ceil(iters/k));
            # the other sweeps of each segment re-scatter the moved
            # coordinates into the carried layout — no per-sweep argsort.  The assignments are loop INVARIANTS of each scan
            # segment (closed over, not carried), so XLA keeps the bucket
            # blocks resident instead of threading ~15 MB through the
            # loop state.  Exactness: a query δ from where it was last
            # bucketed keeps its guaranteed NN radius tile_size − δ, and
            # post-sweep-1 motion is ≪ tile_size.
            from mapping_private_tpu.ops.tiled_nn import (
                build_compact_tiles,
                compact_nn_1nn,
                refresh_compact_coords,
            )

            origin = jnp.asarray(tile_origin, jnp.float32)
            tgt_tiles = build_compact_tiles(
                tgt_xyz, tgt_mask, origin, grid_cell, tile_dims,
                cap_per_cell, max_tiles)

            if rebucket_sweeps is None:
                # DEFAULT: re-bucket queries every sweep with a FULL
                # build.  query_only=True (skipping the valid/idx/slot_of
                # scatters) is untested inside this scan+GN program.
                def body(T, _):
                    p = se3_apply(T, src_xyz)
                    qt = build_compact_tiles(
                        p, src_mask, origin, grid_cell, tile_dims,
                        cap_per_cell, max_tiles)
                    idx, sq = compact_nn_1nn(tgt_tiles, qt)
                    T_new, rmse, cnt = _gn_from_corr(
                        p, idx, sq, src_mask, tgt_xyz, tgt_normals, T,
                        max_corr_dist, huber_delta, damping)
                    return T_new, (rmse, cnt)

                T, (rmses, cnts) = jax.lax.scan(
                    body, T0, None, length=iters)
                return ICPResult(
                    transform=T, rmse=rmses[-1], num_corr=cnts[-1],
                    per_iter_rmse=rmses)

            n_rebucket = min(max(int(rebucket_sweeps), 1), iters)

            # OPT-IN segmented mode (rebucket_sweeps=k): scan over k
            # uniform segments of j sweeps — ONE traced segment body
            # (an unrolled python loop would double the program), with
            # big bucket arrays as loop invariants, never carries.  When
            # iters isn't divisible, the trailing padded sweeps are
            # masked no-ops.
            n_seg = n_rebucket
            j = -(-iters // n_seg)
            sweep_ids = jnp.arange(n_seg * j).reshape(n_seg, j)

            def seg_body(T, ids):
                # bucket at this segment's entry pose
                qt_assign = build_compact_tiles(
                    se3_apply(T, src_xyz), src_mask, origin, grid_cell,
                    tile_dims, cap_per_cell, max_tiles)

                def body(T, k):
                    p = se3_apply(T, src_xyz)
                    qt = refresh_compact_coords(qt_assign, p)
                    idx, sq = compact_nn_1nn(tgt_tiles, qt)
                    T_new, rmse, cnt = _gn_from_corr(
                        p, idx, sq, src_mask, tgt_xyz, tgt_normals, T,
                        max_corr_dist, huber_delta, damping)
                    T_new = jnp.where(k < iters, T_new, T)
                    return T_new, (rmse, cnt)

                return jax.lax.scan(body, T, ids)

            T, (rs, cs) = jax.lax.scan(seg_body, T0, sweep_ids)
            rmses = rs.reshape(-1)[:iters]
            cnts = cs.reshape(-1)[:iters]
            return ICPResult(
                transform=T, rmse=rmses[-1], num_corr=cnts[-1],
                per_iter_rmse=rmses)

        from mapping_private_tpu.ops.tiled_nn import tiled_nn_for_icp

        nn_fn = tiled_nn_for_icp(
            tgt_xyz, tgt_mask, jnp.asarray(tile_origin, jnp.float32),
            grid_cell, tile_dims, cap_per_cell, max_tiles=max_tiles,
        )
    elif nn_backend == "grid":
        from mapping_private_tpu.ops.neighbors import nn_grid_1nn

        grid = build_grid_hash(tgt_xyz, tgt_mask, grid_cell)

        def nn_fn(p):
            return nn_grid_1nn(grid, p, cap_per_cell=cap_per_cell)

    elif nn_backend == "pallas":
        # exact argmin NN in one GPU kernel (no (N, M) distance matrix in
        # device memory); the padded target planes are built once, out of
        # the scan
        from mapping_private_tpu.ops.pallas_nn import (
            prepare_nn_ref_argmin,
            nn_argmin_prepared,
        )
        from mapping_private_tpu.core.cloud import PAD_COORD

        rt = prepare_nn_ref_argmin(
            jnp.where(tgt_mask[:, None], tgt_xyz, PAD_COORD))
        n_tgt = tgt_xyz.shape[0]

        def nn_fn(p):
            idx, sq = nn_argmin_prepared(
                jnp.where(src_mask[:, None], p, -PAD_COORD), rt)
            return jnp.minimum(idx, n_tgt - 1), sq

    else:

        def nn_fn(p):
            idx, sq = knn_bruteforce(p, tgt_xyz, tgt_mask, k=1)
            return idx[:, 0], sq[:, 0]

    def body(T, _):
        T_new, rmse, cnt = _gn_step(
            src_xyz, src_mask, tgt_xyz, tgt_normals, T, nn_fn,
            max_corr_dist, huber_delta, damping,
        )
        return T_new, (rmse, cnt)

    T, (rmses, cnts) = jax.lax.scan(body, T0, None, length=iters)
    return ICPResult(
        transform=T, rmse=rmses[-1], num_corr=cnts[-1], per_iter_rmse=rmses
    )


@jax.jit
def _lattice_geom(bt, bs, t):
    """Union lattice geometry from two (lo, hi) bounds pairs — device-
    side so the sizing chain syncs once (see icp_point_to_plane_tiled)."""
    lo = jnp.minimum(bt[0], bs[0]) - 2.0 * t
    hi = jnp.maximum(bt[1], bs[1]) + 2.0 * t
    dims = jnp.ceil((hi - lo) / t).astype(jnp.int32)
    return lo, dims


def icp_point_to_plane_tiled(
    src_xyz, src_mask, tgt_xyz, tgt_mask, tgt_normals,
    tile_size: float = 0.25, cap_per_cell: int = 256, **kwargs
) -> ICPResult:
    """Big-cloud ICP: sizes the static tile lattice AND the occupied-tile
    slot capacity from the CONCRETE target bounds, then runs the jitted
    solver with the 'tiled' NN backend (compact occupied-tile blocks —
    see ops/tiled_nn.py CompactTiles)."""
    import numpy as np

    # Occupied-tile capacity contract: max_tiles MUST cover every
    # target-occupied tile — a spilled TARGET tile silently vanishes from
    # slot_of and compact_nn_1nn returns a valid-looking *farther*
    # neighbor, not −1.  Only QUERY-side spill degrades safely to
    # no-correspondence.  Size from the union of target and initial
    # source occupancy plus 50% margin for source motion, rounded up to a
    # power of two for compile reuse.  Stats come off-device as scalars.
    from mapping_private_tpu.ops.tiled_nn import (
        check_lattice_dims, lattice_occupancy, masked_bounds)

    # lattice_occupancy takes origin and dims as DATA (not shapes), so
    # the whole sizing chain — bounds → union geometry → both
    # occupancies — is dispatched before one host sync.
    t = jnp.float32(tile_size)
    src_j, sm_j = jnp.asarray(src_xyz), jnp.asarray(src_mask)
    tgt_j, tm_j = jnp.asarray(tgt_xyz), jnp.asarray(tgt_mask)
    bt = masked_bounds(tgt_j, tm_j)
    bs = masked_bounds(src_j, sm_j)
    lo_dev, dims_dev = _lattice_geom(bt, bs, t)
    ot = lattice_occupancy(tgt_j, tm_j, lo_dev, t, dims_dev)
    os_ = lattice_occupancy(src_j, sm_j, lo_dev, t, dims_dev)
    lo, dims_a, (occ_t, maxcell_t), (occ_s, _) = jax.device_get(
        (lo_dev, dims_dev, ot, os_))
    dims = tuple(int(v) for v in dims_a)
    check_lattice_dims(dims, tile_size)
    occ_t, maxcell_t, occ_s = int(occ_t), int(maxcell_t), int(occ_s)
    occ = max(occ_t, occ_s)
    max_tiles = 1 << int(np.ceil(np.log2(max(int(1.5 * occ), 64))))
    assert max_tiles >= occ_t, "max_tiles must cover target occupancy"
    # the per-cell cap carries the same target-side contract as
    # max_tiles: a target point dropped by rank >= cap yields a
    # valid-looking farther neighbor, not -1 — raise cap to cover the
    # densest target cell (padded to a multiple of 128, a width kept from
    # the first build and unmeasured on an H100)
    cap = max(cap_per_cell, -(-maxcell_t // 128) * 128)
    return icp_point_to_plane(
        src_xyz, src_mask, tgt_xyz, tgt_mask, tgt_normals,
        nn_backend="tiled", grid_cell=tile_size, cap_per_cell=cap,
        tile_origin=tuple(float(v) for v in lo), tile_dims=dims,
        max_tiles=max_tiles, **kwargs
    )


def ate_rmse(traj_a: jax.Array, traj_b: jax.Array) -> jax.Array:
    """Absolute trajectory error between (K,4,4) pose arrays (translation
    RMS after no alignment — callers pre-align if needed)."""
    ta = traj_a[:, :3, 3]
    tb = traj_b[:, :3, 3]
    return jnp.sqrt(jnp.mean(jnp.sum((ta - tb) ** 2, axis=-1)))

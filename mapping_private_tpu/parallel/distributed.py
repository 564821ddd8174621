"""Distributed registration — sharded Gauss-Newton over a scan batch.

The multi-chip mapping step: a batch of (source, target) scan pairs is
sharded over the ``dp`` mesh axis; within each pair, *source points*
shard over ``sp``, so each device scores its slice of correspondences
against the (replicated) target and contributes a partial 6×6 normal
equation.  One ``psum`` over ``sp`` assembles the full system — the
classic reduce-then-solve pattern of distributed GN (the Schur-reduced
pose-graph BA in registration/pose_graph.py uses the same reduction over
keyframe shards).

This file is the template the driver's ``dryrun_multichip`` exercises on
a virtual CPU mesh; on hardware the same code spans the cards of a host.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from mapping_private_tpu.core.se3 import se3_exp, se3_apply


def _pair_partial_system(
    src: jax.Array,  # (n_local, 3) this device's slice of source points
    src_mask: jax.Array,  # (n_local,)
    tgt: jax.Array,  # (N, 3) full target (replicated over sp)
    tgt_mask: jax.Array,  # (N,)
    tgt_normals: jax.Array,  # (N, 3)
    T: jax.Array,  # (4,4) current pose estimate
    max_corr_dist: float,
    huber_delta: float,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Partial (H, g, count) from this shard's correspondences."""
    p = se3_apply(T, src)
    a2 = jnp.sum(p * p, axis=-1, keepdims=True)
    b2 = jnp.sum(tgt * tgt, axis=-1, keepdims=True).T
    d2 = jnp.maximum(a2 + b2 - 2.0 * (p @ tgt.T), 0.0)
    d2 = jnp.where(tgt_mask[None, :], d2, jnp.inf)
    sq = jnp.min(d2, axis=1)
    idx = jnp.argmin(d2, axis=1)
    ok = src_mask & (sq <= max_corr_dist * max_corr_dist)
    q = tgt[idx]
    n = tgt_normals[idx]
    r = jnp.sum(n * (p - q), axis=-1)
    absr = jnp.abs(r)
    w = jnp.where(absr <= huber_delta, 1.0, huber_delta / jnp.maximum(absr, 1e-12))
    w = jnp.where(ok, w, 0.0)
    J = jnp.concatenate([n, jnp.cross(p, n)], axis=-1)
    Jw = J * w[:, None]
    return J.T @ Jw, Jw.T @ r, jnp.sum(ok.astype(jnp.int32))


def make_sharded_map_icp_step(
    mesh: Mesh,
    max_corr_dist: float = 0.3,
    huber_delta: float = 0.05,
    damping: float = 1e-6,
    scan_chunk: int = 0,
):
    """One scan-to-map GN iteration with the MAP sharded over every mesh
    axis — the voxel-block sharding of SURVEY §5.7: a map too large for
    one chip's HBM spreads across the slice; each device finds its shard's
    best correspondence per scan point; one all_gather of the per-shard
    winners (7 floats/query/shard) + a cross-shard argmin yields exact
    global NN; the GN system is then built redundantly (scan is
    replicated) and solved locally — no further collective needed.

    This is the BRUTE-FORCE per-shard engine — the small-map fallback
    (O(N·M_local) per sweep).  At the 64k–1M pts/shard scale use
    make_sharded_map_icp_step_tiled, which runs the compact
    occupied-tiles engine per shard instead.

    Returns (step_fn, shardings) for
    step_fn(scan (N,3), scan_mask, map_xyz (M,3), map_mask, map_normals,
    T (4,4)) → (T_new, num_corr).
    """
    axes = tuple(mesh.axis_names)
    n_shards = 1
    for a in axes:
        n_shards *= mesh.shape[a]

    def local_step(scan, scan_mask, mxyz, mmask, mnrm, T):
        p = se3_apply(T, scan)

        # local exact NN over this device's map shard; the (N, M_local)
        # distance matrix is chunked over scan rows so HBM holds only
        # (scan_chunk, M_local) at a time — this is what lets a shard
        # carry 64k–1M map points
        mn2 = jnp.sum(mxyz * mxyz, -1, keepdims=True).T

        def nn_rows(pc):
            d2 = (
                jnp.sum(pc * pc, -1, keepdims=True)
                + mn2
                - 2.0
                * jax.lax.dot_general(
                    pc, mxyz, (((1,), (1,)), ((), ())),
                    preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST,
                )
            )
            d2 = jnp.where(mmask[None, :], d2, jnp.inf)
            loc = jnp.argmin(d2, axis=1)
            return loc, jnp.take_along_axis(d2, loc[:, None], axis=1)[:, 0]

        if scan_chunk and scan.shape[0] > scan_chunk:
            n_rows = scan.shape[0]
            n_chunks = -(-n_rows // scan_chunk)
            pad = n_chunks * scan_chunk - n_rows
            pc = jnp.pad(p, ((0, pad), (0, 0))).reshape(
                n_chunks, scan_chunk, 3)
            loc, best_d2 = jax.lax.map(nn_rows, pc)
            loc = loc.reshape(-1)[:n_rows]
            best_d2 = best_d2.reshape(-1)[:n_rows]
        else:
            loc, best_d2 = nn_rows(p)
        best_q = mxyz[loc]
        best_n = mnrm[loc]
        # exchange per-shard winners; pick the global best per scan point
        cand = jnp.concatenate(
            [best_d2[:, None], best_q, best_n], axis=1
        )  # (N, 7)
        allc = cand
        for a in axes:
            allc = jax.lax.all_gather(allc, a)
            allc = allc.reshape((-1,) + cand.shape)
        win = jnp.argmin(allc[..., 0], axis=0)  # (N,)
        idxs = jnp.broadcast_to(win[None, :, None], (1,) + allc.shape[1:])
        sel = jnp.take_along_axis(allc, idxs, axis=0)[0]
        sq, q, n = sel[:, 0], sel[:, 1:4], sel[:, 4:7]

        ok = scan_mask & (sq <= max_corr_dist * max_corr_dist)
        r = jnp.sum(n * (p - q), axis=-1)
        absr = jnp.abs(r)
        w = jnp.where(absr <= huber_delta, 1.0, huber_delta / jnp.maximum(absr, 1e-12))
        w = jnp.where(ok, w, 0.0)
        J = jnp.concatenate([n, jnp.cross(p, n)], axis=-1)
        Jw = J * w[:, None]
        H = jax.lax.dot_general(
            J, Jw, (((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        g = jax.lax.dot_general(
            Jw, r, (((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        xi = -jnp.linalg.solve(H + damping * jnp.eye(6), g)
        T_new = se3_exp(xi) @ T
        return T_new, jnp.sum(ok.astype(jnp.int32))

    specs_in = (
        P(),  # scan replicated
        P(),  # scan_mask
        P(axes, None),  # map xyz sharded on points
        P(axes),  # map mask
        P(axes, None),  # map normals
        P(),  # pose replicated
    )
    specs_out = (P(), P())
    step = jax.jit(
        shard_map(
            local_step, mesh=mesh, in_specs=specs_in, out_specs=specs_out,
            # outputs ARE replicated (every device computes the same argmin
            # over the all_gathered winners), but that's data-dependent —
            # not statically provable — so disable the replication check
            check_vma=False,
        )
    )
    shardings = tuple(NamedSharding(mesh, s) for s in specs_in)
    return step, shardings


def size_map_lattice(
    map_xyz,
    map_mask,
    tile_size: float,
    scan_xyz=None,
    tile_margin: float = 1.5,
):
    """Size the static tile lattice for the tiled sharded map-ICP from
    CONCRETE map (and optionally scan) bounds — host-side, like
    icp_point_to_plane_tiled.  Returns (origin, dims, cap, max_tiles).

    max_tiles covers the GLOBAL map occupancy, so every shard's slice
    (≤ global occupancy) is covered too — target-side spill would return
    farther neighbors, never −1 (see ops.tiled_nn.build_compact_tiles).
    """
    import numpy as np

    pts = [np.asarray(map_xyz)[np.asarray(map_mask)]]
    if scan_xyz is not None:
        s = np.asarray(scan_xyz)
        # drop PAD_COORD sentinel rows of padded scans — one stray +1e8
        # row would blow the lattice bounds (and the D+1 slot_of alloc)
        pts.append(s[np.all(np.abs(s) < 1e7, axis=1)])
    lo = np.min([p.min(0) for p in pts], axis=0) - 2 * tile_size
    hi = np.max([p.max(0) for p in pts], axis=0) + 2 * tile_size
    dims = tuple(int(v) for v in np.ceil((hi - lo) / tile_size))
    from mapping_private_tpu.ops.tiled_nn import check_lattice_dims
    check_lattice_dims(dims, tile_size)
    cell = np.floor((pts[0] - lo) / tile_size).astype(np.int64)
    flat = (cell[:, 0] * dims[1] + cell[:, 1]) * dims[2] + cell[:, 2]
    _, counts = np.unique(flat, return_counts=True)
    occ, percell = len(counts), int(counts.max())
    cap = max(128, -(-percell // 128) * 128)
    max_tiles = 1 << int(np.ceil(np.log2(max(int(tile_margin * occ), 64))))
    return tuple(float(v) for v in lo), dims, cap, max_tiles


def make_sharded_map_icp_step_tiled(
    mesh: Mesh,
    origin,
    tile_size: float,
    dims,
    cap: int,
    max_tiles: int,
    q_cap: int = 128,
    q_max_tiles: int = 4096,
    max_corr_dist: float = 0.3,
    huber_delta: float = 0.05,
    damping: float = 1e-6,
    sweeps: int = 1,
):
    """Sharded scan-to-map ICP with the COMPACT-TILES NN engine per shard
    — the fast path for 64k–1M map points per device, replacing the
    brute-force (scan × M_local) matrices of make_sharded_map_icp_step
    with the single-card occupied-tiles engine (ops/tiled_nn.py).

    Each device buckets its own map slice ONCE per step call; the
    replicated scan re-buckets per GN sweep (it moves, and it's small);
    per-shard winners exchange via the existing 7-float all_gather +
    cross-shard argmin, so the result is the exact global NN within
    ``tile_size``.  ``sweeps`` GN iterations run inside one traced scan —
    the map buckets are reused across all of them.

    The lattice (origin/tile_size/dims/cap/max_tiles) must be sized from
    concrete bounds — use size_map_lattice.  q_max_tiles bounds the
    SCAN's occupied tiles (query spill degrades to no-correspondence,
    which is safe).

    Returns (step_fn, shardings) with the same signature as
    make_sharded_map_icp_step: step_fn(scan, scan_mask, map_xyz,
    map_mask, map_normals, T) → (T_new, num_corr at the last sweep).
    """
    from mapping_private_tpu.ops.tiled_nn import (
        build_compact_tiles,
        compact_nn_1nn,
    )

    axes = tuple(mesh.axis_names)
    o = jnp.asarray(origin, jnp.float32)
    dims = tuple(int(d) for d in dims)

    def local_step(scan, scan_mask, mxyz, mmask, mnrm, T):
        tiles = build_compact_tiles(
            mxyz, mmask, o, tile_size, dims, cap, max_tiles)

        def sweep(T, _):
            p = se3_apply(T, scan)
            qt = build_compact_tiles(
                p, scan_mask, o, tile_size, dims, q_cap, q_max_tiles)
            idx, sq = compact_nn_1nn(tiles, qt)
            has = idx >= 0
            i = jnp.maximum(idx, 0)
            cand = jnp.concatenate(
                [jnp.where(has, sq, jnp.inf)[:, None], mxyz[i], mnrm[i]],
                axis=1,
            )  # (N, 7) this shard's winners
            allc = cand
            for a in axes:
                allc = jax.lax.all_gather(allc, a)
                allc = allc.reshape((-1,) + cand.shape)
            win = jnp.argmin(allc[..., 0], axis=0)
            idxs = jnp.broadcast_to(win[None, :, None], (1,) + allc.shape[1:])
            sel = jnp.take_along_axis(allc, idxs, axis=0)[0]
            sq_g, q, n = sel[:, 0], sel[:, 1:4], sel[:, 4:7]

            ok = scan_mask & (sq_g <= max_corr_dist * max_corr_dist)
            r = jnp.sum(n * (p - q), axis=-1)
            absr = jnp.abs(r)
            w = jnp.where(
                absr <= huber_delta, 1.0,
                huber_delta / jnp.maximum(absr, 1e-12))
            w = jnp.where(ok, w, 0.0)
            J = jnp.concatenate([n, jnp.cross(p, n)], axis=-1)
            Jw = J * w[:, None]
            H = jax.lax.dot_general(
                J, Jw, (((0,), (0,)), ((), ())),
                preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST,
            )
            g = jax.lax.dot_general(
                Jw, r, (((0,), (0,)), ((), ())),
                preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST,
            )
            xi = -jnp.linalg.solve(H + damping * jnp.eye(6), g)
            return se3_exp(xi) @ T, jnp.sum(ok.astype(jnp.int32))

        T, cnts = jax.lax.scan(sweep, T, None, length=sweeps)
        return T, cnts[-1]

    specs_in = (
        P(),  # scan replicated
        P(),  # scan_mask
        P(axes, None),  # map xyz sharded on points
        P(axes),  # map mask
        P(axes, None),  # map normals
        P(),  # pose replicated
    )
    specs_out = (P(), P())
    step = jax.jit(
        shard_map(
            local_step, mesh=mesh, in_specs=specs_in, out_specs=specs_out,
            # outputs replicated by the data-dependent cross-shard argmin
            check_vma=False,
        )
    )
    shardings = tuple(NamedSharding(mesh, s) for s in specs_in)
    return step, shardings


def make_sharded_registration_step(
    mesh: Mesh,
    max_corr_dist: float = 0.25,
    huber_delta: float = 0.05,
    damping: float = 1e-6,
):
    """Build a jitted step: (src (B,N,3), src_mask, tgt (B,N,3), tgt_mask,
    tgt_normals, poses (B,4,4)) → updated poses (B,4,4).

    B shards over dp; source points shard over sp; target replicated over
    sp.  Returns (step_fn, input_shardings) so callers can device_put.
    """

    def local_step(src, src_mask, tgt, tgt_mask, tgt_normals, poses):
        # shapes here are per-device: (B/dp, N/sp, 3), targets (B/dp, N, 3)
        def one_pair(s, sm, t, tm, tn, T):
            H, g, cnt = _pair_partial_system(
                s, sm, t, tm, tn, T, max_corr_dist, huber_delta
            )
            return H, g, cnt

        H, g, cnt = jax.vmap(one_pair)(src, src_mask, tgt, tgt_mask, tgt_normals, poses)
        # assemble the full normal equations across the sp shards
        H = jax.lax.psum(H, "sp")
        g = jax.lax.psum(g, "sp")
        cnt = jax.lax.psum(cnt, "sp")

        def solve_one(H1, g1, T1):
            xi = -jnp.linalg.solve(H1 + damping * jnp.eye(6, dtype=H1.dtype), g1)
            return se3_exp(xi) @ T1

        new_poses = jax.vmap(solve_one)(H, g, poses)
        return new_poses, cnt

    specs_in = (
        P("dp", "sp", None),  # src
        P("dp", "sp"),  # src_mask
        P("dp", None, None),  # tgt (replicated over sp)
        P("dp", None),  # tgt_mask
        P("dp", None, None),  # tgt_normals
        P("dp", None, None),  # poses
    )
    specs_out = (P("dp", None, None), P("dp"))
    step = jax.jit(
        shard_map(local_step, mesh=mesh, in_specs=specs_in, out_specs=specs_out)
    )
    shardings = tuple(NamedSharding(mesh, s) for s in specs_in)
    return step, shardings


def balance_map_shards(map_xyz, mask, tile_size: float, n_shards: int):
    """Occupancy-balancing permutation for the evenly row-sharded map.

    The sharded tiled map step splits map rows into contiguous equal
    blocks; on a spatially-ordered skewed scene (corridor + dense
    cluster) that gives shards wildly different occupied-tile counts —
    the sizing skew scripts/bench_scaling.py reports (per-shard compute itself is
    static-shaped and skew-immune, but global max_tiles must cover the
    WORST shard's occupancy).  This host-side helper returns a
    permutation that deals live points round-robin over shards in
    lattice-tile order, so every shard samples every region and the
    per-shard occupied-tile counts equalize.  Apply as
    ``map_xyz[perm]`` (and to masks/normals) before device_put.
    """
    import numpy as np

    xyz = np.asarray(map_xyz)
    m = np.asarray(mask)
    if not m.any():
        return np.arange(len(xyz), dtype=np.int64)  # nothing to balance
    lo = xyz[m].min(0) - tile_size
    cell = np.floor((xyz - lo) / tile_size).astype(np.int64)
    ext = cell[m].max(0) + 1
    flat = (cell[:, 0] * ext[1] + cell[:, 1]) * ext[2] + cell[:, 2]
    flat = np.where(m, flat, np.int64(1) << 60)  # dead rows sort last
    order = np.argsort(flat, kind="stable")
    # deal in tile order: position i of the sorted list goes to shard
    # i % n_shards, preserving tile order within each shard
    M = len(xyz)
    perm = np.empty(M, np.int64)
    pos = 0
    for s in range(n_shards):
        sel = order[s::n_shards]
        perm[pos : pos + len(sel)] = sel
        pos += len(sel)
    return perm

"""Tiled dense 1-NN — the big-cloud correspondence engine.

Replaces the reference's per-query kd-tree (cloud_algos/src/
registration.cpp:128) at scales where both brute force (O(N²)) and
pointer-chasing grid gathers (random device-memory access) fall over.
Design: bucket BOTH clouds into a static lattice of spatial tiles, then
compute dense (P_q × P_t) distance blocks between each query tile and
its 27 neighbor target tiles — all compute is dense batched
elementwise/reduction work, the only gathers are per-TILE (contiguous
(P,3) blocks).  Work drops from N² to N·27·P.

Exactness: the true NN is found whenever it lies within ``tile_size`` of
the query (the 3³ stencil then covers it) and neither point's tile
overflowed ``cap``.  Overflowed entries return idx −1 (callers treat
them as no-correspondence, exactly like an out-of-range match).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

_INF = jnp.float32(jnp.inf)


def _minloc(d2: jax.Array, payload: jax.Array):
    """(min, payload-at-min) over the last axis in ONE variadic reduce."""

    def red(a, b):
        ad, ai = a
        bd, bi = b
        pick = bd < ad
        return jnp.where(pick, bd, ad), jnp.where(pick, bi, ai)

    return jax.lax.reduce(
        (d2, payload),
        (_INF, jnp.int32(-1)),
        red,
        (d2.ndim - 1,),
    )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TileSet:
    """Points bucketed into a (Dx·Dy·Dz, cap) tile lattice.

    Coordinates are stored as PLANES (T, 3, cap) — the cap axis is the
    minor axis, so per-tile block gathers stay unpadded; a (T, cap, 3)
    layout's 3-wide minor axis can be padded to a full vector width."""

    xyz: jax.Array        # (T, 3, cap) padded member coordinate planes
    valid: jax.Array      # (T, cap) bool
    idx: jax.Array        # (T, cap) int32 original rows (-1 pad)
    tile_of: jax.Array    # (N,) int32 flat tile id per original row
    rank_of: jax.Array    # (N,) int32 rank within tile (may exceed cap)
    origin: jax.Array     # (3,)
    tile_size: jax.Array  # ()
    dims: Tuple[int, int, int] = dataclasses.field(
        metadata=dict(static=True))
    cap: int = dataclasses.field(metadata=dict(static=True))


def build_tiles(
    xyz: jax.Array,
    mask: jax.Array,
    origin,
    tile_size: float,
    dims: Tuple[int, int, int],
    cap: int,
) -> TileSet:
    """Bucket a fixed-capacity cloud into the lattice.

    origin/dims/tile_size define a static lattice (callers size it from
    known scene bounds); points outside are clamped to border tiles.
    """
    n = xyz.shape[0]
    dx, dy, dz = dims
    t = jnp.asarray(tile_size, jnp.float32)
    o = jnp.asarray(origin, jnp.float32)
    cell = jnp.clip(
        jnp.floor((xyz - o) / t).astype(jnp.int32),
        jnp.zeros((3,), jnp.int32),
        jnp.asarray([dx - 1, dy - 1, dz - 1], jnp.int32),
    )
    flat = (cell[:, 0] * dy + cell[:, 1]) * dz + cell[:, 2]
    flat = jnp.where(mask, flat, dx * dy * dz)  # dead rows → overflow tile
    order = jnp.argsort(flat)
    fs = flat[order]
    # rank within tile = position − first position of the tile's run
    first = jnp.searchsorted(fs, fs, side="left")
    rank = jnp.arange(n, dtype=jnp.int32) - first.astype(jnp.int32)
    T = dx * dy * dz
    keep = (fs < T) & (rank < cap)
    tgt_tile = jnp.where(keep, fs, T)  # dumps overflow into a spare slot
    tgt_rank = jnp.where(keep, rank, 0)
    tiles_xyz = jnp.zeros((T + 1, cap, 3), xyz.dtype)
    tiles_valid = jnp.zeros((T + 1, cap), bool)
    tiles_idx = jnp.full((T + 1, cap), -1, jnp.int32)
    tiles_xyz = tiles_xyz.at[tgt_tile, tgt_rank].set(xyz[order])
    tiles_valid = tiles_valid.at[tgt_tile, tgt_rank].set(keep)
    tiles_idx = tiles_idx.at[tgt_tile, tgt_rank].set(
        jnp.where(keep, order.astype(jnp.int32), -1))
    # per-original-row tile/rank (for the query side)
    tile_of = jnp.zeros((n,), jnp.int32).at[order].set(
        jnp.minimum(fs, T).astype(jnp.int32))
    rank_of = jnp.zeros((n,), jnp.int32).at[order].set(rank)
    return TileSet(
        xyz=jnp.swapaxes(tiles_xyz[:T], 1, 2),  # (T, 3, cap) planes
        valid=tiles_valid[:T], idx=tiles_idx[:T],
        tile_of=tile_of, rank_of=rank_of,
        origin=o, tile_size=t, dims=dims, cap=cap,
    )


def tiled_nn_1nn(
    tgt: TileSet,
    qry: TileSet,
    query_xyz: jax.Array,
) -> Tuple[jax.Array, jax.Array]:
    """Exact-within-tile_size 1-NN of every query against the target set.

    qry must be built over the SAME lattice (origin/tile_size/dims) as
    tgt; query_xyz are the original query coordinates.  Returns
    (idx (N,) int32 target rows or −1, sq_dists (N,)).
    Work: 27 offsets × (T, P, P) dense distance blocks, chunked over T.
    """
    dx, dy, dz = tgt.dims
    T = dx * dy * dz
    Q = qry.cap

    tid = jnp.arange(T, dtype=jnp.int32)
    tz = tid % dz
    ty = (tid // dz) % dy
    tx = tid // (dy * dz)
    qp = qry.xyz  # (T, 3, Q) coordinate planes

    offs = jnp.asarray(
        [[ox, oy, oz] for ox in (-1, 0, 1) for oy in (-1, 0, 1)
         for oz in (-1, 0, 1)], jnp.int32)

    def body(carry, off):
        best_d2, best_idx = carry
        nx_, ny_, nz_ = tx + off[0], ty + off[1], tz + off[2]
        ok = ((nx_ >= 0) & (nx_ < dx) & (ny_ >= 0) & (ny_ < dy)
              & (nz_ >= 0) & (nz_ < dz))
        nid = jnp.where(ok, (nx_ * dy + ny_) * dz + nz_, 0)
        cp = tgt.xyz[nid]                      # (T, 3, P) plane blocks
        cvalid = tgt.valid[nid] & ok[:, None]  # (T, P)
        cidx = tgt.idx[nid]
        # per-coordinate broadcast differences: exact f32 distances (no
        # norm-identity rounding), and the (T, Q, P) expression fuses
        # with the min/argmin reductions instead of materializing
        d2 = (
            (qp[:, 0, :, None] - cp[:, 0, None, :]) ** 2
            + (qp[:, 1, :, None] - cp[:, 1, None, :]) ** 2
            + (qp[:, 2, :, None] - cp[:, 2, None, :]) ** 2
        )
        d2 = jnp.where(cvalid[:, None, :], d2, _INF)
        m = jnp.min(d2, axis=-1)
        am = jnp.argmin(d2, axis=-1)
        sel = jnp.take_along_axis(cidx, am, axis=-1)
        upd = m < best_d2
        return (jnp.minimum(best_d2, m),
                jnp.where(upd, sel, best_idx)), None

    (best_d2, best_idx), _ = jax.lax.scan(
        body,
        (jnp.full((T, Q), _INF), jnp.full((T, Q), -1, jnp.int32)),
        offs,
    )

    # scatter back to original query order; overflowed queries → −1
    n = query_xyz.shape[0]
    in_cap = qry.rank_of < Q
    srow = jnp.minimum(qry.tile_of, T - 1)
    srank = jnp.minimum(qry.rank_of, Q - 1)
    idx = jnp.where(in_cap, best_idx[srow, srank], -1)
    d2 = jnp.where(in_cap, best_d2[srow, srank], _INF)
    live = qry.tile_of < T
    return (jnp.where(live, idx, -1).astype(jnp.int32),
            jnp.where(live, d2, _INF))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CompactTiles:
    """Occupied-tiles-only bucketing.

    The dense ``TileSet`` kernel spends its time on empty lattice cells —
    point clouds are surfaces, so occupancy is a few percent (43,740
    lattice tiles vs ~3k occupied at 200k points / 0.1 m tiles).  Here
    only occupied tiles get bucket rows; a dense
    ``slot_of`` lookup (one int32 per lattice cell) resolves stencil
    neighbors.  Work drops from D·27·cap² to S·27·cap² where S = occupied
    tiles."""

    xyz: jax.Array         # (S, 3, cap) occupied-tile coordinate planes
    valid: jax.Array       # (S, cap)
    idx: jax.Array         # (S, cap) int32 original rows (-1 pad)
    tile_id: jax.Array     # (S,) int32 flat lattice id (D for dead slots)
    slot_of: jax.Array     # (D+1,) int32 lattice id → slot (-1 empty)
    slot_of_pt: jax.Array  # (N,) int32 slot per original row (-1 spilled)
    rank_of: jax.Array     # (N,) int32 rank within the tile
    # scatter plan in SORTED order (refresh_compact_coords's fast path:
    # monotone destination indices)
    sorted_rows: jax.Array  # (N,) int32 original row per sorted position
    sorted_slot: jax.Array  # (N,) int32 destination slot (spill row = S)
    sorted_rank: jax.Array  # (N,) int32 destination rank
    origin: jax.Array      # (3,)
    tile_size: jax.Array   # ()
    dims: Tuple[int, int, int] = dataclasses.field(
        metadata=dict(static=True))
    cap: int = dataclasses.field(metadata=dict(static=True))
    max_tiles: int = dataclasses.field(metadata=dict(static=True))


def build_compact_tiles(
    xyz: jax.Array,
    mask: jax.Array,
    origin,
    tile_size: float,
    dims: Tuple[int, int, int],
    cap: int,
    max_tiles: int,
    query_only: bool = False,
) -> CompactTiles:
    """Bucket points into occupied-tile slots (sorted-run compaction).

    Occupied tiles beyond ``max_tiles`` spill: their points get slot −1.
    On the QUERY side of compact_nn_1nn that reads back as
    no-correspondence (idx −1), the same safe contract as cap overflow.
    On the TARGET side it is NOT safe: a spilled target tile vanishes
    from ``slot_of``, so queries near it get a valid-looking *farther*
    neighbor instead of −1.  max_tiles MUST cover every target-occupied
    tile — size it from concrete occupancy counts
    (see icp_point_to_plane_tiled)."""
    n = xyz.shape[0]
    dx, dy, dz = dims
    D = dx * dy * dz
    t = jnp.asarray(tile_size, jnp.float32)
    o = jnp.asarray(origin, jnp.float32)
    cell = jnp.clip(
        jnp.floor((xyz - o) / t).astype(jnp.int32),
        jnp.zeros((3,), jnp.int32),
        jnp.asarray([dx - 1, dy - 1, dz - 1], jnp.int32),
    )
    flat = (cell[:, 0] * dy + cell[:, 1]) * dz + cell[:, 2]
    flat = jnp.where(mask, flat, D)
    order = jnp.argsort(flat)
    fs = flat[order]
    live = fs < D
    is_first = jnp.concatenate(
        [jnp.ones((1,), bool), fs[1:] != fs[:-1]]) & live
    slot = jnp.cumsum(is_first.astype(jnp.int32)) - 1  # per sorted point
    first_pos = jnp.searchsorted(fs, fs, side="left")
    rank = jnp.arange(n, dtype=jnp.int32) - first_pos.astype(jnp.int32)
    keep = live & (slot < max_tiles) & (rank < cap)
    s = jnp.where(keep, slot, max_tiles)
    r = jnp.where(keep, rank, 0)
    bx = jnp.zeros((max_tiles + 1, cap, 3), xyz.dtype).at[s, r].set(xyz[order])
    tile_id = jnp.full((max_tiles + 1,), D, jnp.int32).at[s].set(
        jnp.where(keep, fs, D))
    slot_of_pt = jnp.zeros((n,), jnp.int32).at[order].set(
        jnp.where(live & (slot < max_tiles), slot, -1))
    rank_of = jnp.zeros((n,), jnp.int32).at[order].set(rank)
    if query_only:
        # the QUERY side of compact_nn_1nn reads only xyz/tile_id/
        # slot_of_pt/rank_of — skip the valid/idx/slot_of scatters
        # (per-sweep query re-bucketing is the tiled-ICP overhead)
        bvalid = jnp.zeros((max_tiles, cap), bool)
        bidx = jnp.full((max_tiles, cap), -1, jnp.int32)
        slot_of = jnp.full((D + 1,), -1, jnp.int32)
    else:
        bvalid = jnp.zeros((max_tiles + 1, cap), bool).at[s, r].set(
            keep)[:max_tiles]
        bidx = jnp.full((max_tiles + 1, cap), -1, jnp.int32).at[s, r].set(
            jnp.where(keep, order.astype(jnp.int32), -1))[:max_tiles]
        slot_of = jnp.full((D + 1,), -1, jnp.int32).at[
            jnp.where(keep, fs, D)].set(s)
        slot_of = slot_of.at[D].set(-1)
    return CompactTiles(
        xyz=jnp.swapaxes(bx[:max_tiles], 1, 2), valid=bvalid,
        idx=bidx, tile_id=tile_id[:max_tiles],
        slot_of=slot_of, slot_of_pt=slot_of_pt, rank_of=rank_of,
        sorted_rows=order.astype(jnp.int32),
        sorted_slot=s.astype(jnp.int32), sorted_rank=r.astype(jnp.int32),
        origin=o, tile_size=t, dims=dims, cap=cap, max_tiles=max_tiles,
    )


def check_lattice_dims(dims, radius) -> None:
    """Guard every host-side lattice sizing against int32 key overflow.

    build_compact_tiles / lattice_occupancy compute flat int32 cell keys
    and allocate a (n_cells+1,) slot_of table; dims whose product nears
    2**31 wrap the keys (garbage occupancy → under-sized max_tiles →
    silently FARTHER neighbors) or hit a multi-GB allocation with no
    clear error.  Call from every wrapper that turns concrete bounds
    into a lattice (nn_1nn, icp_point_to_plane_tiled, size_map_lattice).
    """
    n_cells = int(dims[0]) * int(dims[1]) * int(dims[2])
    if n_cells >= 2 ** 31:
        raise ValueError(
            f"tile lattice {tuple(int(d) for d in dims)} has {n_cells} "
            f"cells >= 2**31: int32 flat cell keys would wrap (silent "
            f"wrong neighbors). Increase the search radius/tile size "
            f"(currently {float(radius)}) or crop the cloud extent.")
    if n_cells > 1 << 28:  # slot_of alone > 1 GiB int32
        raise ValueError(
            f"tile lattice {tuple(int(d) for d in dims)} has {n_cells} "
            f"cells (> 2**28): the (n_cells+1,) slot lookup table would "
            f"exceed 1 GiB. Increase the search radius/tile size "
            f"(currently {float(radius)}) or crop the cloud extent.")


@jax.jit
def masked_bounds(xyz: jax.Array, mask: jax.Array):
    """(lo (3,), hi (3,)) of the live points — the shared device-side
    bounds helper for host wrappers that size lattices (scalar transfer
    instead of pulling the cloud)."""
    big = jnp.float32(1e8)
    return (jnp.min(jnp.where(mask[:, None], xyz, big), axis=0),
            jnp.max(jnp.where(mask[:, None], xyz, -big), axis=0))


@jax.jit
def lattice_occupancy(xyz: jax.Array, mask: jax.Array, origin, tile, dims):
    """(occupied-cell count, max points in one cell) on the lattice —
    device-side, so sizing wrappers transfer two scalars instead of the
    cloud (12 MB per 1M points).
    ``dims`` rides along as a TRACED (3,) int32 array (one compiled
    program serves every scene) and keys stay int32 — jax's default
    int64 is disabled, so bit-packed 64-bit keys would silently
    truncate."""
    o = jnp.asarray(origin, jnp.float32)
    d = jnp.asarray(dims, jnp.int32)
    cell = jnp.clip(
        jnp.floor((xyz - o) / tile).astype(jnp.int32),
        jnp.zeros((3,), jnp.int32), d - 1)
    key = (cell[:, 0] * d[1] + cell[:, 1]) * d[2] + cell[:, 2]
    dead = jnp.int32(2 ** 31 - 1)
    ks = jnp.sort(jnp.where(mask, key, dead))
    live = ks < dead
    newrun = jnp.concatenate([jnp.ones((1,), bool), ks[1:] != ks[:-1]])
    occ = jnp.sum((newrun & live).astype(jnp.int32))
    n = xyz.shape[0]
    first = jnp.searchsorted(ks, ks, side="left")
    run_len = jnp.arange(n, dtype=jnp.int32) - first.astype(jnp.int32) + 1
    maxcell = jnp.max(jnp.where(live, run_len, 0))
    return occ, maxcell


def refresh_compact_coords(ct: CompactTiles, xyz: jax.Array) -> CompactTiles:
    """Re-scatter CURRENT coordinates into an existing slot layout —
    the cheap between-sweeps path of tiled ICP: bucket assignments
    (argsort-bound) are reused, only a gather + SORTED scatter of the
    (N,3) coordinates runs (the stored sorted scatter plan keeps the
    destination indices monotone).

    Exactness shrinks gracefully: a point that moved δ from where it was
    bucketed is still guaranteed its true NN within ``tile_size − δ``
    (the 3³ stencil around the STALE tile covers that ball).  Callers
    re-bucket when accumulated motion exceeds their margin
    (see registration.icp icp_point_to_plane's tiled backend)."""
    bx = jnp.zeros((ct.max_tiles + 1, ct.cap, 3), xyz.dtype).at[
        ct.sorted_slot, ct.sorted_rank].set(xyz[ct.sorted_rows])
    return dataclasses.replace(ct, xyz=jnp.swapaxes(bx[:ct.max_tiles], 1, 2))


def compact_nn_1nn(
    tgt: CompactTiles,
    qry: CompactTiles,
) -> Tuple[jax.Array, jax.Array]:
    """Exact-within-tile_size 1-NN over occupied tiles only.

    Same contract as tiled_nn_1nn (results are scattered back to the
    original query rows via qry.slot_of_pt/rank_of, so no raw coordinates
    are needed here); qry shares tgt's lattice.  Work: 27 offsets ×
    (S, Q, P) dense blocks with S = occupied query tiles."""
    dx, dy, dz = tgt.dims
    D = dx * dy * dz
    S = qry.max_tiles
    Q = qry.cap

    tid = qry.tile_id  # (S,) lattice id, D for dead slots
    tz = tid % dz
    ty = (tid // dz) % dy
    tx = tid // (dy * dz)
    slot_live = tid < D
    qp = qry.xyz  # (S, 3, Q)

    offs = jnp.asarray(
        [[ox, oy, oz] for ox in (-1, 0, 1) for oy in (-1, 0, 1)
         for oz in (-1, 0, 1)], jnp.int32)

    def body(carry, off):
        best_d2, best_idx = carry
        nx_, ny_, nz_ = tx + off[0], ty + off[1], tz + off[2]
        ok = (slot_live & (nx_ >= 0) & (nx_ < dx) & (ny_ >= 0) & (ny_ < dy)
              & (nz_ >= 0) & (nz_ < dz))
        nid = jnp.where(ok, (nx_ * dy + ny_) * dz + nz_, D)
        nslot = tgt.slot_of[nid]               # (S,) −1 when empty
        has = nslot >= 0
        cp = tgt.xyz[jnp.maximum(nslot, 0)]    # (S, 3, P)
        cvalid = tgt.valid[jnp.maximum(nslot, 0)] & has[:, None]
        cidx = tgt.idx[jnp.maximum(nslot, 0)]
        d2 = (
            (qp[:, 0, :, None] - cp[:, 0, None, :]) ** 2
            + (qp[:, 1, :, None] - cp[:, 1, None, :]) ** 2
            + (qp[:, 2, :, None] - cp[:, 2, None, :]) ** 2
        )
        d2 = jnp.where(cvalid[:, None, :], d2, _INF)
        # single-pass variadic reduce: min AND carrier index in one sweep
        # of the (S, Q, P) block (a separate jnp.min + jnp.argmin +
        # take_along_axis walks the materialized block three times)
        m, sel = _minloc(d2, jnp.broadcast_to(cidx[:, None, :], d2.shape))
        upd = m < best_d2
        return (jnp.minimum(best_d2, m),
                jnp.where(upd, sel, best_idx)), None

    (best_d2, best_idx), _ = jax.lax.scan(
        body,
        (jnp.full((S, Q), _INF), jnp.full((S, Q), -1, jnp.int32)),
        offs,
    )

    ok_pt = (qry.slot_of_pt >= 0) & (qry.rank_of < Q)
    srow = jnp.maximum(qry.slot_of_pt, 0)
    srank = jnp.minimum(qry.rank_of, Q - 1)
    idx = jnp.where(ok_pt, best_idx[srow, srank], -1)
    d2 = jnp.where(ok_pt, best_d2[srow, srank], _INF)
    return idx.astype(jnp.int32), d2


def tiled_nn_for_icp(
    tgt_xyz: jax.Array,
    tgt_mask: jax.Array,
    origin,
    tile_size: float,
    dims: Tuple[int, int, int],
    cap: int,
    max_tiles: int = 0,
):
    """Returns nn_fn(p) → (idx (N,), sq (N,)) closing over prebuilt target
    tiles — the ICP 'tiled' backend.  max_tiles > 0 selects the compact
    occupied-tiles engine (the fast path; see CompactTiles)."""
    if max_tiles > 0:
        tgt_tiles = build_compact_tiles(
            tgt_xyz, tgt_mask, origin, tile_size, dims, cap, max_tiles)

        def nn_fn(p):
            q_tiles = build_compact_tiles(
                p, jnp.ones((p.shape[0],), bool), origin, tile_size, dims,
                cap, max_tiles, query_only=True)
            return compact_nn_1nn(tgt_tiles, q_tiles)

        return nn_fn

    tgt_tiles = build_tiles(tgt_xyz, tgt_mask, origin, tile_size, dims, cap)

    def nn_fn(p):
        q_tiles = build_tiles(
            p, jnp.ones((p.shape[0],), bool), origin, tile_size, dims, cap
        )
        return tiled_nn_1nn(tgt_tiles, q_tiles, p)

    return nn_fn

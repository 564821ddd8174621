"""One front door for exact 1-NN — size-driven engine dispatch.

Replaces every hand-picked engine choice for the reference's kd-tree NN
(cloud_algos/src/registration.cpp:128, noise_removal.cpp:73,
region_growing.cpp:109) with a single ``nn_1nn`` call that selects the
right engine from the problem size:

- **brute** (`ops.pallas_nn` on the GPU, dense XLA elsewhere): exact
  global argmin, no radius needed.  Used below ``BRUTE_PAIR_LIMIT``
  query×target pairs.
- **compact** (`ops.tiled_nn.CompactTiles`): occupied-tiles stencil
  engine, work N·27·cap instead of N·M.  Needs a search ``radius`` (the
  tile size); exact within it.  Used above the brute limit.
- **lattice** (`ops.tiled_nn.TileSet`): the dense-lattice variant.  Its
  program grows with the lattice, so requests beyond
  ``LATTICE_CELL_LIMIT`` cells fall back to compact.

This is a host-level dispatcher: it inspects CONCRETE array bounds to
size lattices, so don't call it under an outer ``jit`` (each engine's
inner compute is jitted).  Dead queries and beyond-radius queries return
idx −1 / sq inf.
"""
from __future__ import annotations

import warnings
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

# Brute force below this many query×target pairs: the compact engine's
# bucketing sorts only pay for themselves on larger problems.  Unmeasured
# on an H100.
BRUTE_PAIR_LIMIT = 1 << 30
# Dense-lattice programs grow with the cell count; beyond this many cells
# the request goes to the compact engine.  Unmeasured on an H100.
LATTICE_CELL_LIMIT = 1 << 17


def _lattice_geometry(bounds_list, radius):
    lo = np.min([b[0] for b in bounds_list], axis=0) - 2 * radius
    hi = np.max([b[1] for b in bounds_list], axis=0) + 2 * radius
    dims = tuple(int(v) for v in np.ceil((hi - lo) / radius))
    return lo.astype(np.float32), dims


def choose_nn_engine(
    n_query: int,
    n_target: int,
    radius: Optional[float],
) -> str:
    """The dispatch policy, separated out so tests can pin it."""
    if radius is None or n_query * n_target <= BRUTE_PAIR_LIMIT:
        return "brute"
    return "compact"


def nn_1nn(
    query_xyz: jax.Array,
    query_mask: jax.Array,
    target_xyz: jax.Array,
    target_mask: jax.Array,
    radius: Optional[float] = None,
    engine: str = "auto",
) -> Tuple[jax.Array, jax.Array]:
    """Exact 1-NN of every live query against the live target points.

    Returns (idx (N,) int32 target rows or −1, sq_dists (N,)).  With a
    ``radius``, matches farther than it return −1 (and the tiled engines
    use it as their tile size — required for engines 'compact'/'lattice'
    and for auto-dispatch past the brute roofline).
    """
    query_xyz = jnp.asarray(query_xyz)
    target_xyz = jnp.asarray(target_xyz)
    query_mask = jnp.asarray(query_mask)
    target_mask = jnp.asarray(target_mask)
    # the two live counts come back in one host sync
    n_t, n_q = (int(v) for v in jax.device_get(
        (jnp.sum(target_mask), jnp.sum(query_mask))))

    if engine == "auto":
        # dispatch on CAPACITIES (free, static): brute-force cost is
        # padded N×M whatever the masks say — a sparse 1M-capacity cloud
        # dispatched by live counts would run the full padded matrix
        engine = choose_nn_engine(
            query_xyz.shape[0], target_xyz.shape[0], radius)
    if engine in ("compact", "lattice") and radius is None:
        raise ValueError(f"engine='{engine}' needs a search radius")
    if n_t == 0 or n_q == 0:
        n = query_xyz.shape[0]
        return (jnp.full((n,), -1, jnp.int32),
                jnp.full((n,), jnp.inf, jnp.float32))

    if engine == "brute":
        idx, sq = _brute_1nn(query_xyz, query_mask, target_xyz, target_mask)
    else:
        from mapping_private_tpu.ops.tiled_nn import (
            check_lattice_dims, masked_bounds)

        bt = masked_bounds(target_xyz, target_mask)
        bq = masked_bounds(query_xyz, query_mask)
        lo, dims = _lattice_geometry(jax.device_get((bt, bq)), radius)
        check_lattice_dims(dims, radius)
        n_cells = dims[0] * dims[1] * dims[2]
        if engine == "lattice" and n_cells > LATTICE_CELL_LIMIT:
            warnings.warn(
                f"dense lattice of {n_cells} cells exceeds "
                f"LATTICE_CELL_LIMIT ({LATTICE_CELL_LIMIT}); using the compact "
                "occupied-tiles engine instead")
            engine = "compact"
        idx, sq = _tiled_1nn(
            query_xyz, query_mask, target_xyz, target_mask,
            lo, radius, dims, engine)

    if radius is not None:
        out = query_mask & (sq <= np.float32(radius) ** 2)
    else:
        out = query_mask & (idx >= 0)
    return (jnp.where(out, idx, -1).astype(jnp.int32),
            jnp.where(out, sq, jnp.inf))


def _brute_1nn(query_xyz, query_mask, target_xyz, target_mask):
    from mapping_private_tpu.ops import pallas_nn

    if pallas_nn.use_gpu_kernel():
        from mapping_private_tpu.core.cloud import PAD_COORD

        tgt = jnp.where(target_mask[:, None], target_xyz, PAD_COORD)
        qry = jnp.where(query_mask[:, None], query_xyz, -PAD_COORD)
        idx, sq = pallas_nn.nn_argmin_prepared(
            qry, pallas_nn.prepare_nn_ref_argmin(tgt))
        idx = jnp.minimum(idx, target_xyz.shape[0] - 1)
        return idx.astype(jnp.int32), sq
    from mapping_private_tpu.ops.neighbors import knn_bruteforce

    idx, sq = knn_bruteforce(query_xyz, target_xyz, target_mask, k=1)
    return idx[:, 0].astype(jnp.int32), sq[:, 0]


def _tiled_1nn(query_xyz, query_mask, target_xyz, target_mask,
               lo, radius, dims, engine):
    from mapping_private_tpu.ops import tiled_nn

    dims_j = np.asarray(dims, np.int32)
    # dispatch both occupancy programs, then one host sync
    ot = tiled_nn.lattice_occupancy(
        target_xyz, target_mask, lo, radius, dims_j)
    oq = tiled_nn.lattice_occupancy(
        query_xyz, query_mask, lo, radius, dims_j)
    (occ_t, cap_t), (occ_q, cap_q) = (
        (int(a), int(b)) for a, b in jax.device_get((ot, oq)))
    # caps padded to a multiple of 128 (kept from the first build; not
    # re-tuned on an H100); max_tiles MUST cover all target-occupied tiles
    # (target spill is unsafe — see build_compact_tiles), so size it from
    # the larger side's exact occupancy plus margin
    cap_t = max(128, -(-cap_t // 128) * 128)
    cap_q = max(128, -(-cap_q // 128) * 128)
    if engine == "compact":
        mt = 1 << int(np.ceil(np.log2(max(int(1.2 * max(occ_t, occ_q)), 64))))
        tgt = tiled_nn.build_compact_tiles(
            target_xyz, target_mask, lo, radius, dims, cap_t, mt)
        qry = tiled_nn.build_compact_tiles(
            query_xyz, query_mask, lo, radius, dims, cap_q, mt,
            query_only=True)
        return tiled_nn.compact_nn_1nn(tgt, qry)
    tgt = tiled_nn.build_tiles(target_xyz, target_mask, lo, radius, dims, cap_t)
    qry = tiled_nn.build_tiles(query_xyz, query_mask, lo, radius, dims, cap_q)
    return tiled_nn.tiled_nn_1nn(tgt, qry, query_xyz)

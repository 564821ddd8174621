"""GFPFH — global feature over voxel-class line crossings.

Replaces the deprecated reference implementation
(cloud_algos/deprecated/gfpfh.cpp:355-430): pairs of classified voxels are
connected by a line; the sequence of voxel class labels the line crosses
(sorted by distance, EMPTY for unoccupied cells) is histogrammed into a
global descriptor.

Array formulation: P random occupied-voxel pairs at once; S equally-spaced
samples along every line are gathered from the class grid in one indexed
read; the descriptor accumulates, for each (start class, end class) pair,
the histogram of crossed classes — a (C, C, C+1) tensor flattened to
C²·(C+1) bins (150 for the 5 RSD surface classes), built with one
scatter-add.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from mapping_private_tpu.features.rsd import EMPTY

NUM_CLASSES = 5


def gfpfh_global(
    type_grid: jax.Array,
    occ: jax.Array,
    key: jax.Array,
    num_pairs: int = 2048,
    samples_per_line: int = 16,
) -> jax.Array:
    """(C²·(C+1),) global descriptor from a (X,Y,Z) class grid + occupancy."""
    X, Y, Z = occ.shape
    n = X * Y * Z
    occ_f = occ.reshape(-1).astype(jnp.float32)
    # sample occupied voxel indices via inverse-CDF over the occupancy mask
    cdf = jnp.cumsum(occ_f)
    total = jnp.maximum(cdf[-1], 1.0)
    ka, kb = jax.random.split(key)
    ua = jax.random.uniform(ka, (num_pairs,)) * total
    ub = jax.random.uniform(kb, (num_pairs,)) * total
    ia = jnp.clip(jnp.searchsorted(cdf, ua, side="right"), 0, n - 1)
    ib = jnp.clip(jnp.searchsorted(cdf, ub, side="right"), 0, n - 1)

    def coords(i):
        return jnp.stack([i // (Y * Z), (i // Z) % Y, i % Z], -1).astype(jnp.float32)

    a = coords(ia)  # (P,3)
    b = coords(ib)
    t = jnp.linspace(0.0, 1.0, samples_per_line)[None, :, None]  # (1,S,1)
    pts = a[:, None, :] * (1 - t) + b[:, None, :] * t  # (P,S,3)
    ijk = jnp.round(pts).astype(jnp.int32)
    ii = jnp.clip(ijk[..., 0], 0, X - 1)
    jj = jnp.clip(ijk[..., 1], 0, Y - 1)
    kk = jnp.clip(ijk[..., 2], 0, Z - 1)
    cls = jnp.where(occ[ii, jj, kk], type_grid[ii, jj, kk], EMPTY)  # (P,S)

    C = NUM_CLASSES
    start = type_grid.reshape(-1)[ia]  # (P,)
    end = type_grid.reshape(-1)[ib]
    valid_pair = occ.reshape(-1)[ia] & occ.reshape(-1)[ib]
    # bin = ((start*C + end)*(C+1) + crossed_class), one scatter-add
    base = (start * C + end) * (C + 1)  # (P,)
    bins = base[:, None] + cls  # (P,S)
    w = valid_pair.astype(jnp.float32)[:, None] * jnp.ones_like(cls, jnp.float32)
    hist = jnp.zeros((C * C * (C + 1),), jnp.float32).at[bins.reshape(-1)].add(
        w.reshape(-1)
    )
    return hist / jnp.maximum(jnp.sum(hist), 1.0)

"""Region growing — gated flood-fill as masked label propagation.

Replaces `RegionGrowing` (reference cloud_algos/src/region_growing.cpp:48-120):
the BFS queue (`GrowFromPoint`) that expands a cluster via `radiusSearch`,
optionally gated on (a) a channel value equality (`setExtraDimensionIgnore`,
:42-43) and (b) pluggable grow-from / grow-into predicates (`behaviour_`).

Here the BFS becomes connected components over the radius graph restricted
to *growable* points, with two refinements matching the reference semantics:

- ``grow_mask``: only these points may join a region (grow_into gate +
  channel gate folded in).
- ``seed_mask``: only components containing at least one seed survive
  (grow_from gate) — others are returned as label N (unclustered).
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from mapping_private_tpu.ops.cluster import radius_graph, propagate_labels


def region_grow(
    xyz: jax.Array,
    mask: jax.Array,
    radius: float,
    grow_mask: Optional[jax.Array] = None,
    seed_mask: Optional[jax.Array] = None,
    k: int = 16,
    use_grid: bool = False,
    normals: Optional[jax.Array] = None,
    angle_threshold: Optional[float] = None,
) -> jax.Array:
    """Cluster labels (N,) int32; label = min point index of the region,
    N for dead / non-growable / seedless regions.

    Args:
      grow_mask: points eligible to be grown *into* (default: all live).
      seed_mask: points eligible to *start* a region; a region with no
        seed is discarded (default: all growable points are seeds).
    """
    n = xyz.shape[0]
    growable = mask if grow_mask is None else (mask & grow_mask)
    idx, valid = radius_graph(
        xyz, growable, radius, k=k, use_grid=use_grid,
        normals=normals, angle_threshold=angle_threshold,
    )
    init = jnp.arange(n, dtype=jnp.int32)
    labels = propagate_labels(init, idx, valid, growable)
    if seed_mask is not None:
        seeds = growable & seed_mask
        # a region survives iff any member is a seed: scatter-or by label
        has_seed = (
            jnp.zeros((n + 1,), jnp.bool_)
            .at[jnp.where(growable, labels, n)]
            .max(seeds)
        )
        labels = jnp.where(
            growable & has_seed[jnp.clip(labels, 0, n)], labels, n
        )
    return labels

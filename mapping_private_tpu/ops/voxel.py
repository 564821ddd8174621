"""Voxel-grid downsampling — sort-based segment means per occupied cell.

Array replacement for `cloud_geometry::downsamplePointCloud` (used at
table_object_detector_passive.cpp:372) and `pcl::VoxelGrid`.  Points sort
by a packed cell key; runs of equal keys become output slots (cumsum of
run-start flags); coordinates and channels scatter-add into the
fixed-capacity output.  Everything static-shape and jit-compatible.

Perf note: coordinates/channels ride THROUGH the sort as extra
`lax.sort` operands instead of being gathered by `argsort` indices
afterwards: two 1M-row random gathers would cost more memory traffic
than widening the sort.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from mapping_private_tpu.core.cloud import PAD_COORD, PointCloud
from mapping_private_tpu.ops.neighbors import _cell_key, _KEY_SENTINEL


def voxel_downsample(
    cloud: PointCloud,
    voxel_size: float,
    out_capacity: int,
) -> PointCloud:
    """Downsample to per-voxel centroids.

    Args:
      cloud: input PointCloud (capacity N).
      voxel_size: cell edge length.
      out_capacity: static capacity of the result; occupied voxels beyond
        this many are dropped (choose generously; count is data-dependent).

    Returns:
      PointCloud of voxel centroids with channel means carried over.
    """
    xyz = cloud.xyz
    cs = jnp.asarray(voxel_size, jnp.float32)
    cell = jnp.floor(xyz / cs).astype(jnp.int32)
    keys = jnp.where(cloud.mask, _cell_key(cell), _KEY_SENTINEL)

    # flatten channels into extra sort operands (carried through the sort)
    chan_names = list(cloud.channels)
    chan_cols = []  # (name, num_cols)
    operands = [keys, xyz[:, 0], xyz[:, 1], xyz[:, 2]]
    for name in chan_names:
        v = cloud.channels[name]
        if v.ndim == 1:
            operands.append(v)
            chan_cols.append((name, 1))
        else:
            for c in range(v.shape[1]):
                operands.append(v[:, c])
            chan_cols.append((name, v.shape[1]))

    sorted_ops = jax.lax.sort(operands, num_keys=1)
    skeys = sorted_ops[0]
    live = skeys != _KEY_SENTINEL

    # Run-start flags → output slot per sorted point.
    first = jnp.concatenate(
        [jnp.ones((1,), bool), skeys[1:] != skeys[:-1]]
    ) & live
    slot = jnp.cumsum(first.astype(jnp.int32)) - 1  # (N,) slot per point
    slot = jnp.where(live & (slot < out_capacity), slot, out_capacity)  # spill

    def seg_sum(cols) -> jax.Array:
        v2 = jnp.stack(cols, axis=-1)  # (N, C)
        return jnp.zeros((out_capacity + 1, v2.shape[1]), v2.dtype).at[slot].add(
            jnp.where(live[:, None], v2, 0)
        )[:out_capacity]

    cnt = (
        jnp.zeros((out_capacity + 1,), jnp.int32)
        .at[slot]
        .add(live.astype(jnp.int32))[:out_capacity]
    )
    denom = jnp.maximum(cnt, 1).astype(jnp.float32)[:, None]
    out_xyz = seg_sum(sorted_ops[1:4]) / denom
    out_mask = cnt > 0
    out_xyz = jnp.where(out_mask[:, None], out_xyz, PAD_COORD)

    out_channels = {}
    col = 4
    for name, ncols in chan_cols:
        m = seg_sum(sorted_ops[col : col + ncols]) / denom
        col += ncols
        out_channels[name] = m[:, 0] if ncols == 1 else m
    out_channels["vox_count"] = cnt.astype(jnp.float32)
    return PointCloud(xyz=out_xyz, mask=out_mask, channels=out_channels)


def voxel_downsample_dense(
    cloud: PointCloud,
    voxel_size: float,
    origin,
    dims: Tuple[int, int, int],
    out_capacity: int,
) -> PointCloud:
    """Sort-free voxel downsample for BOUNDED scenes.

    The sort-based path above is bitonic-sort-bound (28 ms at 1M points);
    when the scene bounds are known statically this variant scatter-adds
    sums/counts into a dense (dx·dy·dz) cell array and compacts occupied
    cells with a cumsum — O(N) scatters + O(D) compaction, no sort.
    Output rows are ordered by linear cell index; cells beyond
    ``out_capacity`` spill (same contract as voxel_downsample).
    """
    dx, dy, dz = dims
    D = dx * dy * dz
    o = jnp.asarray(origin, jnp.float32)
    rel = (cloud.xyz - o) / jnp.asarray(voxel_size, jnp.float32)
    idx = jnp.floor(rel).astype(jnp.int32)
    in_range = (
        cloud.mask
        & jnp.all(idx >= 0, axis=-1)
        & (idx[:, 0] < dx) & (idx[:, 1] < dy) & (idx[:, 2] < dz)
    )
    lin = idx[:, 0] * (dy * dz) + idx[:, 1] * dz + idx[:, 2]
    lin = jnp.where(in_range, lin, D)

    chan_names = list(cloud.channels)
    cols = [cloud.xyz[:, 0], cloud.xyz[:, 1], cloud.xyz[:, 2]]
    chan_cols = []
    for name in chan_names:
        v = cloud.channels[name]
        if v.ndim == 1:
            cols.append(v)
            chan_cols.append((name, 1))
        else:
            cols.extend(v[:, c] for c in range(v.shape[1]))
            chan_cols.append((name, v.shape[1]))
    vals = jnp.stack(cols, axis=-1)  # (N, 3+C)
    sums = jnp.zeros((D + 1, vals.shape[1]), jnp.float32).at[lin].add(
        jnp.where(in_range[:, None], vals, 0.0))
    cnt = jnp.zeros((D + 1,), jnp.int32).at[lin].add(
        in_range.astype(jnp.int32))
    occ = cnt[:D] > 0
    slot = jnp.cumsum(occ.astype(jnp.int32)) - 1
    slot = jnp.where(occ & (slot < out_capacity), slot, out_capacity)
    out_sums = jnp.zeros((out_capacity + 1, vals.shape[1]), jnp.float32
                         ).at[slot].set(sums[:D])[:out_capacity]
    out_cnt = jnp.zeros((out_capacity + 1,), jnp.int32
                        ).at[slot].set(cnt[:D])[:out_capacity]
    mask = out_cnt > 0
    denom = jnp.maximum(out_cnt, 1).astype(jnp.float32)[:, None]
    mean = out_sums / denom
    xyz = jnp.where(mask[:, None], mean[:, :3], PAD_COORD)
    channels = {}
    c0 = 3
    for name, c in chan_cols:
        block = mean[:, c0:c0 + c]
        channels[name] = block[:, 0] if c == 1 else block
        c0 += c
    return PointCloud(xyz=xyz, mask=mask, channels=channels)

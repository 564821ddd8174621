"""VoxelGrid — dense fixed-shape voxelization of a PointCloud.

JAX-native replacement for `pcl::VoxelGrid` as used by the reference's
C3-HLAC extractor (c3_hlac/include/c3_hlac/c3_hlac.h:102 `setVoxelFilter`)
and sliding-box search (color_voxel_recognition/src/search.cpp).  The grid
has *static* dims so everything downstream (integral tables, neighbor
correlations) compiles once; out-of-range points are dropped by scatter
clipping into a spill cell.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import jax
import jax.numpy as jnp

from mapping_private_tpu.core.cloud import PointCloud


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class VoxelGrid:
    """Dense voxel grid.

    Attributes:
      origin: (3,) grid origin in world coordinates.
      voxel_size: scalar edge length.
      count: (Dx, Dy, Dz) int32 points-per-voxel.
      sums:  dict of per-voxel channel accumulators, each (Dx, Dy, Dz) or
             (Dx, Dy, Dz, C); divide by count for means.
    """

    origin: jax.Array
    voxel_size: jax.Array
    count: jax.Array
    sums: Dict[str, jax.Array] = dataclasses.field(default_factory=dict)

    @property
    def dims(self) -> Tuple[int, int, int]:
        return self.count.shape  # type: ignore[return-value]

    def occupancy(self) -> jax.Array:
        return self.count > 0

    def mean(self, name: str) -> jax.Array:
        c = jnp.maximum(self.count, 1).astype(jnp.float32)
        s = self.sums[name]
        if s.ndim == 4:
            c = c[..., None]
        return s / c


def voxelize(
    cloud: PointCloud,
    voxel_size: float,
    origin: jax.Array,
    dims: Tuple[int, int, int],
    channels: Tuple[str, ...] = (),
) -> VoxelGrid:
    """Scatter points into a dense grid with static ``dims``.

    Points outside [origin, origin + dims*voxel_size) and padded rows are
    routed to a spill voxel that is sliced off before returning, so the
    result only contains in-range mass.
    """
    dx, dy, dz = dims
    rel = (cloud.xyz - origin) / voxel_size
    idx = jnp.floor(rel).astype(jnp.int32)
    in_range = (
        cloud.mask
        & jnp.all(idx >= 0, axis=-1)
        & (idx[:, 0] < dx)
        & (idx[:, 1] < dy)
        & (idx[:, 2] < dz)
    )
    # Linearize; dead/out-of-range points go to the spill slot (last index).
    lin = idx[:, 0] * (dy * dz) + idx[:, 1] * dz + idx[:, 2]
    spill = dx * dy * dz
    lin = jnp.where(in_range, lin, spill)

    ones = in_range.astype(jnp.int32)
    count = (
        jnp.zeros((spill + 1,), jnp.int32).at[lin].add(ones)[:spill].reshape(dims)
    )
    sums = {}
    for name in channels:
        v = cloud.channels[name]
        v2 = v[:, None] if v.ndim == 1 else v
        c = v2.shape[1]
        acc = (
            jnp.zeros((spill + 1, c), v2.dtype)
            .at[lin]
            .add(jnp.where(in_range[:, None], v2, 0))[:spill]
        )
        sums[name] = acc.reshape(dims + (c,)) if v.ndim > 1 else acc.reshape(dims)
    return VoxelGrid(
        origin=jnp.asarray(origin, jnp.float32),
        voxel_size=jnp.asarray(voxel_size, jnp.float32),
        count=count,
        sums=sums,
    )

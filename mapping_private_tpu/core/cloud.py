"""PointCloud — the dense struct-of-arrays cloud type.

Replaces the reference's `sensor_msgs::PointCloud` (xyz + named float
channels, looked up with `getChannelIndex`, cf. reference
cloud_algos/include/cloud_algos/cloud_algos.h:14-19) with a fixed-capacity,
mask-padded pytree designed for XLA:

- static shapes: every cloud has capacity ``N`` (a compile-time constant);
  ``mask`` marks which rows are live.  Padded rows carry coordinates at
  ``PAD_COORD`` so they fall outside any realistic bounding box and never
  win a nearest-neighbor query.
- named channels live in a dict of (N,) or (N, C) arrays, preserving the
  reference's name→column semantics without pointer-chasing.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

# Sentinel coordinate for padded points: far away from any real scene so that
# padded rows lose every distance comparison without special-casing.
PAD_COORD = 1.0e8


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PointCloud:
    """Fixed-capacity point cloud.

    Attributes:
      xyz:   (N, 3) float32 positions; padded rows hold PAD_COORD.
      mask:  (N,)  bool, True for live points.
      channels: dict of named per-point arrays, each (N,) or (N, C).
    """

    xyz: jax.Array
    mask: jax.Array
    channels: Dict[str, jax.Array] = dataclasses.field(default_factory=dict)

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    def count(self) -> jax.Array:
        """Number of live points (traced value)."""
        return jnp.sum(self.mask.astype(jnp.int32))

    def has_channel(self, name: str) -> bool:
        return name in self.channels

    def channel(self, name: str) -> jax.Array:
        return self.channels[name]

    def with_channel(self, name: str, value: jax.Array) -> "PointCloud":
        ch = dict(self.channels)
        ch[name] = value
        return dataclasses.replace(self, channels=ch)

    def with_xyz(self, xyz: jax.Array) -> "PointCloud":
        return dataclasses.replace(self, xyz=xyz)

    def normals(self) -> Optional[jax.Array]:
        """(N,3) normals if nx/ny/nz channels are present (reference keeps
        normals as three scalar channels; we expose both conventions)."""
        if "normal" in self.channels:
            return self.channels["normal"]
        if all(k in self.channels for k in ("nx", "ny", "nz")):
            return jnp.stack(
                [self.channels["nx"], self.channels["ny"], self.channels["nz"]],
                axis=-1,
            )
        return None

    def rgb(self) -> Optional[jax.Array]:
        """(N,3) float colors in [0,255] if present."""
        if "rgb" in self.channels:
            return self.channels["rgb"]
        if all(k in self.channels for k in ("r", "g", "b")):
            return jnp.stack(
                [self.channels["r"], self.channels["g"], self.channels["b"]],
                axis=-1,
            )
        return None

    def select(self, keep: jax.Array) -> "PointCloud":
        """Mask-and: restrict live set to ``keep`` (no compaction; shapes
        stay static).  keep: (N,) bool."""
        return dataclasses.replace(self, mask=self.mask & keep)

    def padded_xyz(self) -> jax.Array:
        """xyz with dead rows pushed to the sentinel (idempotent)."""
        return jnp.where(self.mask[:, None], self.xyz, PAD_COORD)

    @staticmethod
    def from_numpy(
        xyz: np.ndarray,
        channels: Optional[Dict[str, np.ndarray]] = None,
        capacity: Optional[int] = None,
    ) -> "PointCloud":
        """Build a PointCloud from host arrays, padding up to ``capacity``.

        capacity defaults to the next multiple of 128 of len(xyz)
        (kept from the first build; unmeasured on an H100).
        """
        n = xyz.shape[0]
        if capacity is None:
            capacity = max(128, -(-n // 128) * 128)
        if capacity < n:
            raise ValueError(f"capacity {capacity} < point count {n}")
        pad = capacity - n
        xyz_f = np.asarray(xyz, dtype=np.float32)
        xyz_p = np.concatenate(
            [xyz_f, np.full((pad, 3), PAD_COORD, dtype=np.float32)], axis=0
        )
        mask = np.zeros((capacity,), dtype=bool)
        mask[:n] = True
        chans = {}
        for k, v in (channels or {}).items():
            v = np.asarray(v, dtype=np.float32)
            pad_shape = (pad,) + v.shape[1:]
            chans[k] = jnp.asarray(
                np.concatenate([v, np.zeros(pad_shape, dtype=np.float32)], axis=0)
            )
        return PointCloud(xyz=jnp.asarray(xyz_p), mask=jnp.asarray(mask), channels=chans)

    def to_numpy(self) -> Dict[str, np.ndarray]:
        """Return host copies of live rows only (for I/O and tests)."""
        mask = np.asarray(self.mask)
        out = {"xyz": np.asarray(self.xyz)[mask]}
        for k, v in self.channels.items():
            out[k] = np.asarray(v)[mask]
        return out

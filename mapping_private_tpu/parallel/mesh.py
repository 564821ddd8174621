"""Device-mesh helpers.

The reference has no device parallelism to mirror (ROS nodes on one
machine; SURVEY §2.6) — this is the new scaling dimension: scan batches
shard over ``dp`` (data parallel), points within a scan shard over ``sp``
(spatial/sequence parallel), and voxel-map blocks shard over ``dp×sp``
jointly.  XLA inserts the psum/all_gather collectives; on GPUs they run
over NVLink through NCCL.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(
    axis_sizes: Optional[Tuple[int, int]] = None,
    axis_names: Sequence[str] = ("dp", "sp"),
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a (dp, sp) mesh over available devices.

    Without explicit sizes, uses all devices on ``dp`` and 1 on ``sp``.
    """
    devs = list(devices if devices is not None else jax.devices())
    if axis_sizes is None:
        axis_sizes = (len(devs),) + (1,) * (len(axis_names) - 1)
    if len(axis_sizes) != len(axis_names):
        raise ValueError(f"{len(axis_sizes)} sizes for {axis_names}")
    total = int(np.prod(axis_sizes))
    if total > len(devs):
        raise ValueError(f"mesh {axis_sizes} needs {total} devices, have {len(devs)}")
    grid = np.array(devs[:total]).reshape(axis_sizes)
    return Mesh(grid, tuple(axis_names))

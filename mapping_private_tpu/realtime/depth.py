"""Depth-image operations — `depth_image_smoothing` + the CUDA filter path.

- Disparity-domain smoothing replaces depth_image_smoothing/src/
  depth_image_smoothing.cpp: `computeClampingImages` (:45-110) builds
  per-pixel min/max disparity bounds from the valid 3×3 neighborhood, then
  the depth image is iteratively box-smoothed in disparity space with each
  result clamped back into its bounds — smoothing quantization steps
  without bleeding across depth discontinuities.

- `depth_to_cloud` replaces the disparity→cloud unprojection of
  pcl::cuda::DisparityToCloud used by realtime_segmentation.cpp.

- `background_subtract` replaces the thrust `BackgroundSubtractionKernel`
  (realtime_perception/src/urdf_filtering.cu:30-47): compare the measured
  Kinect depth against the rendered robot depth; pixels closer than the
  rendered robot (within a threshold) are robot self-observations and are
  cut from the cloud.

All ops are whole-image jittable array programs (the reference needed CUDA
for per-pixel parallelism; here these are plain elementwise work).
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp


def depth_to_disparity(depth_m: jax.Array, baseline_focal: float = 0.075 * 580.0) -> jax.Array:
    """disparity = B·f / z; invalid (z≤0) → 0."""
    valid = depth_m > 0
    return jnp.where(valid, baseline_focal / jnp.maximum(depth_m, 1e-6), 0.0)


def disparity_to_depth(disp: jax.Array, baseline_focal: float = 0.075 * 580.0) -> jax.Array:
    valid = disp > 0
    return jnp.where(valid, baseline_focal / jnp.maximum(disp, 1e-6), 0.0)


def _shift2d(x: jax.Array, dy: int, dx: int, fill: float) -> jax.Array:
    out = jnp.roll(x, (-dy, -dx), axis=(0, 1))
    if dy > 0:
        out = out.at[-dy:, :].set(fill)
    elif dy < 0:
        out = out.at[:-dy, :].set(fill)
    if dx > 0:
        out = out.at[:, -dx:].set(fill)
    elif dx < 0:
        out = out.at[:, :-dx].set(fill)
    return out


def smooth_depth_image(
    depth_m: jax.Array,
    iterations: int = 5,
    disparity_tolerance: float = 1.0,
    baseline_focal: float = 0.075 * 580.0,
) -> jax.Array:
    """Clamped depth smoothing, exactly the reference's scheme
    (computeClampingImages :45-110 + bilateralSmoothing :84-118):

    per-pixel bounds = its OWN disparity ± disp_thresh converted back to
    depth; each iteration Gaussian-blurs the depth and clamps every pixel
    into its interval — smoothing sensor quantization steps while bounding
    drift (a depth edge cannot bleed because each side is pinned to its
    own measurement).  The blur is validity-weighted (the reference's TODO
    at :85 about zeros polluting the blur, fixed here).  depth_m: (H, W)
    metres, 0 = invalid."""
    valid = depth_m > 0
    disp = depth_to_disparity(depth_m, baseline_focal)
    lo = disparity_to_depth(disp + disparity_tolerance, baseline_focal)
    hi = disparity_to_depth(
        jnp.maximum(disp - disparity_tolerance, 1e-3), baseline_focal
    )

    # 3×3 binomial kernel (iterated ≈ the reference's sigma-2 Gaussian)
    kern = jnp.asarray([1.0, 2.0, 1.0])
    wts = kern[:, None] * kern[None, :]

    def body(d, _):
        s = jnp.zeros_like(d)
        w = jnp.zeros_like(d)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                k = wts[dy + 1, dx + 1]
                s = s + k * _shift2d(jnp.where(valid, d, 0.0), dy, dx, 0.0)
                w = w + k * _shift2d(valid.astype(d.dtype), dy, dx, 0.0)
        avg = s / jnp.maximum(w, 1e-6)
        out = jnp.clip(avg, lo, hi)
        return jnp.where(valid, out, d), None

    d, _ = jax.lax.scan(body, depth_m, None, length=iterations)
    return jnp.where(valid, d, 0.0)


def depth_to_cloud(
    depth_m: jax.Array,
    fx: float = 580.0,
    fy: float = 580.0,
    cx: Optional[float] = None,
    cy: Optional[float] = None,
) -> Tuple[jax.Array, jax.Array]:
    """(H, W) metric depth → ((H, W, 3) camera-frame points, (H, W) valid)."""
    h, w = depth_m.shape
    cx = (w - 1) / 2.0 if cx is None else cx
    cy = (h - 1) / 2.0 if cy is None else cy
    v, u = jnp.meshgrid(jnp.arange(h, dtype=depth_m.dtype),
                        jnp.arange(w, dtype=depth_m.dtype), indexing="ij")
    z = depth_m
    x = (u - cx) / fx * z
    y = (v - cy) / fy * z
    valid = z > 0
    return jnp.stack([x, y, z], axis=-1), valid


def background_subtract(
    measured_depth_m: jax.Array,
    rendered_depth_m: jax.Array,
    threshold: float = 0.05,
) -> jax.Array:
    """Robot self-filter mask (BackgroundSubtractionKernel semantics):

    True = keep the pixel (scene), False = cut it (robot).  A pixel is cut
    when the rendered robot occupies it and the measured depth is within
    ``threshold`` of (or in front of) the rendered robot surface; invalid
    measurements (0, the kernel's `return 98` branch) are kept as invalid
    but not classified as robot."""
    robot = rendered_depth_m > 0
    meas_ok = measured_depth_m > 0
    near_robot = robot & meas_ok & (
        measured_depth_m < rendered_depth_m + threshold
    )
    return ~near_robot

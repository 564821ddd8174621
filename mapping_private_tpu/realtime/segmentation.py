"""Real-time organized-cloud segmentation — `realtime_segmentation` JAX-native.

Replaces the pcl::cuda pipeline in realtime_segmentation/src/
realtime_segmentation.cpp:73-300:

- `fast_normals_image` ← computeFastPointNormals (direct pixel-neighbor
  cross products, :230-231).
- `multi_plane_ransac` ← SampleConsensusModel1PointPlane +
  MultiRandomSampleConsensus (:265-295): a hypothesis is ONE point with
  its normal (plane through the point, oriented by the normal); 1024
  hypotheses per batch, planes accepted best-first until min_coverage of
  the points is explained.
- `connected_components_image` ← the GPU connected-components pass.
- `mean_shift_normals` / `segment_normal_image` ← OpenCV GPU
  meanShiftSegmentation on the normal image (:259).

Everything is dense image-lattice work.
"""
from __future__ import annotations

from functools import partial
from typing import List, Tuple

import jax
import jax.numpy as jnp

from mapping_private_tpu.fit.ransac import sample_live_indices


def fast_normals_image(points: jax.Array, valid: jax.Array) -> jax.Array:
    """Cross-product normals from pixel neighbors.

    points: (H, W, 3) organized cloud; valid: (H, W).
    Returns (H, W, 3) unit normals (0 where undefined), oriented toward
    the camera (−z half-space), matching computeFastPointNormals.
    """
    dx = jnp.roll(points, -1, axis=1) - jnp.roll(points, 1, axis=1)
    dy = jnp.roll(points, -1, axis=0) - jnp.roll(points, 1, axis=0)
    n = jnp.cross(dx, dy)
    ln = jnp.linalg.norm(n, axis=-1, keepdims=True)
    vx = valid & jnp.roll(valid, -1, 1) & jnp.roll(valid, 1, 1)
    vy = valid & jnp.roll(valid, -1, 0) & jnp.roll(valid, 1, 0)
    ok = (vx & vy & (ln[..., 0] > 1e-12))
    n = jnp.where(ok[..., None], n / jnp.maximum(ln, 1e-30), 0.0)
    # orient toward the camera (points have z > 0 in front of the camera)
    flip = jnp.where(n[..., 2:3] > 0, -1.0, 1.0)
    return n * flip


@partial(jax.jit, static_argnames=("num_hypotheses", "max_planes"))
def multi_plane_ransac(
    xyz: jax.Array,
    normals: jax.Array,
    mask: jax.Array,
    key: jax.Array,
    num_hypotheses: int = 1024,
    max_planes: int = 6,
    threshold: float = 0.05,
    min_coverage: float = 0.9,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Sequential multi-plane extraction with 1-point-plane hypotheses.

    Args:
      xyz: (N, 3) flattened points; normals: (N, 3); mask: (N,) live.

    Returns:
      planes: (max_planes, 4) [n, d] (zeros for unused slots).
      labels: (N,) int32 plane id per point (−1 = unexplained).
      num_planes: () int32.
    """
    n_pts = xyz.shape[0]
    total = jnp.maximum(jnp.sum(mask.astype(jnp.float32)), 1.0)

    def round_fn(carry, _):
        live, labels, planes, count, done = carry
        k = jax.random.fold_in(key, count)
        idx = sample_live_indices(k, live, (num_hypotheses,))
        p0 = xyz[idx]
        nh = normals[idx]  # (H,3) hypothesis normals
        d = -jnp.sum(nh * p0, axis=-1)  # (H,)
        dist = jnp.abs(xyz @ nh.T + d[None, :])  # (N,H)
        inl = (dist < threshold) & live[:, None]
        scores = jnp.sum(inl.astype(jnp.float32), axis=0)
        # degenerate hypotheses (zero normal) score 0
        scores = jnp.where(jnp.linalg.norm(nh, axis=-1) > 1e-6, scores, 0.0)
        best = jnp.argmax(scores)
        best_inl = inl[:, best]
        n_in = scores[best]
        good = (n_in > 0) & ~done
        labels = jnp.where(good & best_inl, count, labels)
        planes = planes.at[count].set(
            jnp.where(good, jnp.concatenate([nh[best], d[best][None]]), 0.0)
        )
        live = live & ~(best_inl & good)
        count = count + jnp.where(good, 1, 0)
        explained = 1.0 - jnp.sum(live.astype(jnp.float32)) / total
        done = done | (explained >= min_coverage) | ~good
        return (live, labels, planes, count, done), None

    labels0 = jnp.full((n_pts,), -1, jnp.int32)
    planes0 = jnp.zeros((max_planes, 4), jnp.float32)
    (live, labels, planes, count, _), _ = jax.lax.scan(
        round_fn, (mask, labels0, planes0, 0, jnp.bool_(False)), None,
        length=max_planes,
    )
    return planes, labels, count


def connected_components_image(
    adjacency_ok: jax.Array, valid: jax.Array, max_iters: int = 256
) -> jax.Array:
    """4-neighbor connected components on an image lattice.

    adjacency_ok: (H, W, 4) bool — whether the pixel connects to its
    (up, down, left, right) neighbor.  Returns (H, W) int32 component
    labels (= flat index of the component minimum; H*W for invalid).
    """
    h, w = valid.shape
    dead = jnp.int32(h * w)
    init = jnp.arange(h * w, dtype=jnp.int32).reshape(h, w)
    labels0 = jnp.where(valid, init, dead)

    shifts = ((-1, 0), (1, 0), (0, -1), (0, 1))

    def body(state):
        labels, _, it = state
        new = labels
        for a, (dy, dx) in enumerate(shifts):
            nb = jnp.roll(labels, (-dy, -dx), axis=(0, 1))
            # mask off wrap-around rows/cols
            if dy == -1:
                nb = nb.at[0, :].set(dead)
            elif dy == 1:
                nb = nb.at[-1, :].set(dead)
            if dx == -1:
                nb = nb.at[:, 0].set(dead)
            elif dx == 1:
                nb = nb.at[:, -1].set(dead)
            nb = jnp.where(adjacency_ok[..., a] & valid, nb, dead)
            new = jnp.minimum(new, nb)
        new = jnp.where(valid, new, dead)
        return new, jnp.any(new != labels), it + 1

    def cond(state):
        _, changed, it = state
        return changed & (it < max_iters)

    labels, _, _ = jax.lax.while_loop(
        cond, body, (labels0, jnp.bool_(True), 0)
    )
    return labels


def mean_shift_normals(
    normal_img: jax.Array,
    valid: jax.Array,
    range_bandwidth: float = 0.3,
    window: int = 2,
    iterations: int = 5,
) -> jax.Array:
    """Mean-shift filtering of a normal image (the meanShiftSegmentation
    front half): each pixel's normal moves to the mean of spatial-window
    neighbors whose normals lie within the range bandwidth."""
    def body(n, _):
        acc = jnp.zeros_like(n)
        wsum = jnp.zeros(n.shape[:2], n.dtype)
        for dy in range(-window, window + 1):
            for dx in range(-window, window + 1):
                nb = jnp.roll(n, (-dy, -dx), axis=(0, 1))
                vb = jnp.roll(valid, (-dy, -dx), axis=(0, 1))
                d2 = jnp.sum((nb - n) ** 2, axis=-1)
                w = (
                    (d2 < range_bandwidth * range_bandwidth) & vb & valid
                ).astype(n.dtype)
                acc = acc + nb * w[..., None]
                wsum = wsum + w
        out = acc / jnp.maximum(wsum, 1.0)[..., None]
        ln = jnp.linalg.norm(out, axis=-1, keepdims=True)
        out = jnp.where((ln[..., 0] > 1e-9)[..., None], out / jnp.maximum(ln, 1e-30), n)
        return out, None

    n, _ = jax.lax.scan(body, normal_img, None, length=iterations)
    return n


def segment_normal_image(
    normal_img: jax.Array,
    valid: jax.Array,
    range_bandwidth: float = 0.3,
    min_size: int = 30,
) -> jax.Array:
    """Full mean-shift segmentation (meanShiftSegmentation, :259): filter
    normals, then connected components over "normals agree" adjacency;
    components smaller than min_size are dissolved to label H*W."""
    n = mean_shift_normals(normal_img, valid, range_bandwidth)
    shifts = ((-1, 0), (1, 0), (0, -1), (0, 1))
    adj = []
    for dy, dx in shifts:
        nb = jnp.roll(n, (-dy, -dx), axis=(0, 1))
        vb = jnp.roll(valid, (-dy, -dx), axis=(0, 1))
        d2 = jnp.sum((nb - n) ** 2, axis=-1)
        adj.append((d2 < range_bandwidth * range_bandwidth) & vb)
    labels = connected_components_image(jnp.stack(adj, axis=-1), valid)
    h, w = valid.shape
    sizes = jnp.zeros((h * w + 1,), jnp.int32).at[labels.reshape(-1)].add(
        valid.reshape(-1).astype(jnp.int32)
    )
    big = sizes[jnp.clip(labels, 0, h * w)] >= min_size
    return jnp.where(valid & big, labels, h * w)

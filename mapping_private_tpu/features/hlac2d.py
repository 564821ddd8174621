"""2-D image HLAC features — the `hlac` package, JAX-native.

Replaces the 6.7k-line hand-unrolled mask loops of
hlac/include/hlac/HLAC.hpp with shift-and-multiply tensor reductions: each
HLAC bin is Σ over pixels of a product of shifted copies of the image, so
the whole feature vector is a stack of fused elementwise products + sums.

Mask pattern tables below are the reference's exact bin orders, read off
the unrolled accumulators (HLAC.hpp: _extractBin1_3 :227-241,
_extractBin2_3 :254-305, _extractGray1_3, _extractGray2_3 :2456+,
_extractColor1_3 :5414+).  Position index k ∈ 0..8 maps to the pixel
offset (rx·(k mod 3 − 1), ry·(k div 3 − 1)); color index = 9·channel + k.

Binary HLAC gates each pixel's contribution on the CENTER being set
(HLAC.hpp:266 `if (img.at<uchar>(i,j))`); gray/color HLAC instead carry
the center value inside each product — both reproduced exactly.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import jax
import jax.numpy as jnp

# bin order tables (see module docstring for provenance)
BIN1_3 = [(4,), (0,), (1,), (2,), (3,)]
BIN2_3 = [
    (4,), (0,), (1,), (2,), (3,),
    (0, 1), (0, 2), (0, 3), (0, 5), (0, 6), (0, 7), (0, 8),
    (1, 2), (1, 3), (1, 6), (1, 7), (1, 8),
    (2, 3), (2, 6), (2, 7), (2, 8),
    (3, 5), (3, 8), (5, 6), (6, 8),
]
GRAY1_3 = [(4,), (4, 0), (4, 1), (4, 2), (4, 3), (4, 4)]
GRAY2_3 = [
    (4,), (4, 0), (4, 1), (4, 2), (4, 3), (4, 4),
    (4, 0, 0), (4, 0, 1), (4, 0, 2), (4, 0, 3), (4, 0, 4), (4, 0, 5),
    (4, 0, 6), (4, 0, 7), (4, 0, 8),
    (4, 1, 1), (4, 1, 2), (4, 1, 3), (4, 1, 4), (4, 1, 6), (4, 1, 7), (4, 1, 8),
    (4, 2, 2), (4, 2, 3), (4, 2, 4), (4, 2, 6), (4, 2, 7), (4, 2, 8),
    (4, 3, 3), (4, 3, 4), (4, 3, 5), (4, 3, 8),
    (4, 4, 4), (4, 5, 6), (4, 6, 8),
]
COLOR1_3 = [
    (4,), (13,), (22,),
    (4, 0), (4, 1), (4, 2), (4, 3), (4, 4), (4, 9), (4, 10), (4, 11),
    (4, 12), (4, 13), (4, 14), (4, 15), (4, 16), (4, 17), (4, 18), (4, 19),
    (4, 20), (4, 21), (4, 22), (4, 23), (4, 24), (4, 25), (4, 26),
    (13, 9), (13, 10), (13, 11), (13, 12), (13, 13), (13, 18), (13, 19),
    (13, 20), (13, 21), (13, 22), (13, 23), (13, 24), (13, 25), (13, 26),
    (22, 18), (22, 19), (22, 20), (22, 21), (22, 22),
]


def _pos_offset(k: int, rx: int, ry: int) -> Tuple[int, int]:
    return (rx * (k % 3 - 1), ry * (k // 3 - 1))


def _shifted(img: jax.Array, di: int, dj: int) -> jax.Array:
    """img(i+di, j+dj) aligned at (i, j), zero outside (borders, like the
    reference's interior-only loop bounds)."""
    out = jnp.roll(img, (-di, -dj), axis=(0, 1))
    if di > 0:
        out = out.at[-di:, :].set(0)
    elif di < 0:
        out = out.at[:-di, :].set(0)
    if dj > 0:
        out = out.at[:, -dj:].set(0)
    elif dj < 0:
        out = out.at[:, :-dj].set(0)
    return out


def _planes(img: jax.Array, rx: int, ry: int) -> list:
    """9 (gray) or 27 (color) shifted planes indexed like the reference's
    a[] array."""
    if img.ndim == 2:
        return [_shifted(img, *_pos_offset(k, rx, ry)) for k in range(9)]
    planes = []
    for c in range(img.shape[-1]):
        for k in range(9):
            planes.append(_shifted(img[..., c], *_pos_offset(k, rx, ry)))
    # reference indexing is a[9*c + k] but iterates channel-major in k —
    # build a[ch*9 + k] with a[..] as laid out above, then reorder to the
    # reference's a[k + 9*c] (identical here since we appended c-major, k-minor)
    return planes


def _accumulate(planes: list, patterns: Sequence[Tuple[int, ...]],
                gate: jax.Array | None) -> jax.Array:
    feats = []
    for pat in patterns:
        prod = None
        for t in pat:
            prod = planes[t] if prod is None else prod * planes[t]
        if gate is not None:
            prod = prod * gate
        feats.append(jnp.sum(prod))
    return jnp.stack(feats)


def hlac_bin(img: jax.Array, order: int = 2, rx: int = 1, ry: int = 1,
             normalize: bool = False) -> jax.Array:
    """Binary-image HLAC (HLAC::extractBin): (H, W) 0/1 image → (5,) or
    (25,).  Contributions gated on the center pixel being set."""
    img = jnp.asarray(img, jnp.float32)
    planes = _planes(img, rx, ry)
    gate = (planes[4] > 0).astype(img.dtype)
    pats = BIN1_3 if order <= 1 else BIN2_3
    # center itself appears via the gate: pattern (4,) = Σ gate·a4 etc.
    out = _accumulate(planes, pats, gate)
    if normalize:
        out = out / (img.shape[0] * img.shape[1])
    return out


def hlac_gray(img: jax.Array, order: int = 2, rx: int = 1, ry: int = 1,
              normalize: bool = False) -> jax.Array:
    """Gray-image HLAC (HLAC::extractGray): (H, W) → (6,) or (35,)."""
    img = jnp.asarray(img, jnp.float32)
    planes = _planes(img, rx, ry)
    pats = GRAY1_3 if order <= 1 else GRAY2_3
    out = _accumulate(planes, pats, None)
    if normalize:
        out = out / (img.shape[0] * img.shape[1])
    return out


def hlac_color(img: jax.Array, rx: int = 1, ry: int = 1,
               normalize: bool = False) -> jax.Array:
    """Color-image HLAC order ≤1 (HLAC::extractColor): (H, W, 3) → (45,)."""
    img = jnp.asarray(img, jnp.float32)
    planes = _planes(img, rx, ry)
    out = _accumulate(planes, COLOR1_3, None)
    if normalize:
        out = out / (img.shape[0] * img.shape[1])
    return out

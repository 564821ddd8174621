"""ColorCHLAC / C3-HLAC voxel color-correlation features as tensor contractions.

Re-design of the reference's per-voxel accumulation loops
(color_chlac/include/color_chlac/color_chlac.hpp:1566-1758 — the
rotation-invariant 117-dim layout replicated bin-for-bin here;
c3_hlac/src/c3_hlac.cpp:253-322 is the same math behind a plugin ABI).

Let occ(v) ∈ {0,1} be voxel occupancy and u(v) ∈ R⁶ the color channel
vector [r, 255−r, g, 255−g, b, 255−b] of the voxel centroid (w(v) the
binarized analog [r>t, 1−(r>t), g>t, …]).  Then every CHLAC bin is one
of three tensor contractions:

  0th order:      Σ_v u(v)                                  (6 dims)
  center pairs:   Σ_v u(v) ⊗ u(v)      (upper triangle)     (21 dims)
  neighbor pairs: Σ_v u(v) ⊗ u(v+δ)    summed over the 13
                  half-neighborhood offsets (117) or kept
                  per-δ (981)                                (36·|δ| dims)

Here the neighbor sums become 13 shifted adds (S(v) = Σ_δ u(v+δ))
followed by ONE einsum over the grid — matmul work, no per-voxel loop.
Subdivision histograms (used by the sliding-box detector) reshape the
grid into (s,s,s) blocks and einsum per block; neighbor products are
attributed to the *center* voxel's block exactly as the reference does
(computeColorCHLAC hist_idx logic, color_chlac.hpp:1464-1504).

The 981-dim rotation-variant feature uses this package's own
neighbor-major layout (offset index major, 6×6 color pair minor) — same
information as the reference's interleaved layout, but with 90°-rotation
permutations *derived algorithmically* (rotate_feature_981) instead of
hand-unrolled tables (c3_hlac.cpp:49-160).
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mapping_private_tpu.core.voxelgrid import VoxelGrid

# The reference's 13 half-neighborhood offsets, exact order
# (color_chlac.hpp ctor / c3_hlac.cpp:180-201): 9 with dz=-1, 3 with
# (dy=-1, dz=0), 1 with (-1, 0, 0).
NEIGHBOR_OFFSETS_13 = tuple(
    [(i, j, -1) for i in (-1, 0, 1) for j in (-1, 0, 1)]
    + [(i, -1, 0) for i in (-1, 0, 1)]
    + [(-1, 0, 0)]
)

# normalization constants (color_chlac/include/color_chlac/color_chlac.h:39-46)
_N0 = 1.0 / 255.0
_N1 = 1.0 / 65025.0
_N1_RI = 1.0 / 845325.0  # 65025 * 13
_N1_BIN_RI = 1.0 / 13.0

_UPPER_TRI = [(i, j) for i in range(6) for j in range(i, 6)]  # 21 pairs
_BIN_CENTER_PAIRS = [
    (0, 2), (0, 3), (0, 4), (0, 5),
    (1, 2), (1, 3), (1, 4), (1, 5),
    (2, 4), (2, 5), (3, 4), (3, 5),
]  # 12 pairs (color_chlac.hpp:1612-1645 bin order)


def color_channels(
    grid: VoxelGrid, thresholds: Tuple[int, int, int] = (127, 127, 127)
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Build (X,Y,Z,6) real + binary channel tensors and occupancy."""
    occ = grid.occupancy().astype(jnp.float32)
    rgb = jnp.stack(
        [grid.mean("r"), grid.mean("g"), grid.mean("b")], axis=-1
    )  # (X,Y,Z,3), 0..255
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    u = jnp.stack([r, 255.0 - r, g, 255.0 - g, b, 255.0 - b], axis=-1)
    u = u * occ[..., None]
    tr, tg, tb = thresholds
    br = (r > tr).astype(jnp.float32)
    bg = (g > tg).astype(jnp.float32)
    bb = (b > tb).astype(jnp.float32)
    w = jnp.stack([br, 1.0 - br, bg, 1.0 - bg, bb, 1.0 - bb], axis=-1)
    w = w * occ[..., None]
    return u, w, occ


def _shift(x: jax.Array, d: Tuple[int, int, int]) -> jax.Array:
    """x(v + d) aligned at v, zero beyond the border.  x: (X,Y,Z,C)."""
    out = x
    for axis, s in enumerate(d):
        if s == 0:
            continue
        out = jnp.roll(out, -s, axis=axis)
        idx = [slice(None)] * out.ndim
        if s > 0:
            idx[axis] = slice(out.shape[axis] - s, None)
        else:
            idx[axis] = slice(0, -s)
        out = out.at[tuple(idx)].set(0.0)
    return out


def neighbor_sum(x: jax.Array) -> jax.Array:
    """S(v) = Σ_{δ∈13} x(v+δ)."""
    return sum(_shift(x, d) for d in NEIGHBOR_OFFSETS_13)


def _pair_matrix(a: jax.Array, b: jax.Array) -> jax.Array:
    """Σ_v a(v) ⊗ b(v) over the grid: (X,Y,Z,6)² → (6,6)."""
    return jnp.einsum("xyzc,xyzd->cd", a, b)


def colorchlac117(
    grid: VoxelGrid, thresholds: Tuple[int, int, int] = (127, 127, 127)
) -> jax.Array:
    """Rotation-invariant 117-dim ColorCHLAC, bin-exact layout
    (color_chlac.hpp addColorCHLAC_{0,1}{,_bin} RI variants)."""
    u, w, _ = color_channels(grid, thresholds)
    su = neighbor_sum(u)
    sw = neighbor_sum(w)

    f0 = jnp.sum(u, axis=(0, 1, 2)) * _N0  # [0..5]
    pair_u = _pair_matrix(u, su)  # (6,6) center-major
    f1 = pair_u.reshape(-1) * _N1_RI  # [6..41]
    m_u = _pair_matrix(u, u)
    f2 = jnp.stack([m_u[i, j] for i, j in _UPPER_TRI]) * _N1  # [42..62]
    f3 = jnp.sum(w, axis=(0, 1, 2))  # [63..68], ×1
    pair_w = _pair_matrix(w, sw)
    f4 = pair_w.reshape(-1) * _N1_BIN_RI  # [69..104]
    m_w = _pair_matrix(w, w)
    f5 = jnp.stack([m_w[i, j] for i, j in _BIN_CENTER_PAIRS])  # [105..116]
    return jnp.concatenate([f0, f1, f2, f3, f4, f5])


def colorchlac981(
    grid: VoxelGrid, thresholds: Tuple[int, int, int] = (127, 127, 127)
) -> jax.Array:
    """Rotation-variant 981-dim ColorCHLAC, neighbor-major layout:

      [0..5]      Σ u                        × 1/255
      [6..473]    for δ_k, k=0..12: flatten(Σ u(v) ⊗ u(v+δ_k)) × 1/65025
      [474..494]  center upper-tri           × 1/65025
      [495..500]  Σ w
      [501..968]  per-δ bin pairs            × 1
      [969..980]  bin center pairs           × 1

    Offset-major ordering is the native (contiguous) layout; use
    to_reference_layout_981 for the reference's interleaved bin order
    (c3_hlac_core.h:44-55) when interoperating with reference-extracted
    features/models, and rotate_feature_981 for the 90°-rotation group.
    """
    u, w, _ = color_channels(grid, thresholds)
    parts = [jnp.sum(u, axis=(0, 1, 2)) * _N0]
    for d in NEIGHBOR_OFFSETS_13:
        parts.append(_pair_matrix(u, _shift(u, d)).reshape(-1) * _N1)
    m_u = _pair_matrix(u, u)
    parts.append(jnp.stack([m_u[i, j] for i, j in _UPPER_TRI]) * _N1)
    parts.append(jnp.sum(w, axis=(0, 1, 2)))
    for d in NEIGHBOR_OFFSETS_13:
        parts.append(_pair_matrix(w, _shift(w, d)).reshape(-1))
    m_w = _pair_matrix(w, w)
    parts.append(jnp.stack([m_w[i, j] for i, j in _BIN_CENTER_PAIRS]))
    return jnp.concatenate(parts)


def _pad_to_blocks(x: jax.Array, bs: int) -> jax.Array:
    """Zero-pad the three grid axes up to multiples of the block size."""
    X, Y, Z = x.shape[:3]
    px, py, pz = (-X) % bs, (-Y) % bs, (-Z) % bs
    if px or py or pz:
        pad = [(0, px), (0, py), (0, pz)] + [(0, 0)] * (x.ndim - 3)
        x = jnp.pad(x, pad)
    return x


def _block_pair(a: jax.Array, b: jax.Array, bs: int) -> jax.Array:
    """Per-block Σ_v a(v) ⊗ b(v): (X,Y,Z,6)² → (Bx,By,Bz,6,6).

    Reshape into (Bx,bs,By,bs,Bz,bs,6) and contract the intra-block axes
    with one einsum — the subdivision accumulation of the reference's
    computeColorCHLAC hist_idx binning (color_chlac.hpp:1464-1504) as
    batched matmul work."""
    a = _pad_to_blocks(a, bs)
    b = _pad_to_blocks(b, bs)
    X, Y, Z, C = a.shape
    ar = a.reshape(X // bs, bs, Y // bs, bs, Z // bs, bs, C)
    br = b.reshape(X // bs, bs, Y // bs, bs, Z // bs, bs, C)
    return jnp.einsum("xaybzcC,xaybzcD->xyzCD", ar, br)


def _block_sum(x: jax.Array, bs: int) -> jax.Array:
    """Per-block Σ_v x(v): (X,Y,Z,...) → (Bx,By,Bz,...)."""
    x = _pad_to_blocks(x, bs)
    X, Y, Z = x.shape[:3]
    rest = x.shape[3:]
    xr = x.reshape((X // bs, bs, Y // bs, bs, Z // bs, bs) + rest)
    return xr.sum(axis=(1, 3, 5))


def occupied_count_subdiv(grid: VoxelGrid, block_size: int) -> jax.Array:
    """(Bx,By,Bz) occupied-voxel count per subdivision (the sliding-box
    detector's exist_voxel_num, search.cpp:450)."""
    return _block_sum(grid.occupancy().astype(jnp.float32), block_size)


def colorchlac117_subdiv(
    grid: VoxelGrid,
    block_size: int,
    thresholds: Tuple[int, int, int] = (127, 127, 127),
) -> jax.Array:
    """(Bx,By,Bz,117) per-subdivision rotation-invariant ColorCHLAC.

    Neighbor products are attributed to the *center* voxel's block, as the
    reference does; products whose neighbor lies in an adjacent block are
    still counted (the shifted tensor carries the neighbor's value into
    the center's position before the block reduction)."""
    u, w, _ = color_channels(grid, thresholds)
    su = neighbor_sum(u)
    sw = neighbor_sum(w)
    bs = block_size
    f0 = _block_sum(u, bs) * _N0
    f1 = _block_pair(u, su, bs).reshape(f0.shape[:3] + (36,)) * _N1_RI
    m_u = _block_pair(u, u, bs)
    f2 = jnp.stack([m_u[..., i, j] for i, j in _UPPER_TRI], axis=-1) * _N1
    f3 = _block_sum(w, bs)
    f4 = _block_pair(w, sw, bs).reshape(f0.shape[:3] + (36,)) * _N1_BIN_RI
    m_w = _block_pair(w, w, bs)
    f5 = jnp.stack([m_w[..., i, j] for i, j in _BIN_CENTER_PAIRS], axis=-1)
    return jnp.concatenate([f0, f1, f2, f3, f4, f5], axis=-1)


def colorchlac981_subdiv(
    grid: VoxelGrid,
    block_size: int,
    thresholds: Tuple[int, int, int] = (127, 127, 127),
) -> jax.Array:
    """(Bx,By,Bz,981) per-subdivision rotation-variant ColorCHLAC
    (same layout as colorchlac981)."""
    u, w, _ = color_channels(grid, thresholds)
    bs = block_size
    f0 = _block_sum(u, bs) * _N0
    base = f0.shape[:3]
    parts = [f0]
    for d in NEIGHBOR_OFFSETS_13:
        parts.append(_block_pair(u, _shift(u, d), bs).reshape(base + (36,)) * _N1)
    m_u = _block_pair(u, u, bs)
    parts.append(jnp.stack([m_u[..., i, j] for i, j in _UPPER_TRI], axis=-1) * _N1)
    parts.append(_block_sum(w, bs))
    for d in NEIGHBOR_OFFSETS_13:
        parts.append(_block_pair(w, _shift(w, d), bs).reshape(base + (36,)))
    m_w = _block_pair(w, w, bs)
    parts.append(jnp.stack([m_w[..., i, j] for i, j in _BIN_CENTER_PAIRS], axis=-1))
    return jnp.concatenate(parts, axis=-1)


def _rotation_matrix(mode: str) -> np.ndarray:
    """90° rotation matrices: mode 1 = +90° about z, 2 = +90° about y,
    3 = +90° about x (generators of the 24-element cube rotation group)."""
    if mode == "z":
        return np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]])
    if mode == "y":
        return np.array([[0, 0, 1], [0, 1, 0], [-1, 0, 0]])
    if mode == "x":
        return np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]])
    raise ValueError(mode)


@functools.lru_cache(maxsize=None)
def _rotation_permutation_981(mode: str) -> np.ndarray:
    """Permutation perm such that feature_rotated[i] = feature[perm[i]].

    Under rotation R, Σ u(v)⊗u(v+δ) (pair index (c1,c2) at offset δ)
    maps to the entry at offset R·δ; when R·δ falls in the *negative*
    half-neighborhood, use −R·δ with (c1,c2) transposed (the sum over v
    re-indexes symmetrically).  Color channels are unaffected.
    Derived algorithmically — replaces the reference's hand-unrolled
    tables (c3_hlac.cpp:49-160).
    """
    R = _rotation_matrix(mode)
    offs = [np.array(d) for d in NEIGHBOR_OFFSETS_13]
    off_index = {tuple(d): k for k, d in enumerate(NEIGHBOR_OFFSETS_13)}
    perm = np.arange(981)

    def block_perm(base):
        # rotated feature's δ-block k comes from source block k_src
        for k, d in enumerate(offs):
            rd = R.T @ d  # offset in source frame corresponding to target δ
            swap = False
            if tuple(rd) not in off_index:
                rd = -rd
                swap = True
            ks = off_index[tuple(rd)]
            for c1 in range(6):
                for c2 in range(6):
                    dst = base + k * 36 + c1 * 6 + c2
                    src = base + ks * 36 + ((c2 * 6 + c1) if swap else (c1 * 6 + c2))
                    perm[dst] = src

    block_perm(6)
    block_perm(501)
    return perm


def rotate_feature_981(feature: jax.Array, mode: str) -> jax.Array:
    """Feature vector of the voxel grid rotated by 90° about an axis."""
    perm = jnp.asarray(_rotation_permutation_981(mode))
    return feature[perm]


@functools.lru_cache(maxsize=None)
def _perm_own_to_reference_981() -> np.ndarray:
    """Permutation P with ref_layout[i] = own_layout[P[i]].

    The reference's interleaved 981 bin order (derived from
    color_chlac/include/color_chlac/color_chlac.hpp:296-801
    addColorCHLAC_1 and confirmed by the c3_hlac stride pattern
    ``6 + c2*9 + c1*78`` / ``60 + c2*4 + c1*78``, c3_hlac/src/c3_hlac.cpp:86-160):

      [0:6]      Σu — identical to own layout
      neighbor real bins: row per center channel c1 (stride 78 from 6);
        within a row, neighbor offsets k=0..8 sit at 9·c2 + k and
        k=9..12 at 54 + 4·c2 + (k−9)
      [474:495]  center u⊗u upper triangle — identical order
      [495:501]  Σw — identical
      neighbor binary bins: same interleaving shifted by 495
      [969:981]  binary center pairs — identical order

    Own layout is offset-major (6 + 36·k + 6·c1 + c2).  Both carry the
    same products with the same normalizers, so a pure permutation maps
    between them — this is what makes reference-extracted 981/VOSCH
    features and models interoperable with this package.
    """
    perm = np.arange(981)

    def ref_bin(base: int, c1: int, c2: int, k: int) -> int:
        row = base + 78 * c1
        if k < 9:
            return row + 9 * c2 + k
        return row + 54 + 4 * c2 + (k - 9)

    for c1 in range(6):
        for c2 in range(6):
            for k in range(13):
                perm[ref_bin(6, c1, c2, k)] = 6 + 36 * k + 6 * c1 + c2
                perm[ref_bin(501, c1, c2, k)] = 501 + 36 * k + 6 * c1 + c2
    return perm


def to_reference_layout_981(feature: jax.Array) -> jax.Array:
    """Own-layout 981 feature → the reference's interleaved bin order
    (bit-compatible with c3_hlac/color_chlac extractColorCHLACSignature981
    output, so reference-trained classifiers/subspaces apply directly)."""
    return feature[..., jnp.asarray(_perm_own_to_reference_981())]


def from_reference_layout_981(feature: jax.Array) -> jax.Array:
    """Inverse of to_reference_layout_981 (import reference artifacts)."""
    inv = np.argsort(_perm_own_to_reference_981())
    return feature[..., jnp.asarray(inv)]


# ---------------------------------------------------------------------------
# RGB binarization-threshold learning
# (color_voxel_recognition/test/calc_scene_auto_threshold.cpp:60-160)
# ---------------------------------------------------------------------------

def rgb_voxel_histograms(grid: VoxelGrid) -> jax.Array:
    """(3, 256) int32 histograms of the occupied voxels' mean RGB.

    The device-side half of the reference's threshold learner
    (calc_scene_auto_threshold.cpp:92-113): PCL's VoxelGrid centroids
    become our per-voxel channel means, truncated to integer bins the
    way PCL's uint8 repack truncates the averaged channels.  One
    bincount per channel over the flattened grid — no per-point loop.
    Accumulate across scene sweeps by summing the returned histograms.
    """
    occ = grid.occupancy().reshape(-1)
    hists = []
    for name in ("r", "g", "b"):
        q = jnp.clip(grid.mean(name).reshape(-1).astype(jnp.int32), 0, 255)
        # dead voxels go to an overflow bin that is sliced off
        q = jnp.where(occ, q, 256)
        hists.append(jnp.bincount(q, length=257)[:256])
    return jnp.stack(hists).astype(jnp.int32)


def calc_auto_threshold(hist) -> Tuple[int, int, int]:
    """Per-channel RGB binarization thresholds maximizing the reference's
    between-class-variance criterion (calc_scene_auto_threshold.cpp:115-152).

    For each channel with histogram h and N = Σh:
      eachNum[j] = Σ_{k≤j} h[k],  eachAve[j] = Σ_{k≤j} k·h[k] / eachNum[j]
      var[j] = (eachAve[j] − totalAve)² · eachNum[j] / (N − eachNum[j])
    and threshold = the first j ∈ [1,255] attaining the strictly-largest
    var (0 when no split improves on 0 — the reference's max_var=0 /
    strict-> seed).  The reference's skip (eachNum==0) and break
    (eachNum==N) are masks here: cumsum is monotone, so everything at or
    past the break point is masked identically.  256 bins — host numpy.
    """
    h = np.asarray(hist, np.float64)
    j = np.arange(256, dtype=np.float64)
    out = []
    for c in range(3):
        n = h[c].sum()
        if n == 0:
            out.append(0)
            continue
        total_ave = float((j * h[c]).sum() / n)
        each_num = np.cumsum(h[c])
        each_ave = np.where(
            each_num > 0, np.cumsum(j * h[c]) / np.maximum(each_num, 1), 0.0)
        valid = (each_num > 0) & (each_num < n)
        valid[0] = False  # the reference scans j = 1..255
        var = np.where(
            valid,
            (each_ave - total_ave) ** 2
            * (each_num / np.maximum(n - each_num, 1)),
            -1.0,
        )
        out.append(int(np.argmax(var)) if var.max() > 0 else 0)
    return tuple(out)


def calc_scene_auto_threshold(grids) -> Tuple[int, int, int]:
    """Learn (r, g, b) binarization thresholds from scene voxel grids —
    the counterpart of the reference's one-time environment-learning tool
    (calc_scene_auto_threshold.cpp:53-169, invoked by demos/SH/learn_env.sh).
    Feed the result as ``thresholds=`` to the colorchlac extractors."""
    total = None
    for g in grids:
        hst = rgb_voxel_histograms(g)
        total = hst if total is None else total + hst
    if total is None:
        raise ValueError("calc_scene_auto_threshold needs >= 1 voxel grid")
    return calc_auto_threshold(np.asarray(total))

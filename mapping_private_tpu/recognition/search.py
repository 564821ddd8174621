"""Sliding-box subspace detection — `SearchObj` JAX-native.

Replaces color_voxel_recognition/src/search.cpp: the scene is divided into
subdivisions (boxes of voxels), each carrying a (compressed) feature vector
and an occupied-voxel count; a 3-D summed-area table gives O(1) box feature
extraction (clipValue 8-corner inclusion-exclusion, search.cpp:484-530);
boxes of the object's subdivision extent slide over the scene in up to 6
axis-permutation modes (getRange :218-249, search :384-414); similarity =
‖axis_q · f‖ / ‖f‖ — the norm of the projection onto the object's PCA
subspace (searchPart :450-461); results are rank-listed with overlap
suppression (checkOverlap :327-356).

Array formulation: the triple z/y/x loop collapses into array slicing of the
zero-padded integral table (every box origin at once), and the per-box
mat-vec becomes ONE (X·Y·Z, D) × (D, M) matmul per mode.  Overlap-
suppressed ranking of the handful of final candidates runs on the host,
mirroring the reference's greedy semantics exactly.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

# the 6 axis-permutation search modes: mode -> (xrange, yrange, zrange)
# indices into the object's (range1, range2, range3) (search.cpp:218-249)
_MODE_PERMS = (
    (0, 1, 2),  # S_MODE_1
    (0, 2, 1),  # S_MODE_2
    (1, 0, 2),  # S_MODE_3
    (1, 2, 0),  # S_MODE_4
    (2, 0, 1),  # S_MODE_5
    (2, 1, 0),  # S_MODE_6
)


def active_modes(r1: int, r2: int, r3: int) -> List[int]:
    """Distinct modes for an object extent (search.cpp search() :387-413)."""
    if r1 == r2 == r3:
        return [0]
    if r1 == r2:
        return [0, 1, 4]
    if r2 == r3:
        return [0, 4, 5]
    if r1 == r3:
        return [0, 4, 2]
    return [0, 1, 2, 3, 4, 5]


@dataclasses.dataclass(frozen=True)
class SceneData:
    """Integral tables of the subdivided scene.

    int_feat: (X+1, Y+1, Z+1, D) zero-padded SAT of subdivision features.
    int_exist: (X+1, Y+1, Z+1) SAT of occupied-voxel counts.
    """

    int_feat: jax.Array
    int_exist: jax.Array

    @property
    def dims(self) -> Tuple[int, int, int]:
        s = self.int_exist.shape
        return s[0] - 1, s[1] - 1, s[2] - 1


def build_scene_data(
    features: jax.Array,
    exist_num: jax.Array,
    scene_axis: Optional[jax.Array] = None,
    scene_mean: Optional[jax.Array] = None,
) -> SceneData:
    """SAT construction (SearchObj::setData, search.cpp:538+).

    features: (X, Y, Z, D_raw) per-subdivision feature vectors.
    exist_num: (X, Y, Z) occupied-voxel counts.
    scene_axis: optional (dim, D_raw) compression axis (setSceneAxis) —
      projects each subdivision feature before integration, as
      detect_object.cpp does before setData.
    """
    f = jnp.asarray(features, jnp.float32)
    if scene_axis is not None:
        if scene_mean is not None:
            f = f - scene_mean
        f = jnp.einsum("xyzd,md->xyzm", f, jnp.asarray(scene_axis, jnp.float32))
    sat = jnp.cumsum(jnp.cumsum(jnp.cumsum(f, axis=0), axis=1), axis=2)
    sat = jnp.pad(sat, ((1, 0), (1, 0), (1, 0), (0, 0)))
    e = jnp.cumsum(
        jnp.cumsum(jnp.cumsum(jnp.asarray(exist_num, jnp.float32), axis=0), axis=1),
        axis=2,
    )
    e = jnp.pad(e, ((1, 0), (1, 0), (1, 0)))
    return SceneData(int_feat=sat, int_exist=e)


def _box_sums(sat: jax.Array, rx: int, ry: int, rz: int) -> jax.Array:
    """All-origin box sums from a zero-padded SAT.

    sat: (X+1, Y+1, Z+1, ...) → (X−rx+1, Y−ry+1, Z−rz+1, ...).
    The 8-corner inclusion–exclusion (clipValue, search.cpp:484-530)
    becomes 8 contiguous slices — fully vectorized over box origins.
    """
    X = sat.shape[0] - 1
    Y = sat.shape[1] - 1
    Z = sat.shape[2] - 1
    xe, ye, ze = X - rx + 1, Y - ry + 1, Z - rz + 1

    def corner(dx, dy, dz):
        return sat[
            dx * rx : dx * rx + xe,
            dy * ry : dy * ry + ye,
            dz * rz : dz * rz + ze,
        ]

    return (
        corner(1, 1, 1)
        - corner(0, 1, 1)
        - corner(1, 0, 1)
        - corner(1, 1, 0)
        + corner(0, 0, 1)
        + corner(0, 1, 0)
        + corner(1, 0, 0)
        - corner(0, 0, 0)
    )


@partial(jax.jit, static_argnums=(2, 3, 4))
def _mode_scores(
    scene_feat: jax.Array,
    scene_exist: jax.Array,
    rx: int,
    ry: int,
    rz: int,
    axis_q: jax.Array,
    exist_threshold: float,
) -> jax.Array:
    """Similarity grid for one mode: (X−rx+1, Y−ry+1, Z−rz+1)."""
    f = _box_sums(scene_feat, rx, ry, rz)  # (..., D)
    e = _box_sums(scene_exist[..., None], rx, ry, rz)[..., 0]
    proj = jnp.einsum("xyzd,md->xyzm", f, axis_q)  # (..., M) one matmul
    num = jnp.linalg.norm(proj, axis=-1)
    den = jnp.maximum(jnp.linalg.norm(f, axis=-1), 1e-20)
    sim = num / den
    return jnp.where(e > exist_threshold, sim, -1.0)


@dataclasses.dataclass
class Detection:
    """One ranked detection: box origin (subdivision coords), extent, score."""

    x: int
    y: int
    z: int
    xrange: int
    yrange: int
    zrange: int
    mode: int
    score: float


def _overlaps(a: Detection, b: Detection) -> bool:
    """Axis-aligned interval overlap in all 3 dims (checkOverlap :327-356)."""
    return (
        a.x < b.x + b.xrange and b.x < a.x + a.xrange
        and a.y < b.y + b.yrange and b.y < a.y + a.yrange
        and a.z < b.z + b.zrange and b.z < a.z + a.zrange
    )


def search_object(
    scene: SceneData,
    axis_q: jax.Array,
    ranges: Sequence[int],
    rank_num: int = 5,
    exist_threshold: float = 10.0,
    with_rotation: bool = True,
    score_floor: float = 0.0,
) -> List[Detection]:
    """Sliding-box subspace detection of one object.

    Args:
      scene: integral tables from build_scene_data.
      axis_q: (dim_model, dim) object subspace (recognition.subspace_axis).
      ranges: (range1, range2, range3) object extent in subdivisions.
      rank_num: number of ranked detections to keep.
      with_rotation: try all distinct axis permutations (search vs
        searchWithoutRotation, search.cpp:384-427).

    Returns up to rank_num non-overlapping Detections, best first.
    """
    r = tuple(int(v) for v in ranges)
    X, Y, Z = scene.dims
    modes = active_modes(*r) if with_rotation else [0]
    axis_q = jnp.asarray(axis_q, jnp.float32)

    candidates: List[Detection] = []
    for m in modes:
        perm = _MODE_PERMS[m]
        rx, ry, rz = r[perm[0]], r[perm[1]], r[perm[2]]
        if X - rx + 1 <= 0 or Y - ry + 1 <= 0 or Z - rz + 1 <= 0:
            continue
        sim = np.asarray(
            _mode_scores(
                scene.int_feat, scene.int_exist, rx, ry, rz, axis_q,
                float(exist_threshold),
            )
        )
        # keep the best rank_num*8 per mode — overlap suppression needs slack
        flat = sim.ravel()
        k = min(len(flat), rank_num * 8)
        top = np.argpartition(-flat, k - 1)[:k]
        for t in top:
            s = float(flat[t])
            if s <= score_floor:
                continue
            zi = t % sim.shape[2]
            yi = (t // sim.shape[2]) % sim.shape[1]
            xi = t // (sim.shape[1] * sim.shape[2])
            candidates.append(
                Detection(int(xi), int(yi), int(zi), rx, ry, rz, m, s)
            )

    # greedy overlap-suppressed ranking (maxAssign/maxCpy semantics)
    candidates.sort(key=lambda d: -d.score)
    ranked: List[Detection] = []
    for c in candidates:
        if len(ranked) >= rank_num:
            break
        if any(_overlaps(c, kept) for kept in ranked):
            continue
        ranked.append(c)
    return ranked


def search_objects_multi(
    scene: SceneData,
    axes_q: Sequence[jax.Array],
    ranges_list: Sequence[Sequence[int]],
    rank_num: int = 5,
    exist_threshold: float = 10.0,
    with_rotation: bool = True,
    score_floor: float = 0.0,
) -> List[List[Detection]]:
    """Multi-object variant (`SearchObjMulti`, search.h:185-270): one scene
    SAT shared across all object subspaces."""
    return [
        search_object(
            scene, aq, rg, rank_num=rank_num, exist_threshold=exist_threshold,
            with_rotation=with_rotation, score_floor=score_floor,
        )
        for aq, rg in zip(axes_q, ranges_list)
    ]

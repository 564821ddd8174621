"""Sequential Hough-voting shape segmentation — `hough_segmentation` JAX-native.

Replaces the reference's largest package (hough_segmentation/src/
sequential_hough.cpp, 7.6k LoC): per scene it repeatedly (a) runs many
adaptive RANSAC line/circle fits on the table-projected 2D points
(ransac.hpp fitLine :75-104 / fitCircle :127-191), (b) votes each fitted
model into a parameter space (line/circle parameter clustering,
sequential_hough.cpp:4392-4515), (c) takes the model with the most votes,
grows its inliers vertically, estimates a cuboid (:4554-6102) or cylinder
(:6103-6356), removes the inliers and repeats (the `while continue_hough`
loop :3920), finally classifying each object as tall/medium/short/flat
(:3727-3816, thresholds :181-189).

Discriminative machinery (the reference's hypothesis gates):
- per-point CURVATURE splits planar vs circular surface points
  (sequential_hough.cpp:2060-2094, curvature_threshold :88);
- per-point RSD r_min plausibility band (:2174-2185, low/high_r_min :91-92);
- CLUSTERING feature: a candidate's inliers are euclidean-clustered; the
  cluster richest in matching-curvature points wins; candidates whose
  best cluster has ≤1 matching curvature are rejected
  (ClusteringFeatureForLines :662-945 / ForCircles :947-1255);
- model re-adjustment on the curvature-consistent subset at half
  threshold (adjustLineModel/adjustCircleModel, :4063-4070, :4203-4208);
- line LENGTH gate (:4091-4105, minimum_line_length :116);
- TOO-MANY-PLANAR-CURVATURES gate for circles: a circle whose disk
  contains more planar-curvature points than allowed explains a flat
  region, not a cylinder (:4210-4232, too_many_planar_curvatures :199);
- NORMAL feature: line inliers need xy-normals ⊥ the line, circle
  inliers need radial xy-normals (NormalFeatureForLines :1257-1354 /
  ForCircles :1356-1455; off by default — the executed reference path
  has them commented out, :4140, :4264);
- SIGNIFICANT-PLANE pass: an upfront RANSAC plane whose biggest inlier
  cluster becomes a planar object (:2347-3913, `sign` flag :178);
- REST-OF-POINTS pass: when neither model wins, the remaining points are
  clustered and emitted as PCA oriented boxes (:6357-6600,
  deal_with_the_rest_of_the_points :183).

Array formulation: the serial VRANSAC iterations become H parallel
hypotheses; parameter-space voting is a quantize + scatter-add where each
hypothesis votes with its inlier count; the winning cell's hypotheses are
averaged (the reference's cluster-mean model).  Curvature/RSD channels
are batched kNN eigenanalysis (one pass for the whole cloud, not PCL's
per-point loops).  Each extraction round is one jitted program with
static shapes; the short sequential outer loop (one iteration per
extracted object) runs on the host exactly as the reference's does,
carrying only a live-point mask across rounds.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mapping_private_tpu.core.cloud import PointCloud
from mapping_private_tpu.fit.box import OrientedBox, fit_box_pca, fit_box_zup
from mapping_private_tpu.fit.ransac import fit_plane_ransac, sample_live_indices
from mapping_private_tpu.ops.cluster import euclidean_cluster
from mapping_private_tpu.ops.region_growing import region_grow


@dataclasses.dataclass(frozen=True)
class HoughConfig:
    num_hypotheses: int = 512
    line_threshold: float = 0.01  # sequential_hough.cpp:113
    circle_threshold: float = 0.01  # :114
    min_radius: float = 0.010
    max_radius: float = 0.100
    max_objects: int = 5
    min_inliers: int = 50  # minimum_line_inliers / minimum_circle_inliers
    # parameter-space quantization (clustering tolerance, :142-143)
    rho_bin: float = 0.01
    theta_bins: int = 90
    center_bin: float = 0.01
    radius_bin: float = 0.005
    grow_xy_margin: float = 0.015  # vertical growth corridor around the model
    # size classification (:181-189)
    flat_value: float = 0.25
    tall_value: float = 0.75
    medium_value: float = 0.50
    short_value: float = 0.25
    # --- hypothesis gates (reference defaults :88-136, recipes readme/) ---
    use_feature_gates: bool = True
    # MLS smoothing preamble (sequential_hough.cpp:1815-1860; the real-data
    # recipes run it with -smoothing_search_radius 0.020,
    # readme/sequential_hough:1-5).  Off by default: synthetic scenes don't
    # need it, real Kinect scans do — without it, sensor noise leaks
    # non-planar curvature onto flat faces and the curvature gates lose
    # their discriminative power.
    mls_smoothing: bool = False
    smoothing_search_radius: float = 0.020
    normal_search_k: int = 16  # normal_search_radius 0.02 as a kNN cap
    curvature_threshold: float = 0.010  # :88
    rsd_search_radius: float = 0.020  # :89
    rsd_plane_radius: float = 0.200  # :90
    low_r_min: float = 0.020  # :91
    high_r_min: float = 0.080  # :92
    rsd_feature_for_circles: bool = False  # plausibility band as a gate
    clustering_feature_for_lines: bool = True  # :128
    clustering_feature_for_circles: bool = True  # :129
    inliers_clustering_tolerance: float = 0.015  # :130-131
    # The reference tunes its tolerance (0.010) to dense Kinect clouds
    # (~2 mm point spacing).  On sparser clouds a fixed tolerance
    # fragments a candidate's inliers into sub-min_inliers shards and the
    # gate rejects everything, so the effective tolerance adapts:
    # max(inliers_clustering_tolerance, spacing_multiplier * p90 NN spacing).
    clustering_spacing_multiplier: float = 2.5
    # The reference rejects a candidate whose best cluster has ≤1 matching
    # curvatures (sequential_hough.cpp:760-764) and relies on dataset-tuned
    # absolute thresholds (recipe: minimum_size_of_circle_inliers_clusters
    # 250, minimum_circle_inliers 500 — readme/sequential_hough:4) plus MLS
    # smoothing to kill noise candidates.  Scale-free equivalent: require a
    # minimum FRACTION of the kept inliers to carry matching curvature — a
    # real cylinder ring is ~90%+ circular-curvature, a noise circle traced
    # through a flat region is <1%.
    min_matching_curvature_fraction: float = 0.10
    normal_feature_for_lines: bool = False  # executed ref path: commented out
    normal_feature_for_circles: bool = False
    # Scale-free strengthening of NormalFeatureForCircles for real scans:
    # among candidate inliers whose normal is side-facing (|n_xy| ≥ 0.5),
    # require at least this fraction to point radially (within
    # circle_normals_angle_threshold) from the circle center.  A real
    # cylinder wall is ~100% radial; a flat face cut by a circle is only
    # radial on a tiny arc.  0 disables (the reference's executed default —
    # its own gate only rejects when NO inlier is radial,
    # sequential_hough.cpp:1420-1427, which noise trivially satisfies).
    circle_side_radiality_fraction: float = 0.0
    # Weighted-vote density gate for circles: a circle candidate is only
    # valid when its accumulated hypothesis votes reach this multiple of
    # the live point count.  The reference thresholds circle acceptance
    # on vote counts (more_votes_for_circles / minimum_circle_inliers,
    # sequential_hough.cpp:4196-4238, recipe-tuned absolute values);
    # normalizing by the live cloud makes it scale-free.  Measured on
    # the HOUGH_EVAL suite: true cylinders accumulate 1.6-7.4 votes per
    # live point (consistent hypotheses re-hit one parameter bin), while
    # box faces traced by a spurious circle reach only 0.3-0.6.  0
    # disables (the synthetic-scene default).
    circle_vote_density_min: float = 0.0
    line_normals_angle_threshold: float = 2.5  # degrees, :137
    circle_normals_angle_threshold: float = 10.0  # :138
    minimum_line_length: float = 0.025  # :115
    maximum_line_length: float = 0.250  # :116
    too_many_planar_curvatures: int = 1000  # :199 (recipes pass 1000)
    # --- significant plane (:95-99, sign :178) ---
    significant_plane: bool = False
    significant_plane_threshold: float = 0.02
    minimum_inliers_of_significant_plane: int = 300
    significant_plane_clustering_tolerance: float = 0.03
    minimum_size_of_significant_plane_cluster: int = 100
    # --- rest of the points (:183, :192-193) ---
    deal_with_the_rest_of_the_points: bool = True
    r_clustering_tolerance: float = 0.025
    minimum_size_of_r_clusters: int = 50
    # Rest-cluster acceptance calibration (ours — the reference's rest
    # pass gates only on cluster size and relies on dataset-tuned
    # upstream thresholds to suppress leftovers; measured on the
    # HOUGH_EVAL suite these two gates remove its false positives):
    # a rest cluster is dropped when its second-largest extent is a
    # sliver below r_cluster_min_extent, or when its XY centroid lies
    # within r_cluster_dedup_radius of an already-accepted segment
    # (leftover base/ring fragments of a claimed object re-emitted as a
    # phantom box).  0 disables either gate.
    r_cluster_min_extent: float = 0.02
    r_cluster_dedup_radius: float = 0.09
    # Cluster-first circle test for rest clusters (the shape check
    # segment_by_voting applies per cluster): emit a cylinder instead of
    # a PCA box when >= this fraction of the cluster's XY footprint lies
    # within circle_threshold of its Kåsa circle.
    r_cluster_circle_fit: bool = True
    r_cluster_circle_inlier_fraction: float = 0.6
    # parameter-space model-clustering tolerance: hypotheses within this
    # distance of the winning model count as its votes
    # (segmentation_by_voting.cpp:123 clustering_tolerance_of_circle_
    # parameters = 0.025; sequential_hough.cpp:142-143)
    param_cluster_tolerance: float = 0.025


@dataclasses.dataclass
class HoughSegment:
    kind: str  # 'cuboid' | 'cylinder' | 'box' (rest-of-points PCA box) | 'plane'
    size_class: str  # 'tall' | 'medium' | 'short' | 'flat'
    inliers: np.ndarray  # (N,) bool
    num_inliers: int
    box: Optional[OrientedBox] = None  # cuboid params
    cylinder: Optional[Tuple[np.ndarray, float, float, float]] = None
    # cylinder = (center_xy, radius, z_min, z_max)
    votes: int = 0


def _line_hypotheses(xy, mask, key, H, threshold):
    """H 2-point line hypotheses → params (rho ≥ 0, theta), inlier counts."""
    idx = sample_live_indices(key, mask, (H, 2))
    p0, p1 = xy[idx[:, 0]], xy[idx[:, 1]]
    t = p1 - p0
    tlen = jnp.linalg.norm(t, axis=-1, keepdims=True)
    ok = tlen[:, 0] > 1e-9
    t = t / jnp.maximum(tlen, 1e-30)
    nrm = jnp.stack([-t[:, 1], t[:, 0]], axis=-1)  # (H,2)
    c = -jnp.sum(nrm * p0, axis=-1)
    # canonicalize: rho = −c ≥ 0 with nrm flipped accordingly (Hough form)
    flip = jnp.where(c > 0, -1.0, 1.0)[:, None]
    nrm = nrm * flip
    rho = jnp.abs(c)
    theta = jnp.arctan2(nrm[:, 1], nrm[:, 0])  # (−π, π]
    d = jnp.abs(xy @ nrm.T + (-rho)[None, :]).T  # (H,N)
    counts = jnp.sum(((d < threshold) & mask[None, :]).astype(jnp.int32), axis=1)
    counts = jnp.where(ok, counts, 0)
    return nrm, rho, theta, counts


def _circle_hypotheses(xy, mask, key, H, threshold, rmin, rmax):
    idx = sample_live_indices(key, mask, (H, 3))
    a, b, c3 = xy[idx[:, 0]], xy[idx[:, 1]], xy[idx[:, 2]]
    d = 2.0 * (
        a[:, 0] * (b[:, 1] - c3[:, 1])
        + b[:, 0] * (c3[:, 1] - a[:, 1])
        + c3[:, 0] * (a[:, 1] - b[:, 1])
    )
    ok = jnp.abs(d) > 1e-12
    d = jnp.where(ok, d, 1.0)
    a2, b2, c2 = jnp.sum(a * a, -1), jnp.sum(b * b, -1), jnp.sum(c3 * c3, -1)
    ux = (a2 * (b[:, 1] - c3[:, 1]) + b2 * (c3[:, 1] - a[:, 1]) + c2 * (a[:, 1] - b[:, 1])) / d
    uy = (a2 * (c3[:, 0] - b[:, 0]) + b2 * (a[:, 0] - c3[:, 0]) + c2 * (b[:, 0] - a[:, 0])) / d
    center = jnp.stack([ux, uy], -1)
    radius = jnp.linalg.norm(a - center, axis=-1)
    ok = ok & (radius >= rmin) & (radius <= rmax)
    dc = jnp.linalg.norm(xy[None, :, :] - center[:, None, :], axis=-1)
    dd = jnp.abs(dc - radius[:, None])
    counts = jnp.sum(((dd < threshold) & mask[None, :]).astype(jnp.int32), axis=1)
    counts = jnp.where(ok, counts, 0)
    return center, radius, counts


def _vote_argmax(bin_ids: jax.Array, weights: jax.Array, num_bins: int):
    """Scatter-add weights into bins; return (best_bin, votes)."""
    acc = jnp.zeros((num_bins,), jnp.int32).at[bin_ids].add(weights)
    best = jnp.argmax(acc)
    return best, acc[best]


@partial(jax.jit, static_argnums=(3,))
def _hough_round(xy, mask, key, cfg: HoughConfig):
    """One extraction round.  Returns a dict of both candidates' params,
    votes, and inlier masks; winner selection happens on the host."""
    kl, kc = jax.random.split(key)
    H = cfg.num_hypotheses

    # --- lines: vote in (rho, theta) parameter space ------------------------
    nrm, rho, theta, lc = _line_hypotheses(xy, mask, kl, H, cfg.line_threshold)
    rho_id = jnp.clip((rho / cfg.rho_bin).astype(jnp.int32), 0, 999)
    th_id = jnp.clip(
        ((theta + jnp.pi) / (2 * jnp.pi) * cfg.theta_bins).astype(jnp.int32),
        0, cfg.theta_bins - 1,
    )
    line_bins = rho_id * cfg.theta_bins + th_id
    lbest, lvotes = _vote_argmax(line_bins, lc, 1000 * cfg.theta_bins)
    in_bin = (line_bins == lbest) & (lc > 0)
    w = in_bin.astype(jnp.float32) * lc.astype(jnp.float32)
    wsum = jnp.maximum(jnp.sum(w), 1e-9)
    line_n = jnp.sum(nrm * w[:, None], axis=0) / wsum
    line_n = line_n / jnp.maximum(jnp.linalg.norm(line_n), 1e-12)
    line_rho = jnp.sum(rho * w) / wsum
    line_d = jnp.abs(xy @ line_n - line_rho)
    line_inl = (line_d < cfg.line_threshold) & mask
    line_count = jnp.sum(line_inl.astype(jnp.int32))
    # vote share: fraction of valid hypotheses whose model lies within the
    # parameter-clustering tolerance of the winner (the reference's
    # voting_threshold percentage, segmentation_by_voting.cpp:94)
    lvalid = lc > 0
    # canonicalize hypothesis sign: (−n, −rho) describes the same line as
    # (n, rho), so align each hypothesis's rho with the winner's normal
    # direction before the rho proximity test
    ldot = nrm @ line_n
    lsgn = jnp.where(ldot >= 0.0, 1.0, -1.0)
    lnear = lvalid & (
        jnp.abs(lsgn * rho - line_rho) < cfg.param_cluster_tolerance
    ) & (jnp.abs(ldot) > jnp.cos(jnp.deg2rad(10.0)))
    line_hyp_frac = jnp.sum(lnear.astype(jnp.float32)) / jnp.maximum(
        jnp.sum(lvalid.astype(jnp.float32)), 1.0
    )

    # --- circles: vote in (cx, cy, r) parameter space -----------------------
    center, radius, cc = _circle_hypotheses(
        xy, mask, kc, H, cfg.circle_threshold, cfg.min_radius, cfg.max_radius
    )
    cx_id = jnp.clip(((center[:, 0] + 5.0) / cfg.center_bin).astype(jnp.int32), 0, 1023)
    cy_id = jnp.clip(((center[:, 1] + 5.0) / cfg.center_bin).astype(jnp.int32), 0, 1023)
    r_id = jnp.clip((radius / cfg.radius_bin).astype(jnp.int32), 0, 63)
    circ_bins = (cx_id * 1024 + cy_id) * 64 + r_id
    # hash the huge id space into 1<<20 buckets (collisions only merge votes)
    circ_bins = (circ_bins * jnp.int32(-1640531535)) & ((1 << 20) - 1)  # Knuth 2654435761 as i32
    cbest, cvotes = _vote_argmax(circ_bins, cc, 1 << 20)
    cin = (circ_bins == cbest) & (cc > 0)
    cw = cin.astype(jnp.float32) * cc.astype(jnp.float32)
    cwsum = jnp.maximum(jnp.sum(cw), 1e-9)
    circ_c = jnp.sum(center * cw[:, None], axis=0) / cwsum
    circ_r = jnp.sum(radius * cw) / cwsum
    circ_d = jnp.abs(jnp.linalg.norm(xy - circ_c, axis=-1) - circ_r)
    circ_inl = (circ_d < cfg.circle_threshold) & mask
    circ_count = jnp.sum(circ_inl.astype(jnp.int32))
    cvalid = cc > 0
    cnear = cvalid & (
        jnp.linalg.norm(center - circ_c, axis=-1) < cfg.param_cluster_tolerance
    ) & (jnp.abs(radius - circ_r) < cfg.param_cluster_tolerance)
    circ_hyp_frac = jnp.sum(cnear.astype(jnp.float32)) / jnp.maximum(
        jnp.sum(cvalid.astype(jnp.float32)), 1.0
    )

    return dict(
        line_votes=lvotes, line_count=line_count, line_inl=line_inl,
        line_n=line_n, line_rho=line_rho, line_hyp_frac=line_hyp_frac,
        circ_votes=cvotes, circ_count=circ_count, circ_inl=circ_inl,
        circ_c=circ_c, circ_r=circ_r, circ_hyp_frac=circ_hyp_frac,
    )


def _classify_size(extents: np.ndarray, cfg: HoughConfig) -> str:
    """tall/medium/short/flat classification (sequential_hough.cpp:3727-3816).

    The reference's formula (smallest/(medium+biggest) < flat_value) also
    fires on tall thin objects (its :1048 comment admits excluding "the
    tall cylinder on the left"); here flat additionally requires the
    *height* to be the small dimension — a pancake, not a pole.  Heights
    compare against tall/medium_value (:187-189)."""
    e = np.asarray(extents, np.float64)
    height = float(e[2])
    footprint = np.sort(e[:2])
    is_smallest = height <= footprint[0] + 1e-9
    if is_smallest and height / max(footprint.sum(), 1e-9) < cfg.flat_value:
        return "flat"
    if height > cfg.tall_value:
        return "tall"
    if height > cfg.medium_value:
        return "medium"
    return "short"


# ---------------------------------------------------------------------------
# hypothesis gates


@partial(jax.jit, static_argnums=(4,))
def _clustering_gate(xyz, inl, planar, tol, want_planar):
    """ClusteringFeatureForLines/Circles (sequential_hough.cpp:662-1255):
    euclidean-cluster the candidate's inliers; per cluster count the points
    whose curvature matches the model family (planar for lines, circular
    for circles); keep the cluster with the most matching curvatures.

    ``tol`` is traced (data-adaptive — see HoughConfig.clustering_spacing_
    multiplier), so per-scene tolerances don't retrigger compilation.

    Returns (kept_mask, n_match_best): kept_mask is the winning cluster's
    members (all False when no cluster), n_match_best its matching-
    curvature count (the reference rejects the model when ≤ 1)."""
    n = xyz.shape[0]
    labels = euclidean_cluster(xyz, inl, tol)
    match = planar if want_planar else ~planar
    w = (inl & match).astype(jnp.int32)
    counts = jnp.zeros((n + 1,), jnp.int32).at[labels].add(w)
    counts = counts.at[n].set(0)
    best = jnp.argmax(counts)
    kept = (labels == best) & inl
    return kept, counts[best]


def _line_refit(xy, sel):
    """LS line on the selected points (adjustLineModel at half threshold:
    the reference refits with SACMODEL_LINE on the curvature-consistent
    subset).  Returns (normal (2,), rho, ok)."""
    w = sel.astype(jnp.float32)
    wsum = jnp.maximum(jnp.sum(w), 1e-9)
    mean = jnp.sum(xy * w[:, None], axis=0) / wsum
    d = (xy - mean) * w[:, None]
    cov = d.T @ d / wsum
    a, b, c = cov[0, 0], cov[0, 1], cov[1, 1]
    theta = 0.5 * jnp.arctan2(2.0 * b, a - c)
    direc = jnp.stack([jnp.cos(theta), jnp.sin(theta)])
    nrm = jnp.stack([-direc[1], direc[0]])
    rho = jnp.sum(nrm * mean)
    flip = jnp.where(rho < 0, -1.0, 1.0)
    return nrm * flip, jnp.abs(rho), jnp.sum(sel) >= 2


def _circle_refit(xy, sel):
    """Kåsa algebraic LS circle on the selected points (adjustCircleModel).
    Returns (center (2,), radius, ok)."""
    w = sel.astype(jnp.float32)
    wsum = jnp.maximum(jnp.sum(w), 1e-9)
    mean = jnp.sum(xy * w[:, None], axis=0) / wsum
    u = (xy - mean) * w[:, None]
    Suu = jnp.sum(u[:, 0] * u[:, 0])
    Svv = jnp.sum(u[:, 1] * u[:, 1])
    Suv = jnp.sum(u[:, 0] * u[:, 1])
    Suuu = jnp.sum(u[:, 0] ** 3)
    Svvv = jnp.sum(u[:, 1] ** 3)
    Suvv = jnp.sum(u[:, 0] * u[:, 1] ** 2)
    Svuu = jnp.sum(u[:, 1] * u[:, 0] ** 2)
    A = jnp.array([[Suu, Suv], [Suv, Svv]])
    rhs = 0.5 * jnp.array([Suuu + Suvv, Svvv + Svuu])
    det = A[0, 0] * A[1, 1] - A[0, 1] * A[1, 0]
    ok = jnp.abs(det) > 1e-12
    Ainv = jnp.array([[A[1, 1], -A[0, 1]], [-A[1, 0], A[0, 0]]]) / jnp.where(ok, det, 1.0)
    uc = Ainv @ rhs
    center = uc + mean
    r = jnp.sqrt(jnp.maximum(
        jnp.sum(uc * uc) + (Suu + Svv) / wsum, 1e-12))
    return center, r, ok & (jnp.sum(sel) >= 3)


def _normal_gate_line(normals_xy, inl, line_n, thresh_deg):
    """NormalFeatureForLines (:1257-1354): keep inliers whose xy-normal is
    ⊥ the line direction within thresh (i.e. parallel to the line normal)."""
    n = normals_xy / jnp.maximum(
        jnp.linalg.norm(normals_xy, axis=-1, keepdims=True), 1e-12)
    # the line direction d: dot(d, np) ≈ 0 ⇔ |dot(line_n, np)| ≈ 1
    cosang = jnp.abs(n @ line_n)
    lim = jnp.cos(jnp.deg2rad(thresh_deg))
    return inl & (cosang > lim)


def _normal_gate_circle(xy, normals_xy, inl, center, thresh_deg):
    """NormalFeatureForCircles (:1356-1455): radial xy-normals."""
    c2p = xy - center
    c2p = c2p / jnp.maximum(jnp.linalg.norm(c2p, axis=-1, keepdims=True), 1e-12)
    n = normals_xy / jnp.maximum(
        jnp.linalg.norm(normals_xy, axis=-1, keepdims=True), 1e-12)
    cosang = jnp.abs(jnp.sum(c2p * n, axis=-1))
    lim = jnp.cos(jnp.deg2rad(thresh_deg))
    return inl & (cosang > lim)


def _point_features(cloud: PointCloud, cfg: HoughConfig):
    """Curvature + xy-normals + RSD r_min channels for the gate machinery
    (the reference's smoothing→normals→RSD preamble, :1815-2185)."""
    from mapping_private_tpu.features.rsd import rsd_radii
    from mapping_private_tpu.ops.normals import estimate_normals

    from mapping_private_tpu.ops.neighbors import knn_bruteforce

    if "normal" in cloud.channels and "curvature" in cloud.channels:
        cloud_n = cloud  # MLS preamble already attached smoothed features
    else:
        cloud_n = estimate_normals(cloud, k=cfg.normal_search_k)
    normals = cloud_n.channel("normal")
    curvature = cloud_n.channel("curvature")
    xyz = cloud.padded_xyz()
    r_min, _r_max = rsd_radii(
        xyz, cloud.mask, xyz, cloud.mask, normals, normals,
        radius=cfg.rsd_search_radius, k=16,
        plane_radius=cfg.rsd_plane_radius,
    )
    # p90 nearest-neighbor spacing of the live cloud, for the adaptive
    # inlier-clustering tolerance (dead rows sort to +inf, masked out by
    # taking the quantile over live entries only).
    _, sq1 = knn_bruteforce(xyz, xyz, cloud.mask, k=1, exclude_self=True)
    d1 = jnp.sqrt(jnp.maximum(sq1[:, 0], 0.0))
    d1 = jnp.where(cloud.mask, d1, jnp.nan)
    spacing_p90 = jnp.nanpercentile(d1, 90.0)
    return normals[:, :2], curvature, r_min, spacing_p90


def _pca_box_objects(
    xyz: np.ndarray, live: np.ndarray, cfg: HoughConfig,
    accepted_xy: Optional[np.ndarray] = None,
) -> List[HoughSegment]:
    """Deal-with-the-rest-of-the-points pass (:6357-6600): euclidean-
    cluster what remains, fit a PCA oriented box per cluster.

    ``accepted_xy`` ((K, 2) centroids of already-emitted segments) feeds
    the dedup gate: a leftover fragment of a claimed object (its base
    ring, its sensor-shadow rim) must not re-emit as a phantom box.
    Accepted rest clusters join the avoid list themselves (largest
    first), so two shards of one object yield one segment.

    Each cluster first tries a Kåsa circle fit and emits a CYLINDER when
    the footprint is genuinely circular — the cluster-first shape test
    of segmentation_by_voting.cpp:239-320, which keeps the object KIND
    correct when the vote loop ended before claiming a true cylinder."""
    labels = np.asarray(
        euclidean_cluster(jnp.asarray(xyz), jnp.asarray(live),
                          cfg.r_clustering_tolerance)
    )
    out: List[HoughSegment] = []
    n = len(xyz)
    avoid = list(accepted_xy) if accepted_xy is not None else []
    lbls, cnts = np.unique(labels[labels < n], return_counts=True)
    for i in np.argsort(-cnts):  # largest first — dedup favors the body
        lbl, cnt = lbls[i], cnts[i]
        if cnt < cfg.minimum_size_of_r_clusters:
            continue
        sel = labels == lbl
        box = fit_box_pca(jnp.asarray(xyz), jnp.asarray(sel))
        # express height as the z-span for size classes
        zsel = xyz[sel][:, 2]
        ext = np.asarray(box.extents).copy()
        ext_sorted = np.sort(ext)[::-1]
        extents = np.array([ext_sorted[0], ext_sorted[1],
                            float(zsel.max() - zsel.min())])
        if cfg.r_cluster_min_extent > 0 and (
                ext_sorted[1] < cfg.r_cluster_min_extent):
            continue  # sliver (a strip of outliers, not an object)
        cen = xyz[sel][:, :2].mean(0)
        if cfg.r_cluster_dedup_radius > 0 and avoid:
            if np.min(np.linalg.norm(np.asarray(avoid) - cen, axis=1)) \
                    < cfg.r_cluster_dedup_radius:
                continue  # leftover of an already-claimed object
        seg = None
        if cfg.r_cluster_circle_fit:
            c2, r2, okc = _circle_refit(
                jnp.asarray(xyz[:, :2]), jnp.asarray(sel))
            if bool(okc) and cfg.min_radius <= float(r2) <= cfg.max_radius:
                d = np.abs(np.linalg.norm(
                    xyz[sel][:, :2] - np.asarray(c2), axis=1) - float(r2))
                if (d < cfg.circle_threshold).mean() \
                        >= cfg.r_cluster_circle_inlier_fraction:
                    seg = HoughSegment(
                        kind="cylinder",
                        size_class=_classify_size(
                            np.array([2 * float(r2), 2 * float(r2),
                                      extents[2]]), cfg),
                        inliers=sel, num_inliers=int(cnt),
                        cylinder=(np.asarray(c2), float(r2),
                                  float(zsel.min()), float(zsel.max())),
                    )
        if seg is None:
            seg = HoughSegment(
                kind="box",
                size_class=_classify_size(extents, cfg),
                inliers=sel,
                num_inliers=int(cnt),
                box=box,
            )
        out.append(seg)
        avoid.append(cen)
    out.sort(key=lambda s: -s.num_inliers)
    return out


def _significant_plane_pass(
    xyz: np.ndarray, live: np.ndarray, key, cfg: HoughConfig
) -> Tuple[Optional[HoughSegment], np.ndarray]:
    """Significant-plane handling (:2347-3913): RANSAC plane → accept if
    enough inliers → biggest euclidean cluster becomes a planar object."""
    plane, inl = fit_plane_ransac(
        jnp.asarray(xyz), jnp.asarray(live), key,
        threshold=cfg.significant_plane_threshold,
        num_hypotheses=max(cfg.num_hypotheses, 128),
    )
    inl_np = np.asarray(inl) & live
    if int(inl_np.sum()) < cfg.minimum_inliers_of_significant_plane:
        return None, live
    labels = np.asarray(euclidean_cluster(
        jnp.asarray(xyz), jnp.asarray(inl_np),
        cfg.significant_plane_clustering_tolerance,
    ))
    n = len(xyz)
    ok = labels[labels < n]
    if ok.size == 0:
        return None, live
    lbl, cnt = np.unique(ok, return_counts=True)
    best = lbl[np.argmax(cnt)]
    if int(cnt.max()) < cfg.minimum_size_of_significant_plane_cluster:
        return None, live
    sel = labels == best
    box = fit_box_pca(jnp.asarray(xyz), jnp.asarray(sel))
    zsel = xyz[sel][:, 2]
    extents = np.array([
        float(np.sort(np.asarray(box.extents))[::-1][0]),
        float(np.sort(np.asarray(box.extents))[::-1][1]),
        float(zsel.max() - zsel.min()),
    ])
    seg = HoughSegment(
        kind="plane", size_class=_classify_size(extents, cfg),
        inliers=sel, num_inliers=int(sel.sum()), box=box,
    )
    return seg, live & ~sel


def hough_segment(
    cloud: PointCloud,
    key: jax.Array,
    cfg: HoughConfig = HoughConfig(),
    table_z: Optional[float] = None,
) -> List[HoughSegment]:
    """Sequentially extract cuboid/cylinder objects from a tabletop cloud.

    The cloud should already be table-relative (or pass table_z to subtract).
    Returns segments best-first; each claims a disjoint set of points.
    """
    if cfg.mls_smoothing:
        from mapping_private_tpu.ops.mls import mls

        cloud = mls(cloud, search_radius=cfg.smoothing_search_radius)
    xyz = np.asarray(cloud.padded_xyz())
    z_off = float(table_z) if table_z is not None else 0.0
    xy = jnp.asarray(xyz[:, :2])
    xyz_j = jnp.asarray(xyz)
    z = xyz[:, 2] - z_off
    live_np = np.asarray(cloud.mask).copy()

    gates = cfg.use_feature_gates
    if gates:
        normals_xy, curvature, r_min, spacing_p90 = _point_features(cloud, cfg)
        planar = (curvature < cfg.curvature_threshold) & cloud.mask
        planar_np = np.asarray(planar)
        cluster_tol = jnp.maximum(
            jnp.float32(cfg.inliers_clustering_tolerance),
            cfg.clustering_spacing_multiplier
            * jnp.nan_to_num(spacing_p90, nan=0.0),
        )
    else:
        normals_xy = curvature = r_min = None
        planar = planar_np = None
        cluster_tol = None

    segments: List[HoughSegment] = []

    if cfg.significant_plane:
        key, sub = jax.random.split(key)
        seg, live_np = _significant_plane_pass(xyz, live_np, sub, cfg)
        if seg is not None:
            segments.append(seg)

    for it in range(cfg.max_objects):
        live = jnp.asarray(live_np)
        if int(live_np.sum()) < cfg.min_inliers:
            break
        key, sub = jax.random.split(key)
        r = _hough_round(xy, live, sub, cfg)
        lv, cv = int(r["line_votes"]), int(r["circ_votes"])
        lcount, ccount = int(r["line_count"]), int(r["circ_count"])
        if max(lcount, ccount) < cfg.min_inliers:
            break

        # ---------------- line candidate + gates ----------------
        line_inl = r["line_inl"]
        line_n, line_rho = r["line_n"], r["line_rho"]
        valid_line = lcount >= cfg.min_inliers
        if valid_line and gates and cfg.clustering_feature_for_lines:
            kept, n_planar = _clustering_gate(
                xyz_j, line_inl, planar, cluster_tol, True)
            kept_n = int(jnp.sum(kept))
            if int(n_planar) <= 1 or (
                int(n_planar) < cfg.min_matching_curvature_fraction * kept_n
            ):
                valid_line = False
            else:
                line_inl = kept
                # adjust on the planar subset at half threshold
                subset = kept & planar
                nrm2, rho2, okfit = _line_refit(xy, subset)
                if bool(okfit):
                    d2 = jnp.abs(xy @ nrm2 - rho2)
                    half = (d2 < cfg.line_threshold / 2) & subset
                    nrm3, rho3, ok3 = _line_refit(xy, half)
                    if bool(ok3) and int(jnp.sum(half)) >= 2:
                        line_n, line_rho = nrm3, rho3
        if valid_line and gates and cfg.normal_feature_for_lines:
            line_inl = _normal_gate_line(
                normals_xy, line_inl, line_n, cfg.line_normals_angle_threshold
            )
            if int(jnp.sum(line_inl)) == 0:
                valid_line = False
        if valid_line:
            # length-of-line gate on the kept inliers' extent along the line
            direc = jnp.stack([-line_n[1], line_n[0]])
            tproj = xy @ direc
            sel = np.asarray(line_inl)
            if sel.any():
                tv = np.asarray(tproj)[sel]
                lol = float(tv.max() - tv.min())
                if lol < cfg.minimum_line_length or lol > cfg.maximum_line_length:
                    valid_line = False
            else:
                valid_line = False
        line_size = int(np.asarray(line_inl).sum()) if valid_line else 0
        if line_size < cfg.min_inliers:
            valid_line = False

        # ---------------- circle candidate + gates ----------------
        circ_inl = r["circ_inl"]
        circ_c, circ_r = r["circ_c"], r["circ_r"]
        valid_circle = ccount >= cfg.min_inliers
        if valid_circle and cfg.circle_vote_density_min > 0:
            if cv < cfg.circle_vote_density_min * int(live_np.sum()):
                valid_circle = False
        if valid_circle and gates and cfg.clustering_feature_for_circles:
            kept, n_circ = _clustering_gate(
                xyz_j, circ_inl, planar, cluster_tol, False)
            kept_n = int(jnp.sum(kept))
            if int(n_circ) <= 1 or (
                int(n_circ) < cfg.min_matching_curvature_fraction * kept_n
            ):
                valid_circle = False
            else:
                circ_inl = kept
                c2, r2, okc = _circle_refit(xy, kept)
                if bool(okc) and cfg.min_radius <= float(r2) <= cfg.max_radius:
                    d2 = jnp.abs(jnp.linalg.norm(xy - c2, axis=-1) - r2)
                    half = (d2 < cfg.circle_threshold / 2) & kept
                    c3, r3, ok3 = _circle_refit(xy, half)
                    if bool(ok3) and cfg.min_radius <= float(r3) <= cfg.max_radius:
                        circ_c, circ_r = c3, r3
        if valid_circle and gates:
            # too-many-planar-curvatures: the circle disk must not be a
            # flat region (:4210-4232)
            dcen = np.linalg.norm(xyz[:, :2] - np.asarray(circ_c), axis=1)
            n_planar_in = int(
                (planar_np & live_np & (dcen < float(circ_r) + cfg.circle_threshold)).sum()
            )
            if n_planar_in > cfg.too_many_planar_curvatures:
                valid_circle = False
        if valid_circle and gates and cfg.rsd_feature_for_circles:
            rm = np.asarray(r_min)
            sel = np.asarray(circ_inl)
            plaus = (rm > cfg.low_r_min) & (rm < cfg.high_r_min)
            if sel.any() and plaus[sel].mean() < 0.5:
                valid_circle = False
        if valid_circle and gates and cfg.normal_feature_for_circles:
            circ_inl = _normal_gate_circle(
                xy, normals_xy, circ_inl, circ_c,
                cfg.circle_normals_angle_threshold,
            )
            if int(jnp.sum(circ_inl)) == 0:
                valid_circle = False
        if valid_circle and gates and cfg.circle_side_radiality_fraction > 0:
            side = jnp.linalg.norm(normals_xy, axis=-1) >= 0.5
            cand_side = circ_inl & side
            n_side = int(jnp.sum(cand_side))
            radial = _normal_gate_circle(
                xy, normals_xy, cand_side, circ_c,
                cfg.circle_normals_angle_threshold,
            )
            frac = int(jnp.sum(radial)) / max(n_side, 1)
            if n_side == 0 or frac < cfg.circle_side_radiality_fraction:
                valid_circle = False
        circ_size = int(np.asarray(circ_inl).sum()) if valid_circle else 0
        if circ_size < cfg.min_inliers:
            valid_circle = False

        # --------- decide line vs circle (larger filtered cloud, :4238) ----
        if not valid_line and not valid_circle:
            break
        use_circle = valid_circle and (not valid_line or circ_size >= line_size)

        if use_circle:
            grow = (
                jnp.linalg.norm(xy - circ_c, axis=-1)
                < circ_r + cfg.grow_xy_margin
            ) & jnp.asarray(live_np)
            claimed = np.asarray(grow)
            zi = z[claimed]
            center = np.asarray(circ_c)
            seg_extents = np.array(
                [2 * float(circ_r), 2 * float(circ_r),
                 zi.max() - max(zi.min(), 0.0)]
            )
            seg = HoughSegment(
                kind="cylinder",
                size_class=_classify_size(seg_extents, cfg),
                inliers=claimed,
                num_inliers=int(claimed.sum()),
                cylinder=(center, float(circ_r), float(zi.min()), float(zi.max())),
                votes=cv,
            )
        else:
            # grow the full connected object from the line-corridor seed
            # (the reference's region-grow of winner inliers, :2827-2900)
            line_d = jnp.abs(xy @ line_n - line_rho)
            seeds = (line_d < cfg.line_threshold + cfg.grow_xy_margin) & jnp.asarray(live_np)
            labels = region_grow(
                xyz_j, jnp.asarray(live_np), radius=cfg.grow_xy_margin * 2,
                seed_mask=seeds,
            )
            # an infinite 2D line seeds every object it crosses — keep only
            # the region holding the most line inliers (the reference
            # clusters line inliers and keeps the winning cluster, :2827+)
            lab = np.asarray(labels)
            n_cap = labels.shape[0]
            seeded = lab < n_cap
            if seeded.any():
                seed_np = np.asarray(line_inl)
                counts = np.bincount(
                    lab[seeded & seed_np], minlength=n_cap + 1
                )
                best_region = int(counts.argmax())
                claimed = lab == best_region
            else:
                claimed = np.asarray(seeds)
            sel = jnp.asarray(claimed)
            box = fit_box_zup(xyz_j, sel)
            extents = np.asarray(box.extents)
            seg = HoughSegment(
                kind="cuboid",
                size_class=_classify_size(extents, cfg),
                inliers=claimed,
                num_inliers=int(claimed.sum()),
                box=box,
                votes=lv,
            )
        if seg.num_inliers < cfg.min_inliers:
            break
        segments.append(seg)
        live_np = live_np & ~seg.inliers

    # Rest-of-points pass runs after the hough loop regardless of how it
    # ended (break or max_objects exhausted) — the reference's
    # deal_with_the_rest_of_the_points sits after the while loop
    # (sequential_hough.cpp:6357).
    if cfg.deal_with_the_rest_of_the_points and live_np.any():
        acc = [xyz[s.inliers][:, :2].mean(0) for s in segments
               if s.inliers is not None and s.inliers.any()]
        segments.extend(_pca_box_objects(
            xyz, live_np, cfg,
            accepted_xy=np.asarray(acc) if acc else None))
    return segments

def hough_mark_classes(cloud: PointCloud, segments: List[HoughSegment]) -> np.ndarray:
    """Per-point class marks — `hough_classification`'s marked output cloud
    (hough_segmentation/src/hough_classification.cpp:4294-4599: the marked
    working cloud's intensity is set to 3 for flat boxes, 2 for upright
    boxes, 4 for cylinders; unclaimed points stay 0).

    Returns (N,) int32 aligned with the cloud's rows; save with
    save_pcd({"xyz": ..., "intensity": marks}) for the reference's marked
    PCD artifact."""
    marks = np.zeros((cloud.capacity,), np.int32)
    for s in segments:
        if s.kind == "cylinder":
            v = 4
        elif s.size_class == "flat":
            v = 3
        else:
            v = 2
        marks[s.inliers] = v
    return marks


# ---------------------------------------------------------------------------
# segmentation-by-voting: cluster-first per-object model voting
# (hough_segmentation/src/segmentation_by_voting.cpp — structurally distinct
# from sequential_hough: the scene is euclidean-clustered into object
# candidates FIRST (:876-940), then each cluster gets its own Hough
# line/circle vote (:971-2523) and is classified whole as a cylinder or a
# box; cylinder dimensions are logged to a sizes table
# ("cylinder-sizes-hough-ransac.txt", :423-445).  The
# using_{lines,circles}_for_segmentation_by_voting.cpp siblings are this
# flow restricted to one model family — covered by the allow_* switches.)


@dataclasses.dataclass(frozen=True)
class VotingConfig:
    """Defaults cite segmentation_by_voting.cpp:77-123."""

    # statistical outlier filter (:79-80)
    mean_k_filter: int = 25
    std_dev_filter: float = 1.0
    # MLS smoothing preamble for real Kinect scans — without it sensor
    # noise corrupts the RSD r_min estimates the rsd_feature gate reads
    # (the sequential recipes run smoothing_search_radius 0.020,
    # readme/sequential_hough:1-5; same practice applies here)
    mls_smoothing: bool = False
    smoothing_search_radius: float = 0.020
    # scene → object clusters (:85-86)
    clustering_tolerance_of_objects: float = 0.025
    minimum_size_of_objects_clusters: int = 100
    # per-cluster model voting (:92-104)
    line_threshold: float = 0.010
    circle_threshold: float = 0.010
    voting_threshold: float = 0.25  # winning-model hypothesis share (:94)
    minimum_radius: float = 0.010
    maximum_radius: float = 0.100
    minimum_line_inliers: int = 10
    minimum_circle_inliers: int = 50
    num_hypotheses: int = 512
    param_cluster_tolerance: float = 0.025  # :123
    # feature gates (:106-122).  Executed semantics (:1246-1560): each
    # gate first rejects when the surviving inlier count is already below
    # minimum_circle_inliers, then PRUNES the inlier set — curvature keeps
    # curvature > curvature_threshold (:1266), rsd keeps
    # |circle_radius − r_min| < radius_threshold (:1356 — the absolute
    # low/high_r_min band there is commented out), and percentage finally
    # compares survivors against the originally-fitted count (:1517).
    curvature_threshold: float = 0.010
    normal_search_k: int = 16
    rsd_search_radius: float = 0.020
    rsd_plane_radius: float = 0.200
    radius_threshold: float = 0.025  # :114
    curvature_feature: bool = True
    rsd_feature: bool = True
    percentage_feature: bool = True
    circle_percentage: float = 50.0  # :122 — % surviving the gates
    # the line variant carries its own knob
    # (using_lines_for_segmentation_by_voting.cpp:122)
    line_percentage: float = 50.0
    # model-family restriction (using_lines/-circles variants)
    allow_lines: bool = True
    allow_circles: bool = True
    # size classes (shared thresholds with HoughConfig)
    flat_value: float = 0.25
    tall_value: float = 0.75
    medium_value: float = 0.50
    short_value: float = 0.25


def _voting_hough_cfg(cfg: VotingConfig) -> HoughConfig:
    """Static HoughConfig for the shared jitted round (equal values → one
    compile across clusters and calls)."""
    return HoughConfig(
        num_hypotheses=cfg.num_hypotheses,
        line_threshold=cfg.line_threshold,
        circle_threshold=cfg.circle_threshold,
        min_radius=cfg.minimum_radius,
        max_radius=cfg.maximum_radius,
        param_cluster_tolerance=cfg.param_cluster_tolerance,
    )


def segment_by_voting(
    cloud: PointCloud,
    key: jax.Array,
    cfg: VotingConfig = VotingConfig(),
) -> Tuple[List[HoughSegment], List[dict]]:
    """Cluster the scene into objects, then vote a circle/line model per
    cluster and classify it whole (cylinder vs box).

    Returns (segments, sizes): one segment per surviving cluster, plus the
    sizes-table rows (the reference's cylinder-sizes text file — one dict
    per model with kind/radius/height/center or extents).
    """
    from mapping_private_tpu.ops.filters import statistical_outlier_mask

    if cfg.mls_smoothing:
        from mapping_private_tpu.ops.mls import mls

        cloud = mls(cloud, search_radius=cfg.smoothing_search_radius)

    xyz_j = cloud.padded_xyz()
    keep = statistical_outlier_mask(
        xyz_j, cloud.mask, k=cfg.mean_k_filter, alpha=cfg.std_dev_filter
    )
    xyz = np.asarray(xyz_j)
    xy = jnp.asarray(xyz[:, :2])

    hcfg = _voting_hough_cfg(cfg)
    gates = cfg.curvature_feature or cfg.rsd_feature
    if gates:
        pf_cfg = HoughConfig(
            normal_search_k=cfg.normal_search_k,
            curvature_threshold=cfg.curvature_threshold,
            rsd_search_radius=cfg.rsd_search_radius,
            rsd_plane_radius=cfg.rsd_plane_radius,
        )
        _nxy, curvature, r_min, _sp = _point_features(cloud, pf_cfg)
        curvature_np = np.asarray(curvature)
        r_min_np = np.asarray(r_min)
    else:
        curvature_np = r_min_np = None

    labels = np.asarray(
        euclidean_cluster(xyz_j, keep, cfg.clustering_tolerance_of_objects)
    )
    n = cloud.capacity
    segments: List[HoughSegment] = []
    sizes: List[dict] = []
    for lbl, cnt in zip(*np.unique(labels[labels < n], return_counts=True)):
        if cnt < cfg.minimum_size_of_objects_clusters:
            continue
        member = labels == lbl
        member_j = jnp.asarray(member)
        key, sub = jax.random.split(key)
        r = _hough_round(xy, member_j, sub, hcfg)
        zc = xyz[member][:, 2]
        height = float(zc.max() - zc.min())

        # ---- circle decision (whole cluster becomes a cylinder) ----
        accept_circle = False
        circ_r = float(r["circ_r"])
        if cfg.allow_circles:
            fitted = np.asarray(r["circ_inl"])
            n_fitted = int(fitted.sum())
            sel = fitted
            accept_circle = (
                n_fitted >= cfg.minimum_circle_inliers
                and cfg.minimum_radius <= circ_r <= cfg.maximum_radius
                and float(r["circ_hyp_frac"]) >= cfg.voting_threshold
            )
            # sequential pruning gates (reference executed path, :1246-1560)
            if accept_circle and cfg.curvature_feature:
                sel = sel & (curvature_np > cfg.curvature_threshold)
            if accept_circle and cfg.rsd_feature:
                if int(sel.sum()) < cfg.minimum_circle_inliers:
                    accept_circle = False
                else:
                    sel = sel & (
                        np.abs(circ_r - r_min_np) < cfg.radius_threshold
                    )
            if accept_circle:
                n_kept = int(sel.sum())
                if n_kept < cfg.minimum_circle_inliers:
                    accept_circle = False
                elif cfg.percentage_feature:
                    accept_circle = (
                        100.0 * n_kept / n_fitted >= cfg.circle_percentage
                    )

        if accept_circle:
            center = np.asarray(r["circ_c"])
            ext = np.array([2 * circ_r, 2 * circ_r, height])
            seg = HoughSegment(
                kind="cylinder",
                size_class=_classify_size(ext, cfg),
                inliers=member,
                num_inliers=int(cnt),
                cylinder=(center, circ_r, float(zc.min()), float(zc.max())),
                votes=int(r["circ_votes"]),
            )
            sizes.append({
                "kind": "cylinder", "radius": circ_r, "height": height,
                "center": [float(center[0]), float(center[1])],
            })
            segments.append(seg)
            continue

        # ---- line decision (cluster becomes an upright box) ----
        accept_line = False
        if cfg.allow_lines:
            fitted_l = np.asarray(r["line_inl"])
            n_fitted_l = int(fitted_l.sum())
            sel_l = fitted_l
            accept_line = (
                n_fitted_l >= cfg.minimum_line_inliers
                and float(r["line_hyp_frac"]) >= cfg.voting_threshold
            )
            # line inliers should sit on planar (low-curvature) surfaces
            if accept_line and cfg.curvature_feature:
                sel_l = sel_l & (curvature_np < cfg.curvature_threshold)
            if accept_line:
                n_kept_l = int(sel_l.sum())
                if n_kept_l < cfg.minimum_line_inliers:
                    accept_line = False
                elif cfg.percentage_feature:
                    accept_line = (
                        100.0 * n_kept_l / n_fitted_l >= cfg.line_percentage
                    )
        if accept_line:
            box = fit_box_zup(xyz_j, member_j)
            ext = np.asarray(box.extents)
            seg = HoughSegment(
                kind="cuboid", size_class=_classify_size(ext, cfg),
                inliers=member, num_inliers=int(cnt), box=box,
                votes=int(r["line_votes"]),
            )
        else:
            # neither model voted in — still an object cluster (the
            # reference visualizes it unmodeled); PCA box envelope
            box = fit_box_pca(xyz_j, member_j)
            ext = np.asarray(box.extents)
            seg = HoughSegment(
                kind="box", size_class=_classify_size(
                    np.array([*np.sort(ext[:2])[::-1], height]), cfg),
                inliers=member, num_inliers=int(cnt), box=box,
            )
        sizes.append({
            "kind": seg.kind,
            "extents": [float(v) for v in np.asarray(seg.box.extents)],
            "height": height,
        })
        segments.append(seg)

    segments.sort(key=lambda s: -s.num_inliers)
    return segments, sizes


def cylinder_sizes_text(sizes: List[dict]) -> str:
    """Render the sizes table as the reference's cylinder-sizes text file
    (segmentation_by_voting.cpp:423-445 logs one line per accepted model)."""
    lines = []
    for row in sizes:
        if row["kind"] == "cylinder":
            cx, cy = row["center"]
            lines.append(
                f"cylinder radius {row['radius']:.4f} height {row['height']:.4f}"
                f" center {cx:.4f} {cy:.4f}"
            )
        else:
            e = " ".join(f"{v:.4f}" for v in row["extents"])
            lines.append(f"{row['kind']} extents {e} height {row['height']:.4f}")
    return "\n".join(lines) + ("\n" if lines else "")

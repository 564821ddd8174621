"""Layered 3-D reconstruction — the deprecated monolith, JAX-native.

Replaces cloud_algos/deprecated/layered-3d-reconstruction.cpp (2.5k LoC):
slice a room scan into horizontal z-layers, fit 2D lines and circles per
layer (fitOnlyLines :1054), then merge consistent fits across adjacent
layers into boxes (`Line2Box` :1560) and cylinders (`Circle2Cylinder`
:1719).  The modern hough pipeline (models/hough_segmentation.py)
supersedes this, but the layer-merge formulation survives as a cheap
structured-scene reconstructor.

Array formulation: every layer's RANSAC fits run as vmapped hypothesis
batches (fit.ransac); the short merge pass over layer fits is host logic.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from mapping_private_tpu.core.cloud import PointCloud
from mapping_private_tpu.fit.ransac import fit_circle2d_ransac, fit_line2d_ransac


@dataclasses.dataclass(frozen=True)
class LayeredConfig:
    layer_height: float = 0.10
    min_layer_points: int = 60
    line_threshold: float = 0.015
    circle_threshold: float = 0.015
    min_radius: float = 0.02
    max_radius: float = 0.6
    num_hypotheses: int = 256
    min_inliers: int = 40
    # cross-layer merge tolerances
    line_angle_tol: float = 0.15
    line_dist_tol: float = 0.05
    circle_center_tol: float = 0.05
    circle_radius_tol: float = 0.03
    min_layers_per_solid: int = 2


@dataclasses.dataclass
class LayerFit:
    layer: int
    z_lo: float
    z_hi: float
    kind: str  # 'line' | 'circle'
    params: np.ndarray  # line [nx,ny,c] | circle [cx,cy,r]
    num_inliers: int
    span: Optional[np.ndarray] = None  # line endpoints (2,2)


@dataclasses.dataclass
class Solid:
    kind: str  # 'box' | 'cylinder'
    z_lo: float
    z_hi: float
    params: dict
    layers: List[int] = dataclasses.field(default_factory=list)


def _fit_layer(xy, mask, key, cfg) -> List[LayerFit]:
    fits = []
    kl, kc = jax.random.split(key)
    line, l_inl = fit_line2d_ransac(
        xy, mask, kl, num_hypotheses=cfg.num_hypotheses,
        threshold=cfg.line_threshold,
    )
    n_l = int(jnp.sum(l_inl.astype(jnp.int32)))
    circle, c_inl = fit_circle2d_ransac(
        xy, mask, kc, num_hypotheses=cfg.num_hypotheses,
        threshold=cfg.circle_threshold,
        min_radius=cfg.min_radius, max_radius=cfg.max_radius,
    )
    n_c = int(jnp.sum(c_inl.astype(jnp.int32)))
    out = []
    if n_l >= cfg.min_inliers:
        pts = np.asarray(xy)[np.asarray(l_inl)]
        t = np.array([-float(line[1]), float(line[0])])
        proj = pts @ t
        lo, hi = pts[proj.argmin()], pts[proj.argmax()]
        out.append(("line", np.asarray(line), n_l, np.stack([lo, hi])))
    if n_c >= cfg.min_inliers:
        out.append(("circle", np.asarray(circle), n_c, None))
    return out


def layered_reconstruction(
    cloud: PointCloud,
    key: jax.Array,
    cfg: LayeredConfig = LayeredConfig(),
) -> List[Solid]:
    """Slice → per-layer 2D fits → merge adjacent consistent fits."""
    xyz = np.asarray(cloud.xyz)
    live = np.asarray(cloud.mask)
    z = xyz[:, 2]
    z_min = float(z[live].min()) if live.any() else 0.0
    z_max = float(z[live].max()) if live.any() else 0.0
    n_layers = max(1, int(np.ceil((z_max - z_min) / cfg.layer_height)))

    layer_fits: List[LayerFit] = []
    xy_dev = jnp.asarray(xyz[:, :2])
    for li in range(n_layers):
        lo = z_min + li * cfg.layer_height
        hi = lo + cfg.layer_height
        m = live & (z >= lo) & (z < hi)
        if m.sum() < cfg.min_layer_points:
            continue
        key, sub = jax.random.split(key)
        for kind, params, n_in, span in _fit_layer(
            xy_dev, jnp.asarray(m), sub, cfg
        ):
            layer_fits.append(LayerFit(li, lo, hi, kind, params, n_in, span))

    # merge pass (Line2Box / Circle2Cylinder): stack compatible fits of the
    # same kind across consecutive layers
    solids: List[Solid] = []
    used = set()
    for i, f in enumerate(layer_fits):
        if i in used:
            continue
        stack = [f]
        used.add(i)
        for j in range(i + 1, len(layer_fits)):
            if j in used:
                continue
            g = layer_fits[j]
            if g.kind != f.kind or g.layer != stack[-1].layer + 1:
                continue
            if f.kind == "line":
                cos = abs(float(np.dot(f.params[:2], g.params[:2])))
                d = abs(float(f.params[2]) - float(g.params[2]) * np.sign(
                    np.dot(f.params[:2], g.params[:2]) or 1.0))
                if cos >= np.cos(cfg.line_angle_tol) and d <= cfg.line_dist_tol:
                    stack.append(g)
                    used.add(j)
            else:
                dc = float(np.linalg.norm(f.params[:2] - g.params[:2]))
                dr = abs(float(f.params[2]) - float(g.params[2]))
                if dc <= cfg.circle_center_tol and dr <= cfg.circle_radius_tol:
                    stack.append(g)
                    used.add(j)
        if len(stack) < cfg.min_layers_per_solid:
            continue
        z_lo, z_hi = stack[0].z_lo, stack[-1].z_hi
        if f.kind == "circle":
            cs = np.stack([s.params for s in stack])
            solids.append(Solid(
                kind="cylinder", z_lo=z_lo, z_hi=z_hi,
                params=dict(center=cs[:, :2].mean(0).tolist(),
                            radius=float(cs[:, 2].mean())),
                layers=[s.layer for s in stack],
            ))
        else:
            spans = np.concatenate([s.span for s in stack if s.span is not None])
            n2 = stack[0].params[:2]
            t = np.array([-n2[1], n2[0]])
            proj = spans @ t
            solids.append(Solid(
                kind="box", z_lo=z_lo, z_hi=z_hi,
                params=dict(
                    normal=n2.tolist(), offset=float(stack[0].params[2]),
                    endpoints=[spans[proj.argmin()].tolist(),
                               spans[proj.argmax()].tolist()],
                ),
                layers=[s.layer for s in stack],
            ))
    return solids

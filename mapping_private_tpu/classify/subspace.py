"""Per-class subspace classification — `color_feature_classification` JAX-native.

Replaces the offline benchmark harness's subspace method
(color_feature_classification/test/computeSubspace_from_file.cpp trains a
PCA per object class; test_classify_from_file.cpp classifies a query
feature by the largest norm of its projection onto each class subspace —
the same ‖axis_q·f‖/‖f‖ similarity as the sliding-box detector).

All classes are scored at once: stack the per-class projection matrices
into one (C, M, D) tensor and evaluate every query against every class
with a single einsum.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from mapping_private_tpu.recognition.pca import pca_fit, subspace_axis


@dataclasses.dataclass
class SubspaceClassifier:
    """axes: (C, M, D) per-class subspace projections; labels: (C,)."""

    axes: np.ndarray
    labels: np.ndarray


def train_subspaces(
    features_per_class: Sequence[np.ndarray],
    dim_subspace: int,
    labels: Optional[Sequence[int]] = None,
    multiple_similarity: bool = False,
) -> SubspaceClassifier:
    """Fit one PCA subspace per class (computeSubspace_from_file.cpp).

    features_per_class: list of (N_c, D) arrays (N_c may differ).
    """
    axes = []
    for f in features_per_class:
        p = pca_fit(jnp.asarray(np.asarray(f, np.float32)))
        axes.append(subspace_axis(p, dim_subspace, multiple_similarity))
    lab = np.asarray(
        labels if labels is not None else range(len(features_per_class)),
        np.int32,
    )
    return SubspaceClassifier(axes=np.stack(axes), labels=lab)


def classify_subspace(
    clf: SubspaceClassifier, features: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """Classify (N, D) features.

    Returns (labels (N,), similarities (N, C)) where similarity =
    ‖W_c f‖ / ‖f‖ (test_classify_from_file.cpp projection score).
    """
    f = jnp.asarray(features, jnp.float32)
    W = jnp.asarray(clf.axes, jnp.float32)  # (C, M, D)
    proj = jnp.einsum("cmd,nd->ncm", W, f)  # one batched matmul
    num = jnp.linalg.norm(proj, axis=-1)  # (N, C)
    den = jnp.maximum(jnp.linalg.norm(f, axis=-1, keepdims=True), 1e-20)
    sim = num / den
    best = jnp.argmax(sim, axis=-1)
    return jnp.asarray(clf.labels)[best], sim

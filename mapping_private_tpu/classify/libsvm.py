"""libsvm-compatible batched SVM prediction — `SVMClassification` JAX-native.

Replaces cloud_algos/src/svm_classification.cpp: the reference loads a
libsvm model (:80-88), optionally min-max scales features — self-computed
or from a `.scp` file (:92-112, parseScaleParameterFile) — then calls
`svm_predict` per point in a serial loop (:134-156).

Here the model file (the repo bundles 18 trained models under
cloud_algos/svm/*.model) is parsed into dense arrays and the whole cloud
is classified at once: the RBF kernel matrix K(X, SV) is one matmul
(‖x‖² + ‖s‖² − 2x·sᵀ), the one-vs-one decision values are a second
matmul with the sv_coef matrix, and voting is a scatter-add — no
per-point loop, no svm_node pointer chasing.

Also reads the vendored libsvm fork's models
(color_feature_classification/src/libsvm_and_linear/libsvm_asako) —
same format.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

_KERNELS = ("linear", "polynomial", "rbf", "sigmoid", "precomputed")


@dataclasses.dataclass
class SVMModel:
    svm_type: str
    kernel: str
    gamma: float
    coef0: float
    degree: int
    labels: np.ndarray  # (C,)
    nr_sv: np.ndarray  # (C,) SV count per class
    rho: np.ndarray  # (C*(C-1)/2,)
    sv_coef: np.ndarray  # (C-1, L) dual coefficients
    support_vectors: np.ndarray  # (L, D) dense

    @property
    def nr_class(self) -> int:
        return len(self.labels)


def load_libsvm_model(path: str) -> SVMModel:
    """Parse a libsvm text model (svm_load_model format)."""
    header: Dict[str, list] = {}
    sv_lines = []
    with open(path) as fp:
        in_sv = False
        for line in fp:
            line = line.strip()
            if not line:
                continue
            if in_sv:
                sv_lines.append(line)
            elif line == "SV":
                in_sv = True
            else:
                key, *vals = line.split()
                header[key] = vals
    svm_type = header.get("svm_type", ["c_svc"])[0]
    kernel = header.get("kernel_type", ["rbf"])[0]
    gamma = float(header.get("gamma", [0.0])[0])
    coef0 = float(header.get("coef0", [0.0])[0])
    degree = int(header.get("degree", [3])[0])
    nr_class = int(header["nr_class"][0])
    total_sv = int(header["total_sv"][0])
    labels = np.asarray(header.get("label", range(nr_class)), dtype=np.int32)
    nr_sv = np.asarray(header.get("nr_sv", [total_sv]), dtype=np.int32)
    rho = np.asarray(header["rho"], dtype=np.float64)

    n_coef = nr_class - 1 if nr_class > 1 else 1
    sv_coef = np.zeros((n_coef, total_sv), np.float64)
    rows = []
    max_idx = 0
    for li, line in enumerate(sv_lines):
        parts = line.split()
        for c in range(n_coef):
            sv_coef[c, li] = float(parts[c])
        feat = {}
        for tok in parts[n_coef:]:
            i, v = tok.split(":")
            feat[int(i)] = float(v)
            max_idx = max(max_idx, int(i))
        rows.append(feat)
    svs = np.zeros((total_sv, max_idx), np.float32)
    for li, feat in enumerate(rows):
        for i, v in feat.items():
            svs[li, i - 1] = v
    return SVMModel(
        svm_type=svm_type, kernel=kernel, gamma=gamma, coef0=coef0,
        degree=degree, labels=labels, nr_sv=nr_sv, rho=rho,
        sv_coef=sv_coef, support_vectors=svs,
    )


def load_scale_params(path: str) -> Tuple[float, float, np.ndarray]:
    """Parse a `.scp` svm-scale restore file (parseScaleParameterFile):
    line 'x', then 'lower upper', then 'index fmin fmax' rows.

    Returns (lower, upper, ranges (D, 2)) — rows absent from the file keep
    (0, 0), meaning "do not scale" (matches svm-scale semantics).
    """
    with open(path) as fp:
        lines = [l.strip() for l in fp if l.strip()]
    assert lines[0].startswith("x"), "only x-scaling .scp files supported"
    lower, upper = (float(v) for v in lines[1].split())
    entries = [tuple(l.split()) for l in lines[2:]]
    max_idx = max(int(e[0]) for e in entries)
    ranges = np.zeros((max_idx, 2), np.float64)
    for idx, lo, hi in entries:
        ranges[int(idx) - 1] = (float(lo), float(hi))
    return lower, upper, ranges


def scale_features(
    x: jax.Array, lower: float, upper: float, ranges: np.ndarray
) -> jax.Array:
    """Min-max scale (svm_classification.cpp scaleFeature): features with
    fmin == fmax pass through unscaled."""
    d = min(x.shape[-1], len(ranges))
    fmin = jnp.asarray(ranges[:d, 0], x.dtype)
    fmax = jnp.asarray(ranges[:d, 1], x.dtype)
    span = fmax - fmin
    ok = span != 0
    scaled = lower + (upper - lower) * (x[..., :d] - fmin) / jnp.where(ok, span, 1.0)
    out = jnp.where(ok, scaled, x[..., :d])
    if x.shape[-1] > d:
        out = jnp.concatenate([out, x[..., d:]], axis=-1)
    return out


def _kernel_matrix(model: SVMModel, x: jax.Array, sv: jax.Array) -> jax.Array:
    """(N, D), (L, D) → (N, L)."""
    if model.kernel == "linear":
        return x @ sv.T
    if model.kernel == "rbf":
        x2 = jnp.sum(x * x, -1, keepdims=True)
        s2 = jnp.sum(sv * sv, -1, keepdims=True).T
        d2 = jnp.maximum(x2 + s2 - 2.0 * (x @ sv.T), 0.0)
        return jnp.exp(-model.gamma * d2)
    if model.kernel == "polynomial":
        return (model.gamma * (x @ sv.T) + model.coef0) ** model.degree
    if model.kernel == "sigmoid":
        return jnp.tanh(model.gamma * (x @ sv.T) + model.coef0)
    raise ValueError(f"unsupported kernel {model.kernel}")


def svm_decision_values(model: SVMModel, x: jax.Array) -> jax.Array:
    """One-vs-one decision values (N, C*(C-1)/2), libsvm pair order."""
    C = model.nr_class
    sv = jnp.asarray(model.support_vectors)
    d = x.shape[-1]
    L = sv.shape[-1]
    if d < L:
        x = jnp.pad(x, ((0, 0), (0, L - d)))
    elif d > L:
        x = x[:, :L]
    K = _kernel_matrix(model, x, sv)  # (N, L)
    starts = np.concatenate([[0], np.cumsum(model.nr_sv)])
    coef = jnp.asarray(model.sv_coef, jnp.float32)
    decs = []
    p = 0
    for i in range(C):
        si, ei = starts[i], starts[i + 1]
        for j in range(i + 1, C):
            sj, ej = starts[j], starts[j + 1]
            dec = (
                K[:, si:ei] @ coef[j - 1, si:ei]
                + K[:, sj:ej] @ coef[i, sj:ej]
                - model.rho[p]
            )
            decs.append(dec)
            p += 1
    return jnp.stack(decs, axis=-1)


def svm_predict_batch(model: SVMModel, x: jax.Array) -> jax.Array:
    """Batched svm_predict: (N, D) → (N,) predicted labels."""
    C = model.nr_class
    dec = svm_decision_values(model, x)  # (N, P)
    n = x.shape[0]
    votes = jnp.zeros((n, C), jnp.int32)
    p = 0
    for i in range(C):
        for j in range(i + 1, C):
            win_i = dec[:, p] > 0
            votes = votes.at[:, i].add(win_i.astype(jnp.int32))
            votes = votes.at[:, j].add((~win_i).astype(jnp.int32))
            p += 1
    best = jnp.argmax(votes, axis=-1)
    return jnp.asarray(model.labels)[best]

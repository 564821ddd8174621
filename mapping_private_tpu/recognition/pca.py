"""PCA subspace learning — `color_voxel_recognition/src/pca.cpp` JAX-native.

The reference accumulates a correlation matrix feature-by-feature
(PCA::addData, pca.cpp:48-69), normalizes, optionally subtracts the mean
outer product and adds Tikhonov regularization, then calls Eigen's
`SelfAdjointEigenSolver` and sorts eigenpairs descending (PCA::solve
:73-107).  Object subspaces take the leading `dim_model` eigenvectors,
optionally scaled by sqrt(variance ratio) ("multiple similarity",
search.cpp readAxis :153-165).

Here the whole batch is one `FᵀF` matmul + `jnp.linalg.eigh`.
File I/O matches the reference's binary/ascii format bit-for-bit
(pca.cpp read :128-185 / write :189-243) so subspaces learned by either
implementation interchange.
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass
class PCAResult:
    """axis: (D, D) columns = eigenvectors, descending eigenvalue order;
    variance: (D,) descending; mean: (D,) or None."""

    axis: np.ndarray
    variance: np.ndarray
    mean: Optional[np.ndarray] = None


def pca_fit(
    features: jax.Array,
    mask: Optional[jax.Array] = None,
    mean_flg: bool = False,
    regularization: float = 0.0,
) -> PCAResult:
    """PCA over (N, D) feature rows (masked), eigenpairs descending.

    Matches PCA::solve: correlation = FᵀF/n (optionally − mean·meanᵀ),
    + regularization·I, then symmetric eigendecomposition.
    """
    f = jnp.asarray(features, jnp.float32)
    n, d = f.shape
    if mask is not None:
        f = f * mask.astype(f.dtype)[:, None]
        cnt = jnp.maximum(jnp.sum(mask.astype(jnp.float32)), 1.0)
    else:
        cnt = jnp.float32(n)
    corr = (f.T @ f) / cnt
    mean = jnp.sum(f, axis=0) / cnt
    if mean_flg:
        corr = corr - jnp.outer(mean, mean)
    if regularization:
        corr = corr + regularization * jnp.eye(d, dtype=corr.dtype)
    vals, vecs = jnp.linalg.eigh(corr)  # ascending
    order = jnp.argsort(-vals)
    vals = vals[order]
    vecs = vecs[:, order]
    return PCAResult(
        axis=np.asarray(vecs),
        variance=np.asarray(vals),
        mean=np.asarray(mean) if mean_flg else None,
    )


def subspace_axis(
    pca: PCAResult, dim_model: int, multiple_similarity: bool = False
) -> np.ndarray:
    """axis_q (dim_model, D): leading eigenvectors transposed, rows
    optionally scaled by sqrt(var_i/var_0) (readAxis :159-164)."""
    axis_q = pca.axis[:, :dim_model].T.copy()
    if multiple_similarity:
        scale = np.sqrt(
            np.maximum(pca.variance[:dim_model], 0.0)
            / max(float(pca.variance[0]), 1e-30)
        )
        axis_q = axis_q * scale[:, None]
    return axis_q.astype(np.float32)


def write_pca(path: str, pca: PCAResult, ascii_fmt: bool = False) -> None:
    """Reference-compatible PCA file (pca.cpp PCA::write :189-243)."""
    d = int(len(pca.variance))
    if ascii_fmt:
        with open(path, "w") as fp:
            fp.write(f"{d}\n")
            for i in range(d):
                fp.write(" ".join(f"{pca.axis[j, i]:f}" for j in range(d)) + " \n")
            for i in range(d):
                fp.write(f"{pca.variance[i]:f}\n")
            if pca.mean is not None:
                for i in range(d):
                    fp.write(f"{pca.mean[i]:f}\n")
    else:
        with open(path, "wb") as fp:
            fp.write(struct.pack("<i", d))
            # eigenvector i written contiguously (column i of axis)
            fp.write(pca.axis.T.astype("<f4").tobytes())
            fp.write(np.asarray(pca.variance, "<f4").tobytes())
            if pca.mean is not None:
                fp.write(np.asarray(pca.mean, "<f4").tobytes())


def read_pca(path: str, ascii_fmt: bool = False) -> PCAResult:
    """Reference-compatible PCA reader (pca.cpp PCA::read :128-185)."""
    if ascii_fmt:
        with open(path) as fp:
            tokens = fp.read().split()
        d = int(tokens[0])
        vals = np.asarray(tokens[1:], dtype=np.float32)
    else:
        raw = open(path, "rb").read()
        d = struct.unpack("<i", raw[:4])[0]
        vals = np.frombuffer(raw[4:], dtype="<f4")
    axis = vals[: d * d].reshape(d, d).T.copy()  # stored per-eigenvector
    variance = vals[d * d : d * d + d].copy()
    rest = vals[d * d + d :]
    mean = rest[:d].copy() if len(rest) >= d else None
    return PCAResult(axis=axis, variance=variance, mean=mean)


def variance_report(
    pca: PCAResult,
    dim: "int | None" = None,
    contrib_dim: "int | None" = None,
    contrib_rate: "float | None" = None,
):
    """Subspace eigenvalue inspection — the `variance_show` tool
    (color_voxel_recognition/test/variance_show.cpp:49-98).

    - default: the first ``dim`` eigenvalues (the tool prints one per line);
    - ``contrib_dim=d`` (the tool's -d): the accumulative contribution
      rate Σ variance[:d] / Σ variance[:dim];
    - ``contrib_rate=c`` (the tool's -c): the first 0-based index whose
      accumulative rate reaches ``c`` (``dim`` when never reached).
    """
    v = np.maximum(np.asarray(pca.variance, np.float64), 0.0)
    if dim is None:
        dim = len(v)
    v = v[:dim]
    if contrib_dim is not None:
        return float(v[:contrib_dim].sum() / max(v.sum(), 1e-300))
    if contrib_rate is not None:
        c = np.cumsum(v) / max(v.sum(), 1e-300)
        hit = np.nonzero(c >= contrib_rate)[0]
        return int(hit[0]) if len(hit) else dim
    return v

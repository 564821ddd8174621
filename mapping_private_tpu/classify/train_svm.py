"""Kernel C-SVC training — the `libsvm_asako` training capability.

The reference vendors a libsvm fork and trains RBF one-vs-one SVMs
(color_feature_classification/src/libsvm_and_linear/libsvm_asako/libSVM.cpp,
scripts/svm/train_svm.sh); the 18 bundled models under cloud_algos/svm/
were produced that way.  This module makes those models reproducible.

Array formulation: libsvm's dual problem per class pair —

    min_a  ½ aᵀQa − eᵀa,   0 ≤ a_i ≤ C,  yᵀa = 0,  Q_ij = y_i y_j K_ij

— solved by SMO with maximal-violating-pair working-set selection
(Keerthi et al.; libSVM.cpp Solver::select_working_set).  The kernel
matrix is precomputed (one matmul per pair), each SMO step is O(n)
vector work inside `lax.while_loop`, and ALL C·(C−1)/2 one-vs-one
subproblems run as a single `vmap` over padded per-pair datasets — the
63-object corpus trains 1,953 pairs in one traced program instead of the
reference's serial `svm_train` loop.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mapping_private_tpu.classify.libsvm import SVMModel


def rbf_kernel(x: jax.Array, z: jax.Array, gamma: float) -> jax.Array:
    x2 = jnp.sum(x * x, -1, keepdims=True)
    z2 = jnp.sum(z * z, -1, keepdims=True).T
    d2 = jnp.maximum(x2 + z2 - 2.0 * (x @ z.T), 0.0)
    return jnp.exp(-gamma * d2)


def _smo(Q: jax.Array, y: jax.Array, valid: jax.Array, C: float,
         tol: float, max_iter: int
         ) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Single binary C-SVC dual solve on a padded problem.

    Q: (n, n) = y_i y_j K_ij with padded rows/cols zeroed via ``valid``.
    Returns (alpha (n,), rho (), final KKT gap (), iterations ()).
    Padded lanes keep alpha = 0.  Callers should treat gap >= tol at exit
    as non-convergence (libsvm's own iteration cap is far higher).
    """
    n = Q.shape[0]
    big = jnp.float32(1e30)

    def cond(state):
        alpha, G, it, gap = state
        return (it < max_iter) & (gap >= tol)

    def body(state):
        alpha, G, it, _ = state
        yG = -y * G
        # I_up: y=+1 & a<C  or  y=-1 & a>0 ; I_low: y=+1 & a>0 or y=-1 & a<C
        up = valid & (((y > 0) & (alpha < C)) | ((y < 0) & (alpha > 0)))
        low = valid & (((y > 0) & (alpha > 0)) | ((y < 0) & (alpha < C)))
        i = jnp.argmax(jnp.where(up, yG, -big))
        j = jnp.argmin(jnp.where(low, yG, big))
        gap = jnp.where(up, yG, -big)[i] - jnp.where(low, yG, big)[j]

        # two-variable analytic update (libSVM.cpp Solver::solve inner step)
        Qii, Qjj, Qij = Q[i, i], Q[j, j], Q[i, j]
        quad = jnp.maximum(Qii + Qjj - 2.0 * y[i] * y[j] * Qij, 1e-12)
        # work in the s = y_i y_j parametrization
        ai, aj, yi, yj = alpha[i], alpha[j], y[i], y[j]
        delta = (-yi * G[i] + yj * G[j]) / quad
        # new alphas along the constraint y·a = const
        ai_new = ai + yi * delta
        aj_new = aj - yj * delta
        # clip to the box, preserving yi·ai + yj·aj
        sum_c = yi * ai + yj * aj
        ai_new = jnp.clip(ai_new, 0.0, C)
        aj_new = yj * (sum_c - yi * ai_new)
        aj_new = jnp.clip(aj_new, 0.0, C)
        ai_new = yi * (sum_c - yj * aj_new)
        ai_new = jnp.clip(ai_new, 0.0, C)
        dai, daj = ai_new - ai, aj_new - aj
        G = G + Q[i] * dai + Q[j] * daj
        alpha = alpha.at[i].set(ai_new).at[j].set(aj_new)
        return (alpha, G, it + 1, gap)

    alpha0 = jnp.zeros((n,), jnp.float32)
    G0 = jnp.full((n,), -1.0)  # G = Qa - e
    alpha, G, it_final, gap_final = jax.lax.while_loop(
        cond, body, (alpha0, G0, jnp.int32(0), jnp.float32(jnp.inf))
    )
    # recompute the gradient from the final alphas in one exact matmul —
    # the incrementally-updated G accumulates f32 drift over thousands of
    # rank-2 updates, which would bias rho below
    G = Q @ alpha - 1.0
    # rho: KKT gives y_i G_i = rho at free SVs (libSVM.cpp calculate_rho —
    # note the sign: G = Qa − e, decision f = Σ y_j a_j K − rho)
    yG = y * G
    free = valid & (alpha > 1e-8) & (alpha < C - 1e-8)
    n_free = jnp.sum(free)
    at_ub = valid & (alpha >= C - 1e-8)
    at_lb = valid & (alpha <= 1e-8)
    ub_set = (at_ub & (y < 0)) | (at_lb & (y > 0))
    lb_set = (at_ub & (y > 0)) | (at_lb & (y < 0))
    ub = jnp.min(jnp.where(ub_set, yG, big))
    lb = jnp.max(jnp.where(lb_set, yG, -big))
    rho_free = jnp.sum(jnp.where(free, yG, 0.0)) / jnp.maximum(n_free, 1)
    rho = jnp.where(n_free > 0, rho_free, (ub + lb) / 2.0)
    return alpha, rho, gap_final, it_final


@dataclasses.dataclass
class OVOSVM:
    """One-vs-one kernel SVM in pairwise (training-set-indexed) form."""
    X: np.ndarray          # (N, D) training features
    labels: np.ndarray     # (N,) int class ids 0..C-1
    pair_idx: np.ndarray   # (P, n_max) int32 indices into X (-1 = pad)
    alpha_y: np.ndarray    # (P, n_max) alpha_i * y_i per pair
    rho: np.ndarray        # (P,)
    pairs: np.ndarray      # (P, 2) class ids (i, j)
    gamma: float
    C: float
    num_classes: int


def train_svc_ovo(
    X: np.ndarray,
    labels: np.ndarray,
    num_classes: int,
    C: float = 1.0,
    gamma: Optional[float] = None,
    tol: float = 1e-3,
    max_iter: int = 20000,
) -> OVOSVM:
    """Train all C·(C−1)/2 RBF one-vs-one subproblems in one vmap.

    gamma defaults to libsvm's 1/num_features.  Pairs are padded to the
    largest pair size (bucketed to a multiple of 8) so one compilation
    serves every pair.
    """
    X = np.asarray(X, np.float32)
    labels = np.asarray(labels)
    if gamma is None:
        gamma = 1.0 / X.shape[1]
    by_class = [np.nonzero(labels == c)[0] for c in range(num_classes)]
    pairs = [(i, j) for i in range(num_classes) for j in range(i + 1, num_classes)]
    n_max = max(len(by_class[i]) + len(by_class[j]) for i, j in pairs)
    n_max = -(-n_max // 8) * 8
    P = len(pairs)
    pair_idx = np.full((P, n_max), -1, np.int32)
    pair_y = np.zeros((P, n_max), np.float32)
    for p, (i, j) in enumerate(pairs):
        idx = np.concatenate([by_class[i], by_class[j]])
        pair_idx[p, : len(idx)] = idx
        pair_y[p, : len(by_class[i])] = 1.0
        pair_y[p, len(by_class[i]) : len(idx)] = -1.0

    Xd = jnp.asarray(X)
    idxd = jnp.asarray(pair_idx)
    yd = jnp.asarray(pair_y)

    @jax.jit
    def solve_all(Xd, idxd, yd):
        def one(idx, y):
            xp = Xd[jnp.maximum(idx, 0)]
            valid = idx >= 0
            K = rbf_kernel(xp, xp, gamma)
            vv = valid[:, None] & valid[None, :]
            Q = jnp.where(vv, (y[:, None] * y[None, :]) * K, 0.0)
            return _smo(Q, y, valid, C, tol, max_iter)

        return jax.vmap(one)(idxd, yd)

    alpha, rho, gaps, iters = solve_all(Xd, idxd, yd)
    gaps, iters = np.asarray(gaps), np.asarray(iters)
    bad = np.nonzero(gaps >= tol)[0]
    if len(bad):
        import warnings
        worst = bad[np.argmax(gaps[bad])]
        warnings.warn(
            f"SMO hit max_iter={max_iter} before convergence on "
            f"{len(bad)}/{P} one-vs-one pairs (worst pair "
            f"{tuple(pairs[worst])}: gap {gaps[worst]:.2e} >= tol {tol:g}); "
            "alphas exported anyway — raise max_iter for exact duals.",
            stacklevel=2,
        )
    alpha = np.array(alpha)
    alpha[pair_idx < 0] = 0.0
    return OVOSVM(
        X=X, labels=labels, pair_idx=pair_idx,
        alpha_y=alpha * np.asarray(pair_y), rho=np.asarray(rho),
        pairs=np.asarray(pairs, np.int32), gamma=gamma, C=C,
        num_classes=num_classes,
    )


def decision_values_ovo(model: OVOSVM, x: jax.Array) -> jax.Array:
    """(M, D) → per-pair decision values (M, P) in model.pairs order —
    the quantity libsvm's svm_predict_values returns (dec > 0 votes for
    the pair's first class).  Exposed for the train-side oracle parity
    check against the reference's vendored fork."""
    x = jnp.asarray(x, jnp.float32)
    P, N = len(model.pairs), model.X.shape[0]
    K = rbf_kernel(x, jnp.asarray(model.X), model.gamma)  # (M, N)
    # per-pair decision: sum over that pair's SVs of alpha_y * K
    ay = np.zeros((P, N), np.float32)
    ok = model.pair_idx >= 0
    rows = np.broadcast_to(np.arange(P)[:, None], model.pair_idx.shape)
    np.add.at(ay, (rows[ok], model.pair_idx[ok]), model.alpha_y[ok])
    return K @ jnp.asarray(ay).T - jnp.asarray(model.rho)[None, :]  # (M, P)


def predict_ovo(model: OVOSVM, x: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """(M, D) → (labels (M,), votes (M, C)). One kernel matmul total;
    the per-pair coefficient scatter and the vote tally are both single
    vectorized scatters (no Python loop over the P = C(C−1)/2 pairs, which
    at the 63-class corpus is 1,953)."""
    x = jnp.asarray(x, jnp.float32)
    dec = decision_values_ovo(model, x)  # (M, P)
    win = (dec > 0).astype(jnp.int32)  # (M, P)
    pi = jnp.asarray(model.pairs[:, 0])
    pj = jnp.asarray(model.pairs[:, 1])
    votes = jnp.zeros((x.shape[0], model.num_classes), jnp.int32)
    votes = votes.at[:, pi].add(win).at[:, pj].add(1 - win)
    return jnp.argmax(votes, axis=-1), votes


def to_libsvm_model(model: OVOSVM) -> SVMModel:
    """Convert to the libsvm model layout (loadable by svm_predict_batch,
    savable by save_libsvm_model) — SVs grouped by class, sv_coef rows per
    libsvm's (C−1, L) convention."""
    N, C = model.X.shape[0], model.num_classes
    # alpha_y per (pair, training sample) in global index space
    P = len(model.pairs)
    ay_global = np.zeros((P, N), np.float64)
    for p in range(P):
        ok = model.pair_idx[p] >= 0
        ay_global[p, model.pair_idx[p][ok]] += model.alpha_y[p][ok]
    is_sv = (np.abs(ay_global).max(axis=0) > 1e-8)
    order = np.argsort(model.labels[is_sv.nonzero()[0]], kind="stable")
    sv_idx = is_sv.nonzero()[0][order]
    L = len(sv_idx)
    nr_sv = np.asarray(
        [int(np.sum(model.labels[sv_idx] == c)) for c in range(C)], np.int32
    )
    # libsvm sv_coef: row r of class c's SVs holds the coef for the pair
    # (c, other) — coef index j-1 when paired with class j>c, i when i<c
    sv_coef = np.zeros((C - 1, L), np.float64)
    pos_of = {int(g): k for k, g in enumerate(sv_idx)}
    for p, (i, j) in enumerate(model.pairs):
        for g in np.nonzero(ay_global[p])[0]:
            k = pos_of[int(g)]
            c = model.labels[g]
            row = j - 1 if c == i else i
            sv_coef[row, k] = ay_global[p, g]
    return SVMModel(
        svm_type="c_svc", kernel="rbf", gamma=model.gamma, coef0=0.0,
        degree=3, labels=np.arange(C, dtype=np.int32), nr_sv=nr_sv,
        rho=model.rho.astype(np.float64),
        sv_coef=sv_coef, support_vectors=model.X[sv_idx],
    )


def save_libsvm_model(model: SVMModel, path: str) -> None:
    """Write the libsvm text format (svm_save_model) so retrained models
    drop in anywhere the bundled cloud_algos/svm/*.model files do."""
    C = model.nr_class
    with open(path, "w") as fp:
        fp.write(f"svm_type {model.svm_type}\n")
        fp.write(f"kernel_type {model.kernel}\n")
        if model.kernel == "polynomial":
            fp.write(f"degree {model.degree}\n")
        if model.kernel in ("rbf", "polynomial", "sigmoid"):
            fp.write(f"gamma {model.gamma:g}\n")
        if model.kernel in ("polynomial", "sigmoid"):
            fp.write(f"coef0 {model.coef0:g}\n")
        fp.write(f"nr_class {C}\n")
        fp.write(f"total_sv {len(model.support_vectors)}\n")
        fp.write("rho " + " ".join(f"{r:.17g}" for r in model.rho) + "\n")
        fp.write("label " + " ".join(str(int(l)) for l in model.labels) + "\n")
        fp.write("nr_sv " + " ".join(str(int(n)) for n in model.nr_sv) + "\n")
        fp.write("SV\n")
        D = model.support_vectors.shape[1] if len(model.support_vectors) else 0
        for k, sv in enumerate(model.support_vectors):
            coefs = " ".join(f"{model.sv_coef[r, k]:.17g}" for r in range(C - 1))
            # Sparse like libsvm, but always emit the LAST feature index so
            # a dimension that happens to be zero in every SV can't shrink
            # the loader's inferred dimensionality (which would silently
            # truncate query vectors and drop their x_d² term from the RBF
            # distance).
            feats = " ".join(
                f"{i + 1}:{v:.8g}"
                for i, v in enumerate(sv)
                if v != 0.0 or i == D - 1
            )
            fp.write(f"{coefs} {feats} \n")

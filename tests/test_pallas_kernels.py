"""GPU NN kernel in interpret mode (CPU) — exactness against float64
numpy, its padding and split passes, the lowering for the GPU, and the
one platform decision that picks it."""
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import export
from scipy.spatial import cKDTree

from mapping_private_tpu.core.cloud import PAD_COORD
from mapping_private_tpu.ops import nn_dispatch, pallas_nn
from mapping_private_tpu.ops.neighbors import knn_bruteforce
from mapping_private_tpu.ops.pallas_nn import (
    nn_argmin_prepared,
    prepare_nn_ref_argmin,
)
from mapping_private_tpu.registration.icp import icp_point_to_plane

REPO = pathlib.Path(__file__).resolve().parents[1]


def _pair(nq=300, nr=900, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.uniform(-1, 1, (nq, 3)).astype(np.float32)
    r = rng.uniform(-1, 1, (nr, 3)).astype(np.float32)
    return q, r


def _truth(q, r):
    d2 = ((q[:, None, :].astype(np.float64) - r[None, :, :]) ** 2).sum(-1)
    return d2.argmin(1), d2.min(1)


def _kernel(q, r):
    rt = prepare_nn_ref_argmin(jnp.asarray(r))
    idx, sq = nn_argmin_prepared(jnp.asarray(q), rt, interpret=True)
    return np.asarray(idx), np.asarray(sq)


def _interpret_kernel(q, rt):
    return nn_argmin_prepared(q, rt, interpret=True)


class TestPallasInterpret:
    @pytest.mark.parametrize("nq,nr", [(300, 900), (2000, 20001), (1, 5)])
    def test_nn_argmin_exact(self, nq, nr):
        q, r = _pair(nq, nr, seed=nq)
        idx_true, sq_true = _truth(q, r)
        idx, sq = _kernel(q, r)
        assert (idx == idx_true).all()
        np.testing.assert_allclose(sq, sq_true, atol=1e-6)

    def test_near_ties_rank_as_float64(self):
        # queries on a lattice, references at ±(s + tiny) — gaps of a few
        # 1e-6 relative must rank exactly (the cross-term formula cannot)
        rng = np.random.default_rng(5)
        q = rng.uniform(-5, 5, (256, 3)).astype(np.float32)
        off = np.array([0.1, 0.0, 0.0], np.float32)
        eps = rng.uniform(1e-6, 1e-5, 256).astype(np.float32)
        a = q + off
        b = q - off * (1 + eps)[:, None]
        r = np.vstack([b, a]).astype(np.float32)
        idx_true, sq_true = _truth(q, r)
        d2 = ((q[:, None, :].astype(np.float64) - r[None]) ** 2).sum(-1)
        d2.sort(1)
        ranked = (d2[:, 1] - d2[:, 0]) > 1e-6 * d2[:, 0]
        idx, sq = _kernel(q, r)
        assert ranked.sum() > 100
        assert (idx[ranked] == idx_true[ranked]).all()
        np.testing.assert_allclose(sq, sq_true, rtol=1e-6)

    def test_duplicate_points_take_lowest_index(self):
        q, r = _pair(64, 700, seed=3)
        idx_true, _ = _truth(q, r)
        # duplicate every true winner far down the list (another split)
        r2 = np.vstack([r, r[idx_true]])
        idx, _ = _kernel(q, r2)
        assert (idx == idx_true).all()

    def test_dead_query_padding(self):
        q, r = _pair(seed=4)
        idx_true, _ = _truth(q, r)
        q2 = np.vstack([q, np.full((5, 3), -PAD_COORD, np.float32)])
        idx, sq = _kernel(q2, r)
        assert (idx[: len(q)] == idx_true).all()
        assert np.isfinite(sq).all()
        assert (idx < len(r)).all()  # padding rows never win

    def test_split_second_pass(self):
        # one query tile → the reference splits 16 ways; put each query's
        # winner in a different split and check the cross-split min
        assert pallas_nn._num_splits(1) == pallas_nn._MAX_SPLITS
        rng = np.random.default_rng(8)
        n = pallas_nn._REF_QUANTUM * 2
        r = rng.uniform(5, 6, (n, 3)).astype(np.float32)
        q = rng.uniform(-1, 1, (16, 3)).astype(np.float32)
        per_split = n // pallas_nn._MAX_SPLITS
        winners = np.arange(16) * per_split + rng.integers(0, per_split, 16)
        r[winners] = q + np.float32(1e-3)
        idx, sq = _kernel(q, r)
        assert (idx == winners).all()
        np.testing.assert_allclose(sq, 3e-6, rtol=1e-3)

    def test_split_count(self):
        assert pallas_nn._num_splits(32) == 16
        assert pallas_nn._num_splits(64) == 8
        assert pallas_nn._num_splits(1024) == 1
        with pytest.raises(ValueError):
            nn_argmin_prepared(jnp.zeros((4, 3)), jnp.zeros((3, 100)))


def test_kernel_lowers_for_the_gpu():
    """The Triton lowering (power-of-two blocks, supported primitives)
    runs without a card; PTX compilation happens only on the chip."""
    f = jax.jit(lambda q, r: nn_argmin_prepared(q, prepare_nn_ref_argmin(r)))
    exp = export.export(
        f, platforms=["cuda"],
        disabled_checks=[export.DisabledSafetyCheck.custom_call(
            "__gpu$xla.gpu.triton")],
    )(jax.ShapeDtypeStruct((2000, 3), jnp.float32),
      jax.ShapeDtypeStruct((20000, 3), jnp.float32))
    text = exp.mlir_module()
    assert "__gpu$xla.gpu.triton" in text
    assert 'name = "nn_argmin"' in text
    assert "num_warps = 4" in text


@pytest.mark.parametrize("backend,uses_kernel", [("gpu", True), ("cpu", False)])
def test_platform_choice(monkeypatch, backend, uses_kernel):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    jax.clear_caches()  # jit caches are not keyed on the backend name
    q, r = _pair(37, 211, seed=11)
    mask_q = jnp.ones((37,), bool)
    mask_r = jnp.ones((211,), bool)
    brute = str(jax.make_jaxpr(nn_dispatch._brute_1nn)(
        jnp.asarray(q), mask_q, jnp.asarray(r), mask_r))
    nrm = jnp.tile(jnp.asarray([0.0, 0.0, 1.0]), (211, 1))
    icp = str(jax.make_jaxpr(
        lambda s, t: icp_point_to_plane(s, mask_q, t, mask_r, nrm, iters=2)
    )(jnp.asarray(q), jnp.asarray(r)))
    jax.clear_caches()
    assert ("pallas_call" in brute) == uses_kernel
    assert ("pallas_call" in icp) == uses_kernel


def test_brute_1nn_gpu_path_matches_xla(monkeypatch):
    q, r = _pair(150, 640, seed=12)
    qm = np.ones(150, bool)
    qm[::7] = False
    rm = np.ones(640, bool)
    rm[::5] = False
    args = (jnp.asarray(q), jnp.asarray(qm), jnp.asarray(r), jnp.asarray(rm))
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    idx_x, sq_x = nn_dispatch._brute_1nn(*args)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(pallas_nn, "nn_argmin_prepared", _interpret_kernel)
    idx_k, sq_k = nn_dispatch._brute_1nn(*args)
    live = qm
    assert (np.asarray(idx_k)[live] == np.asarray(idx_x)[live]).all()
    assert rm[np.asarray(idx_k)[live]].all()  # dead targets never win
    np.testing.assert_allclose(
        np.asarray(sq_k)[live], np.asarray(sq_x)[live], atol=1e-5)


def test_icp_pallas_branch_matches_xla(monkeypatch):
    """The ICP 'pallas' backend (padding, dead rows, index clamp) gives
    the XLA backend's result."""
    monkeypatch.setattr(pallas_nn, "nn_argmin_prepared", _interpret_kernel)
    rng = np.random.default_rng(2)
    xy = rng.uniform(-1, 1, (700, 2))
    z = 0.3 * np.sin(2.5 * xy[:, 0]) + 0.2 * np.cos(3.0 * xy[:, 1])
    tgt = np.column_stack([xy, z]).astype(np.float32)
    nrm = np.column_stack([-0.75 * np.cos(2.5 * xy[:, 0]),
                           0.6 * np.sin(3.0 * xy[:, 1]), np.ones(700)])
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(np.float32)
    src = (tgt[::3] + np.float32([0.02, -0.01, 0.015])).astype(np.float32)
    sm = np.ones(len(src), bool)
    sm[::11] = False
    tm = np.ones(700, bool)
    tm[::13] = False
    out = {}
    for backend in ("pallas", "xla"):
        res = icp_point_to_plane(
            jnp.asarray(src), jnp.asarray(sm), jnp.asarray(tgt),
            jnp.asarray(tm), jnp.asarray(nrm), iters=6, nn_backend=backend)
        out[backend] = res
    np.testing.assert_allclose(
        np.asarray(out["pallas"].transform), np.asarray(out["xla"].transform),
        atol=1e-5)
    assert int(out["pallas"].num_corr) == int(out["xla"].num_corr)


def test_knn_bruteforce_near_tie_cloud_vs_kdtree():
    """The XLA path's cross-term formula: distances within float32
    rounding of the kd-tree's, ranks exact where the gap is clear."""
    rng = np.random.default_rng(9)
    # a jittered lattice: many queries sit near-equidistant to two refs
    g = np.stack(np.meshgrid(*[np.arange(12)] * 3, indexing="ij"), -1)
    r = (g.reshape(-1, 3) * 0.05 + rng.normal(0, 1e-4, (1728, 3))).astype(
        np.float32)
    centres = rng.integers(0, 11, (200, 3)) * 0.05 + 0.025
    q = np.vstack([centres + rng.normal(0, 1e-3, (200, 3)),
                   rng.uniform(0, 0.55, (200, 3))]).astype(np.float32)
    dist, kd_idx = cKDTree(r.astype(np.float64)).query(q.astype(np.float64), k=2)
    idx, sq = knn_bruteforce(jnp.asarray(q), jnp.asarray(r),
                             jnp.ones((1728,), bool), k=1)
    idx, sq = np.asarray(idx[:, 0]), np.asarray(sq[:, 0])
    np.testing.assert_allclose(sq, dist[:, 0] ** 2, atol=1e-5)
    clear = (dist[:, 1] ** 2 - dist[:, 0] ** 2) > 1e-4
    assert clear.sum() > 100
    assert (idx[clear] == kd_idx[clear, 0]).all()


def test_compile_cache_helper(monkeypatch):
    from mapping_private_tpu.utils.compile_cache import (
        DEFAULT_CACHE_DIR, enable_compile_cache)

    before = jax.config.jax_compilation_cache_dir
    try:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
        assert enable_compile_cache() == "/elsewhere/cache"
        assert jax.config.jax_compilation_cache_dir == before  # sets nothing
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
        path = enable_compile_cache()
        assert path == str(REPO / ".jax_cache") == str(DEFAULT_CACHE_DIR)
        assert jax.config.jax_compilation_cache_dir == path
        assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_chip_smoke_fails_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "no GPU" in proc.stderr
    assert '"ok"' not in proc.stdout

"""nn_1nn front door: engine dispatch policy + cross-engine parity.

Pins the dense-lattice cell limit (LATTICE_CELL_LIMIT) as a FALLBACK to
the compact engine, not a compiler error, and the size thresholds that route small problems to brute force
and big ones to the compact occupied-tiles engine."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mapping_private_tpu.ops.nn_dispatch import (
    BRUTE_PAIR_LIMIT,
    LATTICE_CELL_LIMIT,
    choose_nn_engine,
    nn_1nn,
)


def _cloud(n, seed=0, extent=2.0):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, extent, (n, 2))
    z = 0.3 * np.sin(2 * xy[:, 0]) + 0.2 * np.cos(3 * xy[:, 1])
    return np.column_stack([xy, z]).astype(np.float32)


class TestPolicy:
    def test_small_goes_brute(self):
        assert choose_nn_engine(2048, 20000, radius=0.25) == "brute"

    def test_big_goes_compact(self):
        # the 1M×1M case that killed the dense lattice must route compact
        assert choose_nn_engine(1_000_000, 1_000_000, radius=0.05) == "compact"
        assert choose_nn_engine(200_000, 200_000, radius=0.1) == "compact"

    def test_no_radius_forces_brute(self):
        # tiled engines are exact only within the radius; without one the
        # only exact answer is brute force, whatever the size
        assert choose_nn_engine(1_000_000, 1_000_000, radius=None) == "brute"

    def test_threshold_is_the_brute_roofline(self):
        n = int(np.sqrt(BRUTE_PAIR_LIMIT))
        assert choose_nn_engine(n - 1, n - 1, radius=0.1) == "brute"
        assert choose_nn_engine(2 * n, 2 * n, radius=0.1) == "compact"


class TestParity:
    def test_engines_agree(self):
        tgt = _cloud(4096, 0)
        qry = tgt + np.float32(0.01)
        tm = np.ones(4096, bool)
        tm[::7] = False
        qm = np.ones(4096, bool)
        qm[5:9] = False
        ref_i, ref_s = nn_1nn(qry, qm, tgt, tm, radius=0.3, engine="brute")
        for eng in ("compact", "lattice"):
            i, s = nn_1nn(qry, qm, tgt, tm, radius=0.3, engine=eng)
            both = (np.asarray(ref_i) >= 0) & (np.asarray(i) >= 0)
            # same neighbor distance — brute uses the norm-identity
            # expansion, tiled engines exact per-coordinate differences,
            # so only agree to f32 rounding of the expansion
            np.testing.assert_allclose(
                np.asarray(s)[both], np.asarray(ref_s)[both], atol=1e-5)
            assert np.mean(np.asarray(i)[both] == np.asarray(ref_i)[both]) > 0.999
            assert np.all(np.asarray(i)[~qm] == -1)

    def test_radius_gates_brute_matches(self):
        tgt = _cloud(512, 1)
        qry = tgt + np.float32([0.0, 0.0, 1.0])  # 1 m away in z
        ones = np.ones(512, bool)
        i, s = nn_1nn(qry, ones, tgt, ones, radius=0.3, engine="brute")
        assert np.all(np.asarray(i) == -1)
        assert np.all(~np.isfinite(np.asarray(s)))

    def test_empty_target(self):
        tgt = _cloud(128, 2)
        i, s = nn_1nn(tgt, np.ones(128, bool), tgt, np.zeros(128, bool),
                      radius=0.3)
        assert np.all(np.asarray(i) == -1)


class TestPayloadCliff:
    def test_lattice_above_cliff_falls_back(self):
        # a lattice this fine has ~1.6e6 cells — far beyond the cell
        # limit; requesting 'lattice' must fall back to compact with a
        # warning instead of building the huge program
        tgt = _cloud(4096, 3, extent=6.0)
        ones = np.ones(4096, bool)
        with pytest.warns(UserWarning, match="LATTICE_CELL_LIMIT"):
            i, s = nn_1nn(tgt, ones, tgt, ones, radius=0.05, engine="lattice")
        # self-NN: every live point finds itself at distance 0
        assert np.all(np.asarray(i)[np.asarray(i) >= 0] >= 0)
        matched = np.asarray(i) >= 0
        assert matched.mean() > 0.99
        np.testing.assert_allclose(np.asarray(s)[matched], 0.0, atol=1e-10)

    def test_cliff_constant_pins_measured_failure(self):
        # the limit keeps the 43,740-cell lattice of the 200k/0.1 m case
        # on the dense engine and sends ~260k-cell lattices to compact
        assert 43_740 < LATTICE_CELL_LIMIT < 260_000


class TestLatticeOccupancy:
    def test_matches_numpy(self):
        """Device-side sizing stats == numpy truth (pins the int32 key
        arithmetic — jax's default int64-off silently truncates bit-packed
        64-bit keys, which once made occ read 0 and under-sized
        max_tiles below target occupancy)."""
        from mapping_private_tpu.ops.tiled_nn import lattice_occupancy

        rng = np.random.default_rng(3)
        for extent, radius in [(2.0, 0.3), (6.0, 0.05)]:
            xy = rng.uniform(0, extent, (4096, 2))
            z = 0.3 * np.sin(2 * xy[:, 0]) + 0.2 * np.cos(3 * xy[:, 1])
            pts = np.column_stack([xy, z]).astype(np.float32)
            mask = np.ones(4096, bool)
            mask[::7] = False
            lo = pts[mask].min(0) - 2 * radius
            hi = pts[mask].max(0) + 2 * radius
            dims = np.ceil((hi - lo) / radius).astype(np.int32)
            occ, mx = lattice_occupancy(
                jnp.asarray(pts), jnp.asarray(mask), lo, radius, dims)
            cell = np.floor((pts[mask] - lo) / radius).astype(np.int64)
            key = (cell[:, 0] * dims[1] + cell[:, 1]) * dims[2] + cell[:, 2]
            _, counts = np.unique(key, return_counts=True)
            assert int(occ) == len(counts)
            assert int(mx) == int(counts.max())

    def test_all_dead(self):
        from mapping_private_tpu.ops.tiled_nn import lattice_occupancy

        pts = np.zeros((64, 3), np.float32)
        occ, mx = lattice_occupancy(
            jnp.asarray(pts), jnp.zeros(64, bool), np.zeros(3, np.float32),
            0.1, np.asarray([4, 4, 4], np.int32))
        assert int(occ) == 0 and int(mx) == 0


def test_lattice_overflow_guard_fires():
    """A tiny radius over a huge extent must raise the int32-overflow
    guard (round-4 advisor finding) instead of silently wrapping flat
    cell keys into wrong-neighbor results."""
    import jax.numpy as jnp
    import pytest

    from mapping_private_tpu.ops.nn_dispatch import nn_1nn

    xyz = jnp.asarray([[0.0, 0.0, 0.0], [1e5, 1e5, 1e5]], jnp.float32)
    mask = jnp.ones((2,), bool)
    with pytest.raises(ValueError, match="cells"):
        nn_1nn(xyz, mask, xyz, mask, radius=0.01, engine="compact")

import jax
import jax.numpy as jnp
import numpy as np

from mapping_private_tpu.core import PointCloud, se3_exp, se3_apply, se3_inverse, se3_log
from mapping_private_tpu.io import load_pcd
from mapping_private_tpu.ops.normals import estimate_normals
from mapping_private_tpu.registration.icp import icp_point_to_plane, ate_rmse


def _bumpy_surface(seed=0, n=2000):
    """Non-planar surface so point-to-plane locks all 6 DoF."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-1, 1, (n, 2))
    z = 0.3 * np.sin(2.5 * xy[:, 0]) + 0.2 * np.cos(3.0 * xy[:, 1])
    return np.column_stack([xy, z]).astype(np.float32)


def test_icp_recovers_known_transform():
    xyz = _bumpy_surface()
    tgt = PointCloud.from_numpy(xyz)
    tgt = estimate_normals(tgt, k=12, viewpoint=jnp.array([0.0, 0.0, 10.0]))

    xi_true = jnp.asarray(np.array([0.05, -0.04, 0.03, 0.04, -0.03, 0.05], np.float32))
    T_true = se3_exp(xi_true)
    # source = T_true^-1 applied to target points → ICP should recover T_true
    src_xyz = se3_apply(se3_inverse(T_true), tgt.padded_xyz())

    res = icp_point_to_plane(
        src_xyz, tgt.mask, tgt.padded_xyz(), tgt.mask,
        tgt.channel("normal"), iters=15, max_corr_dist=0.5,
    )
    err = se3_log(se3_inverse(res.transform) @ T_true)
    assert float(jnp.linalg.norm(err)) < 5e-3
    assert float(res.rmse) < 1e-3


def test_icp_grid_path():
    xyz = _bumpy_surface(seed=1)
    tgt = PointCloud.from_numpy(xyz)
    tgt = estimate_normals(tgt, k=12, viewpoint=jnp.array([0.0, 0.0, 10.0]))
    xi_true = jnp.asarray(np.array([0.03, 0.02, -0.02, -0.02, 0.03, 0.02], np.float32))
    T_true = se3_exp(xi_true)
    src_xyz = se3_apply(se3_inverse(T_true), tgt.padded_xyz())
    res = icp_point_to_plane(
        src_xyz, tgt.mask, tgt.padded_xyz(), tgt.mask, tgt.channel("normal"),
        iters=15, max_corr_dist=0.3, nn_backend="grid", grid_cell=0.3, cap_per_cell=32,
    )
    err = se3_log(se3_inverse(res.transform) @ T_true)
    assert float(jnp.linalg.norm(err)) < 1e-2


def test_icp_on_reference_scan(reference_root):
    path = reference_root / "color_chlac/demos/shape_data/noiseless_cone_black.pcd"
    tgt = load_pcd(str(path))
    tgt = estimate_normals(tgt, k=10)
    xi_true = jnp.asarray(np.array([0.004, -0.003, 0.005, 0.03, 0.02, -0.03], np.float32))
    T_true = se3_exp(xi_true)
    src_xyz = se3_apply(se3_inverse(T_true), tgt.padded_xyz())
    res = icp_point_to_plane(
        src_xyz, tgt.mask, tgt.padded_xyz(), tgt.mask, tgt.channel("normal"),
        iters=12, max_corr_dist=0.05, huber_delta=0.01,
    )
    err = se3_log(se3_inverse(res.transform) @ T_true)
    assert float(jnp.linalg.norm(err)) < 2e-3


def test_ate():
    a = jnp.stack([jnp.eye(4)] * 3)
    b = a.at[:, 0, 3].add(0.1)
    np.testing.assert_allclose(float(ate_rmse(a, b)), 0.1, atol=1e-6)


def test_tiled_segmented_matches_default():
    """The opt-in segmented tiled path (rebucket_sweeps=k: bucket twice,
    refresh coordinates in between) converges to the same pose as the
    default per-sweep-rebucket path — sub-tile motion keeps the stale
    slot assignments exact (refresh_compact_coords guarantee)."""
    from mapping_private_tpu.registration.icp import icp_point_to_plane_tiled

    xyz = _bumpy_surface(seed=3, n=4000)
    tgt = PointCloud.from_numpy(xyz)
    tgt = estimate_normals(tgt, k=12, viewpoint=jnp.array([0.0, 0.0, 10.0]))
    xi = jnp.asarray(np.array([0.02, -0.02, 0.015, 0.01, -0.01, 0.02],
                              np.float32))
    src_xyz = se3_apply(se3_inverse(se3_exp(xi)), tgt.padded_xyz())

    kw = dict(tile_size=0.25, cap_per_cell=256, iters=8)
    res_d = icp_point_to_plane_tiled(
        src_xyz, tgt.mask, tgt.padded_xyz(), tgt.mask,
        tgt.channel("normal"), **kw)
    res_s = icp_point_to_plane_tiled(
        src_xyz, tgt.mask, tgt.padded_xyz(), tgt.mask,
        tgt.channel("normal"), rebucket_sweeps=2, **kw)
    # both recover the true pose; trajectories agree closely
    np.testing.assert_allclose(
        np.asarray(res_s.transform), np.asarray(res_d.transform), atol=1e-4)
    np.testing.assert_allclose(
        np.asarray(res_d.transform), np.asarray(se3_exp(xi)), atol=2e-3)
    assert int(res_s.num_corr) > 3500


def test_tiled_sizing_syncs_once():
    """Host-sync regression guard: icp_point_to_plane_tiled must reach
    its answer with exactly ONE jax.device_get sync point before
    dispatching the solver (each blocking host read idles the device)."""
    import jax
    import jax.numpy as jnp

    import mapping_private_tpu.registration.icp as icp_mod

    rng = np.random.default_rng(0)
    n = 4096
    xy = rng.uniform(0, 2.0, (n, 2))
    z = 0.2 * np.sin(xy[:, 0] * 3)
    tgt = np.column_stack([xy, z]).astype(np.float32)
    src = (tgt + rng.normal(0, 0.005, tgt.shape)).astype(np.float32)
    nrm = np.tile(np.asarray([0, 0, 1.0], np.float32), (n, 1))
    mask = jnp.ones((n,), bool)

    calls = []
    real_device_get = jax.device_get

    def counting_device_get(x):
        calls.append(1)
        return real_device_get(x)

    orig = icp_mod.jax.device_get
    icp_mod.jax.device_get = counting_device_get
    try:
        r = icp_mod.icp_point_to_plane_tiled(
            jnp.asarray(src), mask, jnp.asarray(tgt), mask,
            jnp.asarray(nrm), tile_size=0.25, iters=2)
    finally:
        icp_mod.jax.device_get = orig
    assert len(calls) == 1, (
        f"sizing used {len(calls)} blocking sync points (contract: 1 — "
        f"each extra one idles the device for a host round trip)")
    assert float(r.rmse) < 0.02

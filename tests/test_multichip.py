import numpy as np
import jax
import jax.numpy as jnp


def test_dryrun_multichip_8cpu():
    import __graft_entry__ as ge

    assert len(jax.devices()) >= 8
    ge.dryrun_multichip(8)


def test_entry_compiles():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    plane, found, sizes = jax.jit(fn)(*args)
    assert plane.shape == (4,)
    assert bool(found)


def test_sharded_step_matches_single_device():
    from mapping_private_tpu.parallel.mesh import make_mesh
    from mapping_private_tpu.parallel.distributed import (
        make_sharded_registration_step,
        _pair_partial_system,
    )
    from mapping_private_tpu.core.se3 import se3_exp

    rng = np.random.default_rng(1)
    B, N = 4, 512
    xy = rng.uniform(-1, 1, (B, N, 2))
    z = 0.3 * np.sin(2.5 * xy[..., 0]) + 0.2 * np.cos(3.0 * xy[..., 1])
    tgt = np.concatenate([xy, z[..., None]], axis=-1).astype(np.float32)
    src = (tgt + np.array([0.02, -0.01, 0.015], np.float32)).astype(np.float32)
    normals = np.tile(np.array([0, 0, 1.0], np.float32), (B, N, 1))
    mask = np.ones((B, N), bool)
    poses = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))

    mesh = make_mesh((4, 2), devices=jax.devices()[:8])
    step, shardings = make_sharded_registration_step(mesh)
    args = [
        jax.device_put(jnp.asarray(a), s)
        for a, s in zip([src, mask, tgt, mask, normals, poses], shardings)
    ]
    new_poses, cnt = step(*args)

    # single-device reference
    def ref_one(s, sm, t, tm, tn, T):
        H, g, _ = _pair_partial_system(s, sm, t, tm, tn, T, 0.25, 0.05)
        xi = -jnp.linalg.solve(H + 1e-6 * jnp.eye(6), g)
        return se3_exp(xi) @ T

    ref = jax.vmap(ref_one)(
        jnp.asarray(src), jnp.asarray(mask), jnp.asarray(tgt),
        jnp.asarray(mask), jnp.asarray(normals), jnp.asarray(poses),
    )
    np.testing.assert_allclose(np.asarray(new_poses), np.asarray(ref), atol=1e-4)


class TestShardedMapICP:
    def test_matches_single_device_step(self):
        import jax
        import jax.numpy as jnp
        import numpy as np
        from mapping_private_tpu.core.se3 import se3_exp
        from mapping_private_tpu.parallel.mesh import make_mesh
        from mapping_private_tpu.parallel.distributed import (
            make_sharded_map_icp_step,
        )
        from mapping_private_tpu.registration.icp import icp_point_to_plane

        rng = np.random.default_rng(0)
        M, N = 4096, 512
        xy = rng.uniform(-2, 2, (M, 2))
        z = 0.3 * np.sin(2.0 * xy[:, 0]) + 0.2 * np.cos(2.5 * xy[:, 1])
        map_xyz = np.column_stack([xy, z]).astype(np.float32)
        dzdx = 0.3 * 2.0 * np.cos(2.0 * xy[:, 0])
        dzdy = -0.2 * 2.5 * np.sin(2.5 * xy[:, 1])
        nrm = np.column_stack([-dzdx, -dzdy, np.ones(M)])
        nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(np.float32)
        T0 = np.asarray(se3_exp(jnp.asarray(
            [0.02, -0.01, 0.015, 0.01, 0.0, 0.01], jnp.float32)))
        scan = (map_xyz[:N] - T0[:3, 3]) @ T0[:3, :3]

        mesh = make_mesh((4, 2))
        step, shardings = make_sharded_map_icp_step(mesh)
        args = [
            jnp.asarray(scan), jnp.ones((N,), bool),
            jnp.asarray(map_xyz), jnp.ones((M,), bool), jnp.asarray(nrm),
            jnp.eye(4),
        ]
        args = [jax.device_put(a, s) for a, s in zip(args, shardings)]
        T_sh, cnt = step(*args)
        assert int(cnt) > 0

        # single-device: one ICP iteration over the full map
        res = icp_point_to_plane(
            jnp.asarray(scan), jnp.ones((N,), bool),
            jnp.asarray(map_xyz), jnp.ones((M,), bool), jnp.asarray(nrm),
            iters=1, max_corr_dist=0.3, nn_backend="xla",
        )
        np.testing.assert_allclose(
            np.asarray(T_sh), np.asarray(res.transform), atol=1e-4
        )


class TestShardedMapBigShards:
    def test_64k_points_per_shard_parity(self):
        """Sharded scan-to-map at production shard sizes: 8 devices ×
        65,536 map points/shard (524,288-point map), scan chunked so each
        device's distance blocks stay bounded.  The sharded pose update
        must match an exact single-machine reference computed in f64."""
        import jax
        import jax.numpy as jnp
        import numpy as np
        from mapping_private_tpu.core.se3 import se3_exp
        from mapping_private_tpu.parallel.mesh import make_mesh
        from mapping_private_tpu.parallel.distributed import (
            make_sharded_map_icp_step,
        )

        rng = np.random.default_rng(1)
        M, N = 8 * 65536, 2048
        xy = rng.uniform(-5, 5, (M, 2))
        z = 0.3 * np.sin(2.0 * xy[:, 0]) + 0.2 * np.cos(2.5 * xy[:, 1])
        map_xyz = np.column_stack([xy, z]).astype(np.float32)
        dzdx = 0.6 * np.cos(2.0 * xy[:, 0])
        dzdy = -0.5 * np.sin(2.5 * xy[:, 1])
        nrm = np.column_stack([-dzdx, -dzdy, np.ones(M)])
        nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(
            np.float32)
        T0 = np.asarray(se3_exp(jnp.asarray(
            [0.02, -0.01, 0.01, 0.008, 0.0, 0.01], jnp.float32)))
        sel = rng.choice(M, N, replace=False)
        scan = ((map_xyz[sel] - T0[:3, 3]) @ T0[:3, :3]).astype(np.float32)

        mesh = make_mesh((8,), axis_names=("mp",))
        step, shardings = make_sharded_map_icp_step(mesh, scan_chunk=256)
        args = [
            jnp.asarray(scan), jnp.ones((N,), bool),
            jnp.asarray(map_xyz), jnp.ones((M,), bool), jnp.asarray(nrm),
            jnp.eye(4),
        ]
        args = [jax.device_put(a, s) for a, s in zip(args, shardings)]
        T_sh, cnt = step(*args)
        assert int(cnt) == N  # every scan point found a correspondence

        # exact reference: brute NN in chunked f64 numpy + GN solve
        s64, m64 = scan.astype(np.float64), map_xyz.astype(np.float64)
        idx = np.empty(N, np.int64)
        for a in range(0, N, 256):
            d2 = ((s64[a:a+256, None, :] - m64[None, :, :]) ** 2).sum(-1) \
                if False else (
                    (s64[a:a+256] ** 2).sum(1)[:, None]
                    + (m64 ** 2).sum(1)[None, :]
                    - 2.0 * s64[a:a+256] @ m64.T
                )
            idx[a:a+256] = d2.argmin(1)
        p = s64
        q, nn = m64[idx], nrm.astype(np.float64)[idx]
        r = np.sum(nn * (p - q), axis=1)
        absr = np.abs(r)
        w = np.where(absr <= 0.05, 1.0, 0.05 / np.maximum(absr, 1e-12))
        J = np.concatenate([nn, np.cross(p, nn)], axis=1)
        Jw = J * w[:, None]
        H = J.T @ Jw
        g = Jw.T @ r
        xi = -np.linalg.solve(H + 1e-6 * np.eye(6), g)
        T_ref = np.asarray(se3_exp(jnp.asarray(xi, jnp.float32)))
        np.testing.assert_allclose(np.asarray(T_sh), T_ref, atol=2e-4)

    def test_64k_per_shard_tiled_engine_parity(self):
        """The compact-tiles NN engine inside the sharded map-ICP: 8
        devices × 65,536 map points/shard, each shard bucketing its own
        map slice once and running the occupied-tiles stencil engine —
        the single-card big-cloud engine — instead of brute-force
        distance matrices.  Two GN
        sweeps must match an exact f64 brute-force reference."""
        import jax
        import jax.numpy as jnp
        import numpy as np
        from mapping_private_tpu.core.se3 import se3_exp
        from mapping_private_tpu.parallel.mesh import make_mesh
        from mapping_private_tpu.parallel.distributed import (
            make_sharded_map_icp_step_tiled,
            size_map_lattice,
        )

        rng = np.random.default_rng(2)
        M, N = 8 * 65536, 2048
        xy = rng.uniform(-5, 5, (M, 2))
        z = 0.3 * np.sin(2.0 * xy[:, 0]) + 0.2 * np.cos(2.5 * xy[:, 1])
        map_xyz = np.column_stack([xy, z]).astype(np.float32)
        dzdx = 0.6 * np.cos(2.0 * xy[:, 0])
        dzdy = -0.5 * np.sin(2.5 * xy[:, 1])
        nrm = np.column_stack([-dzdx, -dzdy, np.ones(M)])
        nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(
            np.float32)
        T0 = np.asarray(se3_exp(jnp.asarray(
            [0.02, -0.01, 0.01, 0.008, 0.0, 0.01], jnp.float32)))
        sel = rng.choice(M, N, replace=False)
        scan = ((map_xyz[sel] - T0[:3, 3]) @ T0[:3, :3]).astype(np.float32)

        tile = 0.15
        origin, dims, cap, max_tiles = size_map_lattice(
            map_xyz, np.ones((M,), bool), tile, scan_xyz=scan)
        mesh = make_mesh((8,), axis_names=("mp",))
        step, shardings = make_sharded_map_icp_step_tiled(
            mesh, origin, tile, dims, cap, max_tiles,
            q_cap=32, q_max_tiles=4096, sweeps=2)
        args = [
            jnp.asarray(scan), jnp.ones((N,), bool),
            jnp.asarray(map_xyz), jnp.ones((M,), bool), jnp.asarray(nrm),
            jnp.eye(4),
        ]
        args = [jax.device_put(a, s) for a, s in zip(args, shardings)]
        T_sh, cnt = step(*args)
        assert int(cnt) == N  # every scan point found a correspondence

        # exact f64 reference: 2 GN sweeps with brute global NN
        m64 = map_xyz.astype(np.float64)
        nn64 = nrm.astype(np.float64)
        T_ref = np.eye(4)
        for _ in range(2):
            p = scan.astype(np.float64) @ T_ref[:3, :3].T + T_ref[:3, 3]
            idx = np.empty(N, np.int64)
            for a in range(0, N, 256):
                d2 = (
                    (p[a:a+256] ** 2).sum(1)[:, None]
                    + (m64 ** 2).sum(1)[None, :]
                    - 2.0 * p[a:a+256] @ m64.T
                )
                idx[a:a+256] = d2.argmin(1)
            q, nn_ = m64[idx], nn64[idx]
            r = np.sum(nn_ * (p - q), axis=1)
            absr = np.abs(r)
            w = np.where(absr <= 0.05, 1.0, 0.05 / np.maximum(absr, 1e-12))
            J = np.concatenate([nn_, np.cross(p, nn_)], axis=1)
            Jw = J * w[:, None]
            xi = -np.linalg.solve(
                J.T @ Jw + 1e-6 * np.eye(6), Jw.T @ r)
            T_ref = np.asarray(
                se3_exp(jnp.asarray(xi, jnp.float32))) @ T_ref
        np.testing.assert_allclose(np.asarray(T_sh), T_ref, atol=2e-4)


def test_balance_map_shards_equalizes_occupancy():
    """Skew-stress mitigation (round-4 verdict item 8): the round-robin
    tile-order permutation must equalize per-shard occupied-tile counts
    on a corridor+cluster scene while keeping every live point."""
    from mapping_private_tpu.parallel.distributed import balance_map_shards

    rng = np.random.default_rng(0)
    corridor = np.column_stack([
        rng.uniform(0, 20, 4000), rng.uniform(0, 1, 4000),
        rng.uniform(0, 0.5, 4000)])
    cluster = rng.normal([25, 0.5, 0.25], 0.3, (12000, 3))
    xyz = np.vstack([corridor, cluster]).astype(np.float32)
    mask = np.ones(len(xyz), bool)
    nd, tile = 8, 0.3

    def occ_balance(x):
        b = np.linspace(0, len(x), nd + 1, dtype=int)
        lo = x.min(0) - tile
        c = np.floor((x - lo) / tile).astype(np.int64)
        ext = c.max(0) + 1
        f = (c[:, 0] * ext[1] + c[:, 1]) * ext[2] + c[:, 2]
        occ = [len(np.unique(f[b[i]:b[i + 1]])) for i in range(nd)]
        return np.mean(occ) / max(occ)

    assert occ_balance(xyz) < 0.6  # the scene is genuinely skewed
    perm = balance_map_shards(xyz, mask, tile, nd)
    assert sorted(perm) == list(range(len(xyz)))  # a true permutation
    assert occ_balance(xyz[perm]) > 0.95

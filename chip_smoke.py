"""Smoke run of the main path on one GPU.

Drives exact nearest neighbours, scan-to-scan ICP, spinning-LiDAR-sized
tiled ICP, scan-to-map tracking, table detection and pose-graph
relaxation through the package's own entry points, at the sizes users
run, with seeded synthetic data, and checks each against a plain
reference (scipy's kd-tree, the registration.cpp-faithful CPU ICP of
bench.py, the same program on the CPU, or the seeded truth).

    python chip_smoke.py                # the seven phases on one GPU
    python chip_smoke.py --four-cards   # only the sharded steps, 4 GPUs

Run it from the repository root.  It prints a header line (devices, the
card's name and power limit, the matmul precision, the compile cache),
one line per phase (compile seconds = the first call's excess over a
steady call, steady seconds, each check with its bound), and as its last
line one JSON object naming the device.  Without a GPU, or when any
check fails, it exits non-zero and prints no JSON line.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# ---------------------------------------------------------------- sizes
BRUTE_SIZES = ((2_000, 20_000), (20_000, 65_536))  # queries × targets
COMPACT_SIZE = 120_000  # per cloud, compact engine
COMPACT_RADIUS = 0.25
LIDAR_POINTS = 120_000  # one KITTI HDL-64 scan
TRACK_SCANS = 10
TRACK_SCAN_POINTS = 20_000
TABLE_FRAME = (640, 480)  # one Kinect frame
POSE_GRAPH_K = 1024
# --four-cards
REG_POINTS = 20_000
MAP_POINTS = 2_097_152  # 524,288 per card on four
MAP_EXTENT = 20.0
MAP_SCAN_POINTS = 20_000

# ---------------------------------------------------------------- limits
NN_D2_ATOL = 1e-5  # float32 distance vs the float64 kd-tree
NN_TIE_RTOL = 1e-6  # ranks must match where the 1st/2nd gap exceeds this
T_GATE = 0.05  # max |T − T_true| (Frobenius), bench.py's gate
ATE_MARGIN = 1e-3  # m over the CPU run's ATE; the bound never exceeds:
ATE_MAX = 0.01
POSE_TRANS_TOL = 1e-3  # m, GPU vs CPU final tracker pose
POSE_ROT_TOL = 1e-3  # rad
TABLE_ANGLE_TOL = 2.0  # degrees
TABLE_OFFSET_TOL = 0.01  # m
PG_ERR_MAX = 1e-6
SHARD_T_TOL = 1e-4  # sharded vs one-card transforms


def _check(label, value, limit, ok):
    return (label, value, limit, bool(ok))


def _fmt(v):
    if isinstance(v, str):
        return v
    if isinstance(v, (bool, np.bool_)):
        return str(bool(v))
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    return f"{float(v):.3e}"


def _timed(fn):
    """(result, compile seconds, steady seconds): run twice, each call
    ending in a blocking read of its result."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    steady = time.perf_counter() - t0
    return out, max(first - steady, 0.0), steady


def _se3(xi):
    import jax.numpy as jnp
    from mapping_private_tpu.core.se3 import se3_exp

    return np.asarray(se3_exp(jnp.asarray(xi, jnp.float32)), np.float64)


def _to_frame(T, xyz, nrm):
    """World points/normals seen from pose T (inverse transform)."""
    R, t = T[:3, :3], T[:3, 3]
    return ((xyz - t) @ R).astype(np.float32), (nrm @ R).astype(np.float32)


def _rot_angle(Ra, Rb):
    """Angle of Ra⁻¹Rb from its sine and cosine: arccos alone turns the
    float32 rounding of the matrices into ~5e-4 rad near zero."""
    A = np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64)
    s = 0.5 * np.linalg.norm([A[2, 1] - A[1, 2], A[0, 2] - A[2, 0],
                              A[1, 0] - A[0, 1]])
    return float(np.arctan2(s, (np.trace(A) - 1.0) / 2.0))


# ---------------------------------------------------------------- scenes
def _sample_boxes(rng, n, boxes):
    """n points on the faces of axis-aligned boxes (lo, hi), with
    outward normals; faces picked by area."""
    faces = []
    for lo, hi in boxes:
        lo, hi = np.asarray(lo, float), np.asarray(hi, float)
        ext = hi - lo
        for ax in range(3):
            a, b = [i for i in range(3) if i != ax]
            for side, val in ((-1, lo[ax]), (1, hi[ax])):
                faces.append((ax, a, b, val, side, lo, hi, ext[a] * ext[b]))
    area = np.array([f[-1] for f in faces])
    pick = rng.choice(len(faces), n, p=area / area.sum())
    xyz = np.empty((n, 3))
    nrm = np.zeros((n, 3))
    for k, (ax, a, b, val, side, lo, hi, _) in enumerate(faces):
        sel = pick == k
        m = int(sel.sum())
        xyz[sel, ax] = val
        xyz[sel, a] = rng.uniform(lo[a], hi[a], m)
        xyz[sel, b] = rng.uniform(lo[b], hi[b], m)
        nrm[sel, ax] = side
    return xyz, nrm


def _lidar_scene(n, seed):
    """One spinning-LiDAR-sized scan of a street: ground with range-
    falling density out to 40 m, building walls, parked cars as boxes and
    poles; world frame, exact normals."""
    rng = np.random.default_rng(seed)
    n_ground, n_walls, n_cars = int(0.5 * n), int(0.3 * n), int(0.15 * n)
    n_poles = n - n_ground - n_walls - n_cars
    r = np.exp(rng.uniform(np.log(3.0), np.log(40.0), n_ground))
    th = rng.uniform(0, 2 * np.pi, n_ground)
    ground = np.column_stack([r * np.cos(th), r * np.sin(th),
                              np.zeros(n_ground)])
    g_n = np.tile([0.0, 0.0, 1.0], (n_ground, 1))
    walls, w_n = _sample_boxes(rng, n_walls, [
        ((12.0, -15.0, 0.0), (12.0, 15.0, 6.0)),
        ((-20.0, -10.0, 0.0), (5.0, -10.0, 6.0)),
        ((0.0, 14.0, 0.0), (25.0, 14.0, 8.0))])
    cars, c_n = _sample_boxes(rng, n_cars, [
        ((4.0, -7.0, 0.0), (8.5, -5.2, 1.5)),
        ((-6.0, 4.0, 0.0), (-1.5, 5.8, 1.5)),
        ((9.0, 6.0, 0.0), (10.8, 10.5, 1.6)),
        ((-15.0, -4.0, 0.0), (-10.5, -2.2, 1.5))])
    centres = np.array([[3.0, 3.0], [-4.0, -6.0], [7.0, -2.0], [-9.0, 8.0]])
    c = centres[rng.integers(0, 4, n_poles)]
    ang = rng.uniform(0, 2 * np.pi, n_poles)
    rad = np.column_stack([np.cos(ang), np.sin(ang), np.zeros(n_poles)])
    poles = np.column_stack([c, rng.uniform(0, 4.0, n_poles)]) + 0.15 * rad
    xyz = np.vstack([ground, walls, cars, poles]).astype(np.float32)
    nrm = np.vstack([g_n, w_n, c_n, rad]).astype(np.float32)
    return xyz, nrm


# zero-thickness boxes are planes (walls, floor): one surface, sampled
# from both sides
_ROOM = [((-5.0, -4.0, 0.0), (5.0, 4.0, 0.0)),  # floor
         ((-5.0, -4.0, 0.0), (-5.0, 4.0, 3.0)),  # walls
         ((5.0, -4.0, 0.0), (5.0, 4.0, 3.0)),
         ((-5.0, -4.0, 0.0), (5.0, -4.0, 3.0)),
         ((-5.0, 4.0, 0.0), (5.0, 4.0, 3.0)),
         ((1.0, 1.0, 0.0), (2.2, 1.8, 0.75)),  # furniture
         ((-3.0, -2.5, 0.0), (-2.0, -0.5, 1.8)),
         ((2.5, -3.0, 0.0), (3.5, -2.2, 1.1))]


def _room_points(n, seed):
    xyz, nrm = _sample_boxes(np.random.default_rng(seed), n, _ROOM)
    return xyz.astype(np.float32), nrm.astype(np.float32)


def _trajectory(k):
    """k poses of a robot driving through the room, pose 0 = identity."""
    poses = []
    for i in range(k):
        poses.append(_se3([0.06 * i, 0.015 * i, 0.0, 0.0, 0.0,
                           np.deg2rad(1.0) * i]))
    return np.stack(poses)


def _tabletop_frame(n, seed):
    """A full Kinect frame's worth of points in the robot base frame: a
    1.2 × 0.8 m table at 0.75 m with three objects, floor and a wall."""
    rng = np.random.default_rng(seed)
    n_table, n_obj = int(0.3 * n), n // 50
    n_wall = int(0.2 * n)
    n_floor = n - n_table - 3 * n_obj - n_wall
    t = rng.uniform([-0.6, -0.4], [0.6, 0.4], (n_table, 2))
    table = np.column_stack([t, 0.75 + rng.normal(0, 0.002, n_table)])
    box_a, _ = _sample_boxes(rng, n_obj, [((0.2, 0.05, 0.75),
                                           (0.32, 0.17, 0.95))])
    box_b, _ = _sample_boxes(rng, n_obj, [((-0.45, 0.1, 0.75),
                                           (-0.3, 0.25, 0.87))])
    th = rng.uniform(0, 2 * np.pi, n_obj)
    cyl = np.column_stack([-0.1 + 0.04 * np.cos(th), -0.2 + 0.04 * np.sin(th),
                           rng.uniform(0.75, 0.97, n_obj)])
    floor = rng.uniform([-2, -2, 0], [2, 2, 0.02], (n_floor, 3))
    wall = np.column_stack([np.full(n_wall, 1.8), rng.uniform(-2, 2, n_wall),
                            rng.uniform(0.0, 2.0, n_wall)])
    xyz = np.vstack([table, box_a, box_b, cyl, floor, wall]).astype(np.float32)
    return xyz[rng.permutation(n)], 3


# ---------------------------------------------------------------- phases
def _nn_checks(tag, q, t, idx, sq, radius):
    from scipy.spatial import cKDTree

    dist, kidx = cKDTree(t.astype(np.float64)).query(q.astype(np.float64), k=2)
    d2 = dist ** 2
    if radius is None:
        inside = np.ones(len(q), bool)
        outside = np.zeros(len(q), bool)
    else:
        inside = d2[:, 0] < radius ** 2 * (1 - 1e-4)
        outside = d2[:, 0] > radius ** 2 * (1 + 1e-4)
    clear = inside & ((d2[:, 1] - d2[:, 0]) > NN_TIE_RTOL * d2[:, 0])
    mism = int(np.sum(idx[clear] != kidx[clear, 0]))
    err = float(np.max(np.abs(sq[inside] - d2[inside, 0]), initial=0.0))
    checks = [
        _check(f"{tag} idx mismatches (gap>{NN_TIE_RTOL:g} rel, of "
               f"{int(clear.sum())})", mism, "== 0", mism == 0),
        _check(f"{tag} max|d2-kdtree|", err, f"<= {NN_D2_ATOL:g}",
               err <= NN_D2_ATOL),
    ]
    if radius is not None:
        n_out = int(np.sum(idx[outside] != -1))
        checks.append(_check(f"{tag} beyond-radius not -1", n_out, "== 0",
                             n_out == 0))
    return checks


def phase_nn(brute_sizes=BRUTE_SIZES, compact_size=COMPACT_SIZE,
             radius=COMPACT_RADIUS):
    import jax
    import jax.numpy as jnp
    import bench
    from mapping_private_tpu.ops import nn_dispatch, pallas_nn

    checks, comp, steady = [], 0.0, 0.0
    clouds = []
    for nq, nt in brute_sizes:
        if nt <= bench.N_POINTS:
            src, tgt, _, _ = bench.make_pair(nt)
            q = src[np.random.default_rng(1).choice(nt, nq, replace=False)]
        else:  # a tracker scan against a map-sized cloud
            tgt = _room_points(nt, seed=2)[0]
            q = _room_points(nq, seed=3)[0] + np.float32(0.02)
        clouds.append((f"brute {nq}x{nt}", q, tgt, None))
    a = _lidar_scene(compact_size, seed=4)[0]
    b = _lidar_scene(compact_size, seed=5)[0] + np.float32([0.05, -0.03, 0.01])
    clouds.append((f"compact {compact_size}x{compact_size}", b, a, radius))

    for tag, q, t, r in clouds:
        qj, tj = jnp.asarray(q), jnp.asarray(t)
        qm = jnp.ones((len(q),), bool)
        tm = jnp.ones((len(t),), bool)
        engine = nn_dispatch.choose_nn_engine(len(q), len(t), r)
        want = "brute" if r is None else "compact"
        checks.append(_check(f"{tag} engine", engine, f"== {want}",
                             engine == want))
        (idx, sq), c, s = _timed(lambda: nn_dispatch.nn_1nn(qj, qm, tj, tm, r))
        comp, steady = comp + c, steady + s
        checks += _nn_checks(tag, q, t, np.asarray(idx), np.asarray(sq), r)
        if r is None:
            text = jax.jit(nn_dispatch._brute_1nn).lower(
                qj, qm, tj, tm).as_text()
            ran = "__gpu$xla.gpu.triton" in text and "nn_argmin" in text
            want_k = pallas_nn.use_gpu_kernel()
            checks.append(_check(f"{tag} GPU kernel in program", ran,
                                 f"== {want_k}", ran == want_k))
    big_q, big_t = brute_sizes[-1]
    auto = nn_dispatch.choose_nn_engine(big_q, big_t, radius)
    checks.append(_check(f"{big_q}x{big_t} with a radius picks", auto,
                         "== compact", auto == "compact"))
    return comp, steady, checks


def phase_icp_chain(n_points=None):
    import jax
    import jax.numpy as jnp
    import bench

    n_points = n_points or bench.N_POINTS
    src, tgt, nrm, T_true = bench.make_pair(n_points)
    scans, nrms, steps = bench.make_chain(tgt, nrm)
    chain = jax.jit(bench.register_chain)
    Ts, comp, steady = _timed(
        lambda: chain(jnp.asarray(scans), jnp.asarray(nrms)))
    err_chain = float(np.max(np.linalg.norm(np.asarray(Ts) - steps,
                                            axis=(1, 2))))
    T_dev = np.asarray(jax.jit(bench.register_pair)(
        jnp.asarray(tgt), jnp.asarray(nrm), jnp.asarray(src)))
    T_ref, _ = bench.reference_cpu_icp(src, tgt, nrm)
    for who, T in (("device", T_dev), ("registration.cpp reference", T_ref),
                   ("true", T_true)):
        print(f"  icp_chain pair transform, {who}: "
              f"{np.array2string(np.asarray(T, np.float64).ravel(), precision=6, suppress_small=True, max_line_width=10**4)}",
              flush=True)
    e_dev = float(np.linalg.norm(T_dev - T_true))
    e_ref = float(np.linalg.norm(T_ref - T_true))
    return comp, steady, [
        _check(f"chain{bench.CHAIN_LEN} max|T-T_true|", err_chain,
               f"< {T_GATE}", err_chain < T_GATE),
        _check("pair |T-T_true| device", e_dev, f"< {T_GATE}", e_dev < T_GATE),
        _check("pair |T-T_true| reference", e_ref, f"< {T_GATE}",
               e_ref < T_GATE),
    ]


def phase_icp_lidar(n=LIDAR_POINTS):
    import jax.numpy as jnp
    from mapping_private_tpu.registration.icp import icp_point_to_plane_tiled

    tgt, tgt_n = _lidar_scene(n, seed=21)
    world, world_n = _lidar_scene(n, seed=22)
    # one 10 Hz step at ~4.5 km/h with a little yaw, roll and pitch
    T_true = _se3([0.12, -0.04, 0.01, 0.002, -0.003, 0.005])
    src, _ = _to_frame(T_true, world, world_n)
    m = jnp.ones((n,), bool)
    args = (jnp.asarray(src), m, jnp.asarray(tgt), m, jnp.asarray(tgt_n))
    res, comp, steady = _timed(
        lambda: icp_point_to_plane_tiled(*args, iters=6).transform)
    err = float(np.linalg.norm(np.asarray(res) - T_true))
    return comp, steady, [_check("|T-T_true|", err, f"< {T_GATE}",
                                 err < T_GATE)]


def _track(cfg, scans):
    from mapping_private_tpu.registration.scan_to_map import ScanToMapTracker

    tracker = ScanToMapTracker(cfg)
    poses = []
    for xyz, nrm in scans:
        pose, _ = tracker.track(xyz, nrm, np.ones((len(xyz),), bool))
        poses.append(np.asarray(pose))
    return np.stack(poses), int(tracker.map.count())


def _tracking_problem(n_scans, n_points):
    truth = _trajectory(n_scans)
    scans = [_to_frame(T, *_room_points(n_points, seed=100 + k))
             for k, T in enumerate(truth)]
    return truth, scans


def _track_on_cpu(n_scans, n_points):
    """The tracker on the host CPU with the plain XLA NN: the reference
    for phase_scan_to_map.  Minutes of CPU work at full size, so main()
    starts it in a thread before the GPU phases."""
    import jax
    from mapping_private_tpu.registration.scan_to_map import TrackerConfig

    with jax.default_device(jax.devices("cpu")[0]):
        return _track(TrackerConfig(nn_backend="xla"),
                      _tracking_problem(n_scans, n_points)[1])[0]


def phase_scan_to_map(n_scans=TRACK_SCANS, n_points=TRACK_SCAN_POINTS,
                      cpu_run=None):
    from mapping_private_tpu.registration.icp import ate_rmse
    from mapping_private_tpu.registration.scan_to_map import TrackerConfig

    truth, scans = _tracking_problem(n_scans, n_points)
    (est, count), comp, steady = _timed(
        lambda: _track(TrackerConfig(), scans))
    est_cpu = (cpu_run.result() if cpu_run is not None
               else _track_on_cpu(n_scans, n_points))
    ate = float(ate_rmse(est, truth))
    ate_cpu = float(ate_rmse(est_cpu, truth))
    bound = min(ate_cpu + ATE_MARGIN, ATE_MAX)
    dt = float(np.linalg.norm(est[-1][:3, 3] - est_cpu[-1][:3, 3]))
    dr = _rot_angle(est[-1][:3, :3], est_cpu[-1][:3, :3])
    return comp, steady, [
        _check(f"ATE m (CPU {ate_cpu:.3e})", ate, f"<= {bound:.3e}",
               ate <= bound),
        _check("map count", count, "> 0", count > 0),
        _check("final pose vs CPU, m", dt, f"<= {POSE_TRANS_TOL}",
               dt <= POSE_TRANS_TOL),
        _check("final pose vs CPU, rad", dr, f"<= {POSE_ROT_TOL}",
               dr <= POSE_ROT_TOL),
    ]


def _table_summary(det):
    plane = np.asarray(det.plane, np.float64)
    n = plane[:3] / np.linalg.norm(plane[:3])
    return (bool(det.found), n, plane[3] / np.linalg.norm(plane[:3]),
            int(det.num_objects()))


def phase_table(frame=TABLE_FRAME):
    import jax
    from mapping_private_tpu.core import PointCloud
    from mapping_private_tpu.models.table_detector import detect_table

    xyz, n_objects = _tabletop_frame(frame[0] * frame[1], seed=31)

    def run():
        cloud = PointCloud.from_numpy(xyz)
        return detect_table(cloud, jax.random.PRNGKey(0))[0]

    det, comp, steady = _timed(run)
    with jax.default_device(jax.devices("cpu")[0]):
        det_cpu = run()
    found, n, d, objs = _table_summary(det)
    found_c, n_c, d_c, objs_c = _table_summary(det_cpu)
    ang = float(np.degrees(np.arccos(np.clip(n[2], -1, 1))))
    ang_c = float(np.degrees(np.arccos(np.clip(n @ n_c, -1, 1))))
    return comp, steady, [
        _check("found", found, "== True", found),
        _check("normal vs truth, deg", ang, f"<= {TABLE_ANGLE_TOL}",
               ang <= TABLE_ANGLE_TOL),
        _check("offset vs truth, m", abs(d + 0.75), f"<= {TABLE_OFFSET_TOL}",
               abs(d + 0.75) <= TABLE_OFFSET_TOL),
        _check("objects", objs, f"== {n_objects}", objs == n_objects),
        _check("CPU found", found_c, "== True", found_c),
        _check("normal vs CPU, deg", ang_c, f"<= {TABLE_ANGLE_TOL}",
               ang_c <= TABLE_ANGLE_TOL),
        _check("offset vs CPU, m", abs(d - d_c), f"<= {TABLE_OFFSET_TOL}",
               abs(d - d_c) <= TABLE_OFFSET_TOL),
        _check("CPU objects", objs_c, f"== {objs}", objs_c == objs),
    ]


def phase_pose_graph(K=POSE_GRAPH_K):
    import jax.numpy as jnp
    import __graft_entry__ as ge
    from mapping_private_tpu.registration.pose_graph import (
        optimize_pose_graph)

    kf, edges, meas, w, _, _ = ge.pose_graph_problem(K)
    args = [jnp.asarray(a) for a in (kf, edges, meas, w)]
    (_, errs), comp, steady = _timed(
        lambda: optimize_pose_graph(*args, iters=3))
    err = float(errs[-1])
    return comp, steady, [_check("err after 3 passes", err,
                                 f"< {PG_ERR_MAX:g}", err < PG_ERR_MAX)]


PHASES = (("nn", phase_nn), ("icp_chain", phase_icp_chain),
          ("icp_lidar", phase_icp_lidar), ("scan_to_map", phase_scan_to_map),
          ("table", phase_table), ("pose_graph", phase_pose_graph))


# ---------------------------------------------------------- four cards
def _on_mesh(step_fn, shardings, arrays):
    import jax
    import jax.numpy as jnp

    args = [jax.device_put(jnp.asarray(a), s)
            for a, s in zip(arrays, shardings)]
    return jax.block_until_ready(step_fn(*args))


def _compare(tag, out4, out1, checks):
    dT = float(np.max(np.abs(np.asarray(out4[0]) - np.asarray(out1[0]))))
    checks.append(_check(f"{tag} max|T4-T1|", dT, f"<= {SHARD_T_TOL:g}",
                         dT <= SHARD_T_TOL))
    c4, c1 = np.asarray(out4[1]), np.asarray(out1[1])
    checks.append(_check(f"{tag} corr 4 vs 1", int(c4.sum()),
                         f"== {int(c1.sum())}", np.array_equal(c4, c1)))


def phase_sharded_registration(devs, n_points=REG_POINTS):
    from mapping_private_tpu.parallel.distributed import (
        make_sharded_registration_step)
    from mapping_private_tpu.parallel.mesh import make_mesh
    import __graft_entry__ as ge

    data = ge.registration_batch(2, n_points)
    outs, comp, steady = {}, 0.0, 0.0
    for n, shape in ((4, (2, 2)), (1, (1, 1))):
        step, sh = make_sharded_registration_step(
            make_mesh(shape, devices=devs[:n]))
        outs[n], c, s = _timed(lambda: _on_mesh(step, sh, data))
        comp, steady = comp + c, steady + s
    checks = []
    _compare("registration dp=2 sp=2", outs[4], outs[1], checks)
    return comp, steady, checks


def phase_sharded_map(devs, n_map=MAP_POINTS, n_scan=MAP_SCAN_POINTS,
                      extent=MAP_EXTENT):
    from mapping_private_tpu.parallel.distributed import (
        make_sharded_map_icp_step, make_sharded_map_icp_step_tiled,
        size_map_lattice)
    from mapping_private_tpu.parallel.mesh import make_mesh
    import __graft_entry__ as ge

    problem = ge.map_problem(n_map, n_scan, extent=extent)
    scan, map_xyz = problem[0], problem[2]
    tile = 0.3
    origin, dims, cap, max_tiles = size_map_lattice(
        map_xyz, problem[3], tile, scan_xyz=scan)
    # the scan's own lattice occupancy sizes its query tiles
    cell = np.floor((scan - np.asarray(origin)) / tile).astype(np.int64)
    _, per = np.unique((cell[:, 0] * dims[1] + cell[:, 1]) * dims[2]
                       + cell[:, 2], return_counts=True)
    q_max = 1 << int(np.ceil(np.log2(max(int(1.5 * len(per)), 64))))
    q_cap = max(32, 1 << int(np.ceil(np.log2(int(per.max())))))
    checks, comp, steady = [], 0.0, 0.0
    for name in ("brute", "tiled"):
        outs = {}
        for n in (4, 1):
            mesh = make_mesh((n,), axis_names=("mp",), devices=devs[:n])
            if name == "brute":
                step, sh = make_sharded_map_icp_step(mesh, scan_chunk=256)
            else:
                step, sh = make_sharded_map_icp_step_tiled(
                    mesh, origin, tile, dims, cap, max_tiles,
                    q_cap=q_cap, q_max_tiles=q_max, sweeps=2)
            outs[n], c, s = _timed(lambda: _on_mesh(step, sh, problem))
            comp, steady = comp + c, steady + s
        _compare(f"map {name} {n_map} pts", outs[4], outs[1], checks)
    return comp, steady, checks


def phase_sharded_pose_graph(devs, K=POSE_GRAPH_K):
    from mapping_private_tpu.parallel.mesh import make_mesh
    from mapping_private_tpu.registration.pose_graph import (
        make_sharded_pose_graph_step)
    import __graft_entry__ as ge
    import jax

    kf, edges, meas, w, _, _ = ge.pose_graph_problem(K, multiple=4)

    def three_passes(step, sh):
        poses = kf
        for _ in range(3):
            poses, err = _on_mesh(step, sh, (poses, edges, meas, w))
            poses = jax.device_get(poses)
        return poses, err

    outs, comp, steady = {}, 0.0, 0.0
    for n, shape in ((4, (2, 2)), (1, (1, 1))):
        step, sh = make_sharded_pose_graph_step(
            make_mesh(shape, devices=devs[:n]))
        outs[n], c, s = _timed(lambda: three_passes(step, sh))
        comp, steady = comp + c, steady + s
    dT = float(np.max(np.abs(outs[4][0] - outs[1][0])))
    e4, e1 = float(outs[4][1]), float(outs[1][1])
    return comp, steady, [
        _check("poses max|4-1|", dT, f"<= {SHARD_T_TOL:g}", dT <= SHARD_T_TOL),
        _check("err 4 cards", e4, f"< {PG_ERR_MAX:g}", e4 < PG_ERR_MAX),
        _check("err 1 card", e1, f"< {PG_ERR_MAX:g}", e1 < PG_ERR_MAX),
    ]


FOUR_CARD_PHASES = (("sharded_registration", phase_sharded_registration),
                    ("sharded_map", phase_sharded_map),
                    ("sharded_pose_graph", phase_sharded_pose_graph))


# ---------------------------------------------------------------- main
def run_phases(phases):
    """Run each (name, fn) phase, print its line; returns True if every
    check of every phase passed.  A phase that raises has failed."""
    all_ok = True
    for name, fn in phases:
        try:
            comp, steady, checks = fn()
        except Exception:  # report the phase as failed and go on
            traceback.print_exc()
            print(f"phase {name}: FAILED (raised)", flush=True)
            all_ok = False
            continue
        ok = all(c[3] for c in checks)
        all_ok &= ok
        body = "; ".join(f"{lab}={_fmt(v)} [{lim}] {'ok' if good else 'FAIL'}"
                         for lab, v, lim, good in checks)
        print(f"phase {name}: {'ok' if ok else 'FAILED'} "
              f"compile_s={comp:.2f} steady_s={steady:.4f} | {body}",
              flush=True)
    return all_ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded steps, on a 4-GPU mesh")
    args = ap.parse_args(argv)

    import jax

    # the reference runs need the host CPU beside the GPU
    plats = jax.config.jax_platforms
    if plats and "cpu" not in plats.split(","):
        jax.config.update("jax_platforms", plats + ",cpu")
    # phase "device": there is no CPU fallback
    if jax.default_backend() != "gpu":
        print(f"chip_smoke: no GPU (JAX default backend is "
              f"{jax.default_backend()!r})", file=sys.stderr)
        return 2
    devs = jax.devices()
    need = 4 if args.four_cards else 1
    if len(devs) < need:
        print(f"chip_smoke: needs {need} GPUs, found {len(devs)}",
              file=sys.stderr)
        return 2

    from mapping_private_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    smi = " / ".join(line.strip() for line in smi.strip().splitlines())
    print(f"devices={devs} | nvidia-smi: {smi} | "
          f"jax_default_matmul_precision="
          f"{jax.config.jax_default_matmul_precision} | "
          f"compile_cache={cache}", flush=True)

    print(f"phase device: ok platform={jax.default_backend()} "
          f"count={len(devs)}", flush=True)
    if args.four_cards:
        ok = run_phases([(n, (lambda f=f: f(devs)))
                         for n, f in FOUR_CARD_PHASES])
    else:
        with ThreadPoolExecutor(max_workers=1) as pool:
            cpu_run = pool.submit(_track_on_cpu, TRACK_SCANS,
                                  TRACK_SCAN_POINTS)
            phases = [(n, (lambda f=f: f(cpu_run=cpu_run))
                       if n == "scan_to_map" else f) for n, f in PHASES]
            ok = run_phases(phases)
    if not ok:
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    dev = devs[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

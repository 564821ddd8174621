"""Headline benchmark: scan-to-scan registration throughput (frames/s).

Compares the point-to-plane ICP (registration/icp.py) on the default JAX
device against a faithful single-core CPU re-implementation of the
reference's `Registration` op (cloud_algos/src/registration.cpp): 100
fixed iterations, 1% random correspondence sampling, kd-tree NN (scipy
cKDTree stands in for ANN), point-to-plane linearized solve via SVD
pseudo-inverse.

The device side registers a CHAIN of consecutive scans — each previous
scan becomes the next target, the reference's own incremental setting
(`setTarget`, registration.cpp:171-180) — as one traced lax.scan, so the
measured per-pair rate is device throughput, not per-dispatch latency.
Per-pair work is identical to dispatching pairs individually.

Prints ONE JSON line:
  {"metric": "icp_registration", "value": <device fps>, "unit": "frames/s",
   "vs_baseline": <device fps / reference cpu fps>, ..., "device": {...}}

The CPU baseline is measured on every run, on the host that runs the
benchmark.  On a GPU the line also carries the 200k-point tiled rows.
"""
import json
import time

import numpy as np

N_POINTS = 20000
# Every sweep matches all 2000 samples (vs the reference's 200 random
# ones), so the chain converges in ~4 sweeps; 6 leave a margin.
ICP_ITERS = 6
# Source correspondences per iteration.  The reference samples 1% of the
# cloud (200 points) per iteration (registration.cpp:113-126); we use 10%
# (2000) — 10× the reference's correspondence density per sweep — matched
# against the FULL target.
SRC_SAMPLES = 2000
REF_ITERS = 100  # reference's fixed count (registration.cpp:150)


def make_pair(n=N_POINTS, seed=0):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-2, 2, (n, 2))
    z = 0.4 * np.sin(1.8 * xy[:, 0]) + 0.3 * np.cos(2.2 * xy[:, 1])
    tgt = np.column_stack([xy, z]).astype(np.float32)
    # ground-truth small motion
    from mapping_private_tpu.core.se3 import se3_exp
    import jax.numpy as jnp

    xi = np.array([0.05, -0.04, 0.03, 0.02, -0.02, 0.03], np.float32)
    T = np.asarray(se3_exp(jnp.asarray(xi)))
    src = (tgt - T[:3, 3]) @ T[:3, :3]  # inverse transform
    # normals: analytic, n ∝ (−∂z/∂x, −∂z/∂y, 1)
    dzdx = 0.4 * 1.8 * np.cos(1.8 * xy[:, 0])
    dzdy = -0.3 * 2.2 * np.sin(2.2 * xy[:, 1])
    nrm = np.column_stack([-dzdx, -dzdy, np.ones(n)])
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return src.astype(np.float32), tgt, nrm.astype(np.float32), T


def reference_cpu_icp(src, tgt, normals):
    """registration.cpp-faithful single-core ICP.  Returns (source →
    target transform (4,4), wall-clock seconds for the pair)."""
    from scipy.spatial import cKDTree

    rng = np.random.default_rng(0)
    n = len(src)
    nr_samples = max(6, n // 100)  # 1% sampling (registration.cpp:113)
    t0 = time.perf_counter()
    tree = cKDTree(tgt)  # setTarget builds the kd-tree (:171-180)
    T = np.eye(4)
    for _ in range(REF_ITERS):
        sel = rng.choice(n, nr_samples, replace=False)
        p = src[sel] @ T[:3, :3].T + T[:3, 3]
        _, idx = tree.query(p)  # per-sample NN (:128)
        q = tgt[idx]
        nn = normals[idx]
        # point-to-plane linearization, SVD pseudo-inverse (:40-107)
        A = np.concatenate([np.cross(p, nn), nn], axis=1)
        b = np.sum(nn * (q - p), axis=1)
        x = np.linalg.pinv(A) @ b
        cx, cy, cz = np.cos(x[:3])
        sx, sy, sz = np.sin(x[:3])
        R = np.array(
            [
                [cy * cz, sx * sy * cz - cx * sz, cx * sy * cz + sx * sz],
                [cy * sz, sx * sy * sz + cx * cz, cx * sy * sz - sx * cz],
                [-sy, sx * cy, cx * cy],
            ]
        )
        dT = np.eye(4)
        dT[:3, :3] = R
        dT[:3, 3] = x[3:]
        T = dT @ T
    return T, time.perf_counter() - t0


def reference_cpu_icp_fps(src, tgt, normals):
    """Frames/s of reference_cpu_icp (one pair per call)."""
    return 1.0 / reference_cpu_icp(src, tgt, normals)[1]


CHAIN_LEN = 20  # consecutive scan-to-scan registrations per traced program


def make_chain(tgt, normals, seed=1):
    """A trajectory of CHAIN_LEN+1 scans: each scan is the previous one
    rigidly moved by a small per-step motion (the incremental-registration
    setting of registration.cpp — `setTarget` makes the previous scan the
    next target, :171-180).  Returns (scans (K+1,N,3), normals (K+1,N,3),
    true step transforms (K,4,4))."""
    from mapping_private_tpu.core.se3 import se3_exp
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    scans = [tgt.astype(np.float32)]
    nrms = [normals.astype(np.float32)]
    steps = []
    for _ in range(CHAIN_LEN):
        xi = rng.uniform(-1, 1, 6).astype(np.float32) * np.array(
            [0.05, 0.04, 0.03, 0.02, 0.02, 0.03], np.float32)
        T = np.asarray(se3_exp(jnp.asarray(xi)))
        # next scan = previous observed from the moved pose (inverse map)
        s_next = (scans[-1] - T[:3, 3]) @ T[:3, :3]
        n_next = nrms[-1] @ T[:3, :3]
        scans.append(s_next.astype(np.float32))
        nrms.append(n_next.astype(np.float32))
        steps.append(T)
    return np.stack(scans), np.stack(nrms), np.stack(steps)


def register_pair(tgt, nrm, src):
    """One scan pair: SRC_SAMPLES strided source points matched against
    the FULL target, ICP_ITERS sweeps.  Returns the (4,4) transform."""
    from mapping_private_tpu.registration.icp import icp_point_to_plane
    import jax.numpy as jnp

    stride = max(1, tgt.shape[0] // SRC_SAMPLES)
    sub = src[::stride]
    return icp_point_to_plane(
        sub, jnp.ones((sub.shape[0],), bool), tgt,
        jnp.ones((tgt.shape[0],), bool), nrm,
        iters=ICP_ITERS, max_corr_dist=0.5,
    ).transform


def register_chain(scans, nrms):
    """Registers scan k+1 onto scan k for every k of a (K+1, N, 3) chain
    as one lax.scan (jit it); returns the (K, 4, 4) step transforms."""
    import jax

    def body(_, pair):
        return None, register_pair(*pair)

    _, Ts = jax.lax.scan(body, None, (scans[:-1], nrms[:-1], scans[1:]))
    return Ts


def chain_icp_fps(src, tgt, normals):
    """Per-pair registration throughput over a CHAIN_LEN-step tracking
    chain compiled as ONE traced program (register_chain).  Each step
    matches SRC_SAMPLES source points (10× the reference's correspondence
    density) against the FULL previous scan — identical per-pair work to
    dispatching pairs one by one, without a dispatch per pair."""
    import jax
    import jax.numpy as jnp

    scans, nrms, steps_true = make_chain(tgt, normals)
    scans_j = jnp.asarray(scans)
    nrms_j = jnp.asarray(nrms)
    chain = jax.jit(register_chain)

    chain(scans_j, nrms_j).block_until_ready()  # compile + warmup
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        Ts = chain(scans_j, nrms_j).block_until_ready()
    dt = (time.perf_counter() - t0) / (reps * CHAIN_LEN)

    # per-dispatch protocol: ONE pair per jitted call, each rep waiting
    # for its result (the reference's per-message node dispatch)
    one_pair = jax.jit(register_pair)
    one_pair(scans_j[0], nrms_j[0], scans_j[1]).block_until_ready()
    reps1 = 50
    t0 = time.perf_counter()
    for _ in range(reps1):
        one_pair(scans_j[0], nrms_j[0], scans_j[1]).block_until_ready()
    fps_dispatch = reps1 / (time.perf_counter() - t0)

    return 1.0 / dt, fps_dispatch, np.asarray(Ts), steps_true


BATCH_PAIRS = 16


def batched_pairs_fps(tgt, normals, B=BATCH_PAIRS):
    """Deployment-shaped protocol: register B INDEPENDENT scan pairs in
    ONE dispatched program (lax.map over the pair axis — the pairs run
    in sequence inside the program), so one dispatch amortizes over B
    results — the analog of a perception node serving B concurrent
    streams, unlike the chain (which presupposes a known trajectory) and
    unlike per-dispatch.  Blocking timing: every rep waits for its
    results before the next dispatch.

    Returns (pairs_per_second, (B,4,4) transforms, (B,4,4) true)."""
    import jax
    import jax.numpy as jnp
    from mapping_private_tpu.core.se3 import se3_exp

    rng = np.random.default_rng(3)
    tgts, srcs, nrms, trues = [], [], [], []
    for b in range(B):
        # each stream: the shared scene under its own rigid step
        xi = rng.uniform(-1, 1, 6).astype(np.float32) * np.array(
            [0.05, 0.04, 0.03, 0.02, 0.02, 0.03], np.float32)
        T = np.asarray(se3_exp(jnp.asarray(xi)))
        tgts.append(tgt)
        nrms.append(normals)
        srcs.append((tgt - T[:3, 3]) @ T[:3, :3])
        trues.append(T)
    tgts = jnp.asarray(np.stack(tgts), jnp.float32)
    nrms_j = jnp.asarray(np.stack(nrms), jnp.float32)
    srcs = jnp.asarray(np.stack(srcs), jnp.float32)

    @jax.jit
    def batch(tgts_a, nrms_a, srcs_a):
        # lax.map, not vmap: the NN kernel is written for one unbatched
        # (N, 3) pair; sequencing pairs inside ONE program keeps it
        # unchanged and still amortizes the dispatch
        return jax.lax.map(lambda pair: register_pair(*pair),
                           (tgts_a, nrms_a, srcs_a))

    batch(tgts, nrms_j, srcs).block_until_ready()
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        Ts = batch(tgts, nrms_j, srcs).block_until_ready()
    dt = (time.perf_counter() - t0) / reps
    return B / dt, np.asarray(Ts), np.stack(trues)


def tiled_path_rows():
    """Big-cloud rows: a 200k compact-NN and a 200k 6-sweep tiled-ICP
    time (the 20k headline alone would let a tiled-path regression ship
    silently).  GPU only: the sizes are too large for a CPU run."""
    import jax
    import jax.numpy as jnp

    if jax.default_backend() != "gpu":
        return {}
    from mapping_private_tpu.ops.tiled_nn import (
        build_compact_tiles, compact_nn_1nn)
    from mapping_private_tpu.registration.icp import icp_point_to_plane_tiled

    rng = np.random.default_rng(0)
    N, tile, cap, MT = 200_000, 0.1, 128, 8192
    xy = rng.uniform(0, 5.0, (N, 2))
    z = 0.3 * np.sin(xy[:, 0] * 2) + 0.2 * np.cos(xy[:, 1] * 3) \
        + rng.normal(0, 0.005, N)
    tgt = np.column_stack([xy, z]).astype(np.float32)
    src = (tgt + rng.normal(0, 0.01, tgt.shape)).astype(np.float32)
    lo = tgt.min(0) - 0.2
    dims = tuple(int(v) for v in np.ceil((tgt.max(0) + 0.2 - lo) / tile))
    mask = jnp.ones((N,), bool)
    tgt_j, src_j = jnp.asarray(tgt), jnp.asarray(src)
    ct = build_compact_tiles(tgt_j, mask, lo, tile, dims, cap, MT)
    f_nn = jax.jit(lambda: compact_nn_1nn(
        ct, build_compact_tiles(src_j, mask, lo, tile, dims, cap, MT)))
    jax.block_until_ready(f_nn())
    t0 = time.perf_counter()
    for _ in range(5):
        out = f_nn()
    jax.block_until_ready(out)
    nn_ms = (time.perf_counter() - t0) / 5 * 1e3

    nrm = jnp.tile(jnp.asarray([0., 0., 1.], jnp.float32), (N, 1))
    r = icp_point_to_plane_tiled(src_j, mask, tgt_j, mask, nrm,
                                 tile_size=tile, cap_per_cell=cap, iters=6)
    jax.block_until_ready(r.transform)
    t0 = time.perf_counter()
    r = icp_point_to_plane_tiled(src_j, mask, tgt_j, mask, nrm,
                                 tile_size=tile, cap_per_cell=cap, iters=6)
    jax.block_until_ready(r.transform)
    icp_ms = (time.perf_counter() - t0) * 1e3
    return {"tiled_nn_200k_ms": nn_ms, "tiled_icp6_200k_ms": icp_ms}


def main():
    import jax

    src, tgt, normals, T_true = make_pair()
    ref_fps = reference_cpu_icp_fps(src, tgt, normals)

    fps, fps_dispatch, Ts, steps_true = chain_icp_fps(src, tgt, normals)
    # sanity: every chain step converged to its true step transform
    errs = np.linalg.norm(Ts - steps_true, axis=(1, 2))
    if errs.max() >= 0.05:
        raise RuntimeError(f"ICP diverged, max |T-T_true|={errs.max()}")

    # deployment-shaped batched protocol: B independent pairs per
    # blocking dispatch
    fps_batch, Tb, Tb_true = batched_pairs_fps(tgt, normals)
    berrs = np.linalg.norm(Tb - Tb_true, axis=(1, 2))
    if berrs.max() >= 0.05:
        raise RuntimeError(f"batched ICP diverged: {berrs.max()}")

    dev = jax.devices()[0]
    result = {
        "metric": "icp_registration",
        "value": round(fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps / ref_fps, 2),
        # value amortizes dispatch over a 20-pair traced chain (device
        # throughput); per_dispatch_fps waits for each pair; batch16
        # registers 16 INDEPENDENT pairs per blocking dispatch; the CPU
        # baseline divisor is per-pair wall-clock on this host
        "protocol": "chain20",
        "per_dispatch_fps": round(fps_dispatch, 2),
        "per_dispatch_vs_baseline": round(fps_dispatch / ref_fps, 2),
        f"batch{BATCH_PAIRS}_fps": round(fps_batch, 2),
        f"batch{BATCH_PAIRS}_vs_baseline": round(fps_batch / ref_fps, 2),
        "reference_cpu_fps": ref_fps,
        **tiled_path_rows(),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    from mapping_private_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()

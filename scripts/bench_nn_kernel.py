"""Exact brute-force 1-NN on the GPU: the Triton kernel (ops.pallas_nn)
against the plain XLA version (ops.neighbors.knn_bruteforce), alone and
end to end.

    python scripts/bench_nn_kernel.py [--sweep] [--out FILE]

Needs a GPU.  Prints the card's name and power limit, checks the kernel
against a float64 reference at each shape, then per shape the median
time of each version under jax.jit; then the 20-pair ICP chain of
bench.py and the scan-to-map tracking of chip_smoke.py with each NN
backend, in the order kernel, XLA, XLA, kernel.  ``--sweep`` first times
the kernel over a few block shapes.  Every time ends in a blocking read.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SHAPES = ((2_000, 20_000), (20_000, 20_000), (20_000, 65_536))
SWEEP = ((64, 64, 4, 2), (128, 64, 8, 2), (64, 128, 8, 2), (128, 32, 4, 2),
         (32, 128, 4, 2), (64, 64, 4, 1), (64, 64, 8, 3), (128, 128, 8, 2),
         (32, 64, 2, 2), (64, 32, 4, 2))


def _median_ms(fn, reps):
    import jax

    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts) * 1e3)


def _clouds(nq, nt, seed=0):
    rng = np.random.default_rng(seed)
    t = rng.uniform(-10, 10, (nt, 3)).astype(np.float32)
    q = (t[rng.integers(0, nt, nq)]
         + rng.normal(0, 0.05, (nq, 3))).astype(np.float32)
    return q, t


def _set_blocks(pallas_nn, tq, tn, warps, stages):
    import jax

    pallas_nn._TQ, pallas_nn._TN = tq, tn
    pallas_nn._NUM_WARPS, pallas_nn._NUM_STAGES = warps, stages
    pallas_nn._REF_QUANTUM = pallas_nn._MAX_SPLITS * tn
    jax.clear_caches()


def kernel_rows(sweep):
    import jax
    import jax.numpy as jnp
    from mapping_private_tpu.ops import pallas_nn
    from mapping_private_tpu.ops.neighbors import knn_bruteforce

    rows = []
    defaults = (pallas_nn._TQ, pallas_nn._TN, pallas_nn._NUM_WARPS,
                pallas_nn._NUM_STAGES)
    configs = SWEEP if sweep else (defaults,)
    kern = jax.jit(lambda q, t: pallas_nn.nn_argmin_prepared(
        q, pallas_nn.prepare_nn_ref_argmin(t)))
    xla = jax.jit(lambda q, t: knn_bruteforce(
        q, t, jnp.ones((t.shape[0],), bool), k=1))
    for nq, nt in SHAPES:
        q, t = _clouds(nq, nt)
        qj, tj = jnp.asarray(q), jnp.asarray(t)
        # exactness on a sample of queries against float64
        sub = np.random.default_rng(1).choice(nq, 512, replace=False)
        d2 = ((q[sub, None].astype(np.float64) - t[None]) ** 2).sum(-1)
        row = {"shape": [nq, nt]}
        for cfg in configs:
            _set_blocks(pallas_nn, *cfg)
            key = "kernel_%d_%d_w%d_s%d" % cfg
            try:
                idx, sq = kern(qj, tj)
                bad = int(np.sum(np.asarray(idx)[sub] != d2.argmin(1)))
                err = float(np.max(np.abs(np.asarray(sq)[sub] - d2.min(1))))
                row[key] = {"ms": _median_ms(lambda: kern(qj, tj), 20),
                            "idx_mismatch_512": bad, "max_d2_err": err}
            except Exception as e:  # a block shape the compiler refuses
                row[key] = {"error": f"{type(e).__name__}: {e}"[:300]}
            print(json.dumps({key: row[key], "shape": [nq, nt]}), flush=True)
        _set_blocks(pallas_nn, *defaults)
        mem = kern.lower(qj, tj).compile().memory_analysis()
        row["kernel_temp_bytes"] = getattr(mem, "temp_size_in_bytes", None)
        idx, sq = xla(qj, tj)
        bad = int(np.sum(np.asarray(idx)[sub, 0] != d2.argmin(1)))
        row["xla"] = {"ms": _median_ms(lambda: xla(qj, tj), 20),
                      "idx_mismatch_512": bad}
        mem = xla.lower(qj, tj).compile().memory_analysis()
        row["xla_temp_bytes"] = getattr(mem, "temp_size_in_bytes", None)
        print(json.dumps({"shape": [nq, nt], "xla": row["xla"],
                          "kernel_temp_bytes": row["kernel_temp_bytes"],
                          "xla_temp_bytes": row["xla_temp_bytes"]}),
              flush=True)
        rows.append(row)
    return rows


def end_to_end_rows():
    import jax
    import jax.numpy as jnp
    import bench
    import chip_smoke
    from mapping_private_tpu.ops import pallas_nn
    from mapping_private_tpu.registration.scan_to_map import TrackerConfig

    src, tgt, nrm, _ = bench.make_pair()
    scans, nrms, _ = bench.make_chain(tgt, nrm)
    scans_j, nrms_j = jnp.asarray(scans), jnp.asarray(nrms)
    truth, track_scans = chip_smoke._tracking_problem(
        chip_smoke.TRACK_SCANS, chip_smoke.TRACK_SCAN_POINTS)
    real = pallas_nn.use_gpu_kernel
    out = []
    for backend in ("pallas", "xla", "xla", "pallas"):
        pallas_nn.use_gpu_kernel = (lambda b=backend: b == "pallas")
        jax.clear_caches()
        chain = jax.jit(bench.register_chain)
        chain_ms = _median_ms(lambda: chain(scans_j, nrms_j), 5)
        cfg = TrackerConfig(nn_backend=backend)
        chip_smoke._track(cfg, track_scans)  # compile
        t0 = time.perf_counter()
        est, _ = chip_smoke._track(cfg, track_scans)
        track_s = time.perf_counter() - t0
        ate = float(np.sqrt(np.mean(np.sum(
            (est[:, :3, 3] - truth[:, :3, 3]) ** 2, -1))))
        row = {"backend": backend, "chain20_ms": chain_ms,
               "chain20_fps": bench.CHAIN_LEN / chain_ms * 1e3,
               "track10_s": track_s, "track10_ate_m": ate}
        print(json.dumps(row), flush=True)
        out.append(row)
    pallas_nn.use_gpu_kernel = real
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import jax

    if jax.default_backend() != "gpu":
        print("bench_nn_kernel: no GPU", file=sys.stderr)
        return 2
    from mapping_private_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {smi} | {jax.devices()[0].device_kind}", flush=True)
    result = {"card": smi, "kernel": kernel_rows(args.sweep),
              "end_to_end": end_to_end_rows()}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

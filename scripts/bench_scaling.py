"""Multi-chip scaling analysis — analytic, from the compiled program.

Round-3 verdict: wall-clock weak scaling on a VIRTUAL CPU mesh measures
nothing (all "devices" share the host's cores, so time/step degrades
~1/N however good the sharded program is).  What IS measurable without
N real chips, and what this harness now reports per device count:

1. **Collective traffic per step** — parsed from the compiled HLO:
   every all-gather/all-reduce/collective-permute instruction's output
   bytes.  This is the exact interconnect payload the program would move on
   hardware; for the scan-to-map step it should be the 7-float winner
   exchange (N·7·4·n_devices bytes gathered) + the 6×6 psum, i.e. KBs —
   a number a reader can check against the design.
2. **Per-device FLOPs + data balance** — XLA cost analysis of the
   per-device module (identical SPMD program on every device), plus the
   actual map-point/occupied-tile balance of the sharded data (the real
   skew risk for the tiled engine).
3. **Total-work throughput** — aggregate map points processed per
   second.  On the shared-host virtual mesh this stays ~flat as devices
   double (n× the work in the same host budget) — that flatness, not
   time/step, is the virtual-mesh sanity signal.

Usage:  python scripts/bench_scaling.py --cpu [--devices 1 2 4 8]
Writes SCALING.json at the repo root (not committed: its timings are
virtual-CPU-mesh numbers).
"""
import argparse
import json
import os
import re
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SHARD_POINTS = 65536
SCAN_POINTS = 2048
TILE = 0.15

_DTYPE_BYTES = {"f64": 8, "f32": 4, "bf16": 2, "f16": 2, "s32": 4,
                "u32": 4, "pred": 1, "s8": 1, "u8": 1, "s64": 8, "u64": 8}


def collective_bytes(hlo_text):
    """Sum output bytes of collective ops in an HLO module dump."""
    out = {}
    # HLO line shapes:
    #   `%all_gather.7 = f32[2,256,7]{2,1,0} all-gather(...)`       (sync)
    #   `%ag = (f32[256], f32[2,256]) all-gather-start(...)`        (async)
    # — capture the WHOLE result (scalar or tuple) before the mnemonic,
    # then sum every dtype[shape] element in it.  Async -start results
    # are (operand, result) pairs: count only the LAST element (the
    # result buffer) to avoid double-counting the operand; the matching
    # -done op aliases the same buffer and is skipped entirely.
    pat = re.compile(
        r"=\s*(\([^)]*\)|[a-z0-9]+\[[0-9,]*\]\S*)\s+"
        r"(all-gather|all-reduce|collective-permute|all-to-all|"
        r"reduce-scatter)(-start)?\(")
    elem = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
    for m in pat.finditer(hlo_text):
        result, op, is_start = m.group(1), m.group(2), m.group(3)
        elems = [(dt, shape) for dt, shape in elem.findall(result)
                 if dt in _DTYPE_BYTES]
        if not elems:
            continue
        if is_start and len(elems) >= 2:
            elems = elems[-1:]
        total = 0
        for dt, shape in elems:
            n = 1
            for d in shape.split(","):
                if d:
                    n *= int(d)
            total += n * _DTYPE_BYTES[dt]
        out[op] = out.get(op, 0) + total
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", nargs="*", type=int, default=None)
    ap.add_argument("--shard-points", type=int, default=SHARD_POINTS)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "SCALING.json"))
    ap.add_argument("--cpu", action="store_true",
                    help="force the virtual CPU mesh")
    args = ap.parse_args()

    if args.cpu:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count="
            + str(max(args.devices or [8])))
    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from mapping_private_tpu.parallel.mesh import make_mesh
    from mapping_private_tpu.parallel.distributed import (
        make_sharded_map_icp_step_tiled,
        size_map_lattice,
    )

    n_avail = len(jax.devices())
    dev_counts = args.devices or [n for n in (1, 2, 4, 8) if n <= n_avail]
    virtual = jax.default_backend() == "cpu"

    rng = np.random.default_rng(0)
    rows = []

    def measure(nd, map_xyz, scan, scene):
        M = len(map_xyz)
        nrm = np.tile(np.asarray([0, 0, 1.0], np.float32), (M, 1))
        mask = np.ones((M,), bool)
        origin, dims, cap, max_tiles = size_map_lattice(
            map_xyz, mask, TILE, scan_xyz=scan)
        mesh = make_mesh((nd,), axis_names=("mp",))
        step, shardings = make_sharded_map_icp_step_tiled(
            mesh, origin, TILE, dims, cap, max_tiles,
            q_cap=32, q_max_tiles=4096)
        a = [
            jnp.asarray(scan), jnp.ones((SCAN_POINTS,), bool),
            jnp.asarray(map_xyz), jnp.asarray(mask), jnp.asarray(nrm),
            jnp.eye(4),
        ]
        a = [jax.device_put(x, s) for x, s in zip(a, shardings)]

        # ---- analytic: compiled-module cost + collective payloads ----
        lowered = jax.jit(step).lower(*a)
        compiled = lowered.compile()
        try:
            cost = compiled.cost_analysis()
            cost = cost[0] if isinstance(cost, (list, tuple)) else cost
            flops_dev = float(cost.get("flops", float("nan")))
        except Exception:
            flops_dev = float("nan")
        coll = collective_bytes(compiled.as_text())

        # ---- data balance across shards (the tiled engine's skew) ----
        bounds = np.linspace(0, M, nd + 1, dtype=np.int64)
        pts_per_shard = np.diff(bounds)
        cell = np.floor((map_xyz - np.asarray(origin)) / TILE).astype(np.int64)
        flat = (cell[:, 0] * dims[1] + cell[:, 1]) * dims[2] + cell[:, 2]
        occ_per_shard = [
            len(np.unique(flat[bounds[i]:bounds[i + 1]])) for i in range(nd)]
        occ_balance = (float(np.mean(occ_per_shard))
                       / max(float(np.max(occ_per_shard)), 1.0))

        # ---- wall clock (virtual mesh: total-work throughput only) ----
        T, cnt = step(*a)
        jax.block_until_ready(T)
        t0 = time.time()
        for _ in range(args.reps):
            T, cnt = step(*a)
        jax.block_until_ready(T)
        dt = (time.time() - t0) / args.reps

        rows.append(dict(
            scene=scene,
            devices=nd,
            map_points=M,
            flops_per_device=flops_dev,
            flop_balance=1.0,  # SPMD: every device runs the same module
            occupied_tile_balance=round(occ_balance, 3),
            worst_shard_occupied_tiles=int(np.max(occ_per_shard)),
            max_tiles_static=int(max_tiles),
            points_per_shard_balance=round(
                float(pts_per_shard.mean() / pts_per_shard.max()), 3),
            collective_bytes_per_step=coll,
            collective_total_kb=round(sum(coll.values()) / 1024.0, 2),
            step_ms=round(dt * 1e3, 2),
            total_work_Mpts_per_s=round(M / dt / 1e6, 2),
        ))
        print(rows[-1], flush=True)

    for nd in dev_counts:
        M = nd * args.shard_points
        xy = rng.uniform(0, np.sqrt(M / 8000.0) * 3.0, (M, 2))
        z = 0.3 * np.sin(2 * xy[:, 0]) + rng.normal(0, 0.005, M)
        map_xyz = np.column_stack([xy, z]).astype(np.float32)
        scan = map_xyz[rng.choice(M, SCAN_POINTS, replace=False)] + 0.01
        measure(nd, map_xyz, scan, "uniform")

    # ---- skew stress (round-4 verdict item 8): corridor + dense cluster,
    # spatially-ordered rows, so contiguous row-block shards see wildly
    # different occupied-tile counts — first raw, then with the
    # occupancy-balancing permutation (parallel.balance_map_shards)
    from mapping_private_tpu.parallel.distributed import balance_map_shards

    nd = max(dev_counts)
    M = nd * args.shard_points
    n_cor = M // 4
    corridor = np.column_stack([
        rng.uniform(0, 30.0, n_cor), rng.uniform(0, 1.0, n_cor),
        rng.uniform(0, 0.5, n_cor)])
    cluster = rng.normal([33.0, 0.5, 0.25], 0.4, (M - n_cor, 3))
    skew_xyz = np.vstack([corridor, cluster]).astype(np.float32)
    skew_scan = skew_xyz[rng.choice(M, SCAN_POINTS, replace=False)] + 0.01
    measure(nd, skew_xyz, skew_scan, "skewed-corridor+cluster")
    perm = balance_map_shards(skew_xyz, np.ones(M, bool), TILE, nd)
    measure(nd, skew_xyz[perm], skew_scan, "skewed-balanced-perm")

    out = dict(
        metric=("sharded scan-to-map ICP (compact-tiles engine): analytic "
                "per-device cost, collective payload per step, data "
                "balance, total-work throughput"),
        method=(
            "flops_per_device: XLA cost analysis of the compiled SPMD "
            "per-device module (identical on every device, so FLOP "
            "balance is 1.0 by construction). collective_bytes_per_step: "
            "output bytes of every all-gather/all-reduce in the compiled "
            "HLO — the exact interconnect payload on hardware. "
            "occupied_tile_balance: mean/max occupied lattice tiles over "
            "map shards (the tiled NN engine's real skew risk). The "
            "skewed-corridor+cluster rows stress it: per-shard COMPUTE "
            "is static-shaped (same padded stencil program on every "
            "device), so runtime does not crater with skew — the cost "
            "of imbalance is SIZING (max_tiles_static must cover the "
            "worst shard's occupancy; worst_shard_occupied_tiles tracks "
            "it), and parallel.balance_map_shards (round-robin deal in "
            "tile order) restores balance ~1.0 as the "
            "skewed-balanced-perm row shows. "
            "total_work_Mpts_per_s: aggregate map points per wall-clock "
            "second; on a shared-host virtual mesh this staying ~flat as "
            "devices double is the expected signature of a well-sharded "
            "program (time/step MUST degrade ~1/N there, which is why "
            "wall-clock weak-scaling efficiency was dropped — it cannot "
            "distinguish a good sharded program from a bad one without "
            "N real chips)."),
        shard_points=args.shard_points, scan_points=SCAN_POINTS,
        tile_size=TILE,
        backend=jax.default_backend(),
        virtual_mesh=virtual,
        rows=rows,
    )
    with open(args.out, "w") as fp:
        json.dump(out, fp, indent=1)
    print("wrote", args.out)


if __name__ == "__main__":
    main()

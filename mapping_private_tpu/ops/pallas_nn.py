"""Exact brute-force 1-NN on the GPU — a running-argmin kernel written in
Pallas for its Triton route.

The plain XLA version (``ops.neighbors.knn_bruteforce``) takes its cross
term from a K=3 matrix product whose (Q, N) float32 output goes to device
memory before the argmin reads it back: 5.2 GB each way per sweep at
20k × 65k, the scan-to-map shape.  This kernel never forms that matrix.
Each program owns a tile of queries and walks a range of reference
chunks, keeping a per-slot running (min, chunk) pair in registers; one
reduction at the end picks each query's winner.  It reads the two clouds
and writes (splits, Q) candidates, which a second XLA pass reduces.

Exact: distances are broadcast differences in float32 (no
‖a‖² + ‖b‖² − 2a·b cancellation), so near-ties rank as they do in float64
up to a few ulps, and exact ties go to the lowest reference index, as in
numpy's argmin.

Padding convention: reference rows that are dead or padding carry
+PAD_COORD and dead queries carry −PAD_COORD (core.cloud), so padding
never wins a min and dead queries match nothing that matters.

Replaces the kd-tree NN on the ICP path (reference
cloud_algos/src/registration.cpp:128 `nearestKSearch`).
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from mapping_private_tpu.core.cloud import PAD_COORD

# Block sizes are powers of two, as Triton requires.  Chosen on an H100
# (`scripts/bench_nn_kernel.py --sweep`: within 10 % of the best of ten
# shapes at 2k×20k, 20k×20k and 20k×65k); not re-tuned per shape.
_TQ = 64  # query rows per program
_TN = 64  # reference columns per loop step
_NUM_WARPS = 4
_NUM_STAGES = 2
# Blocks run in parallel in no order, so the reference range is split
# over a second grid axis when there are too few query tiles to fill the
# card (an H100 has 132 SMs); a second pass takes the min over splits.
# The split targets are unmeasured guesses.
_MAX_SPLITS = 16
_TARGET_PROGRAMS = 512
# prepare_nn_ref_argmin pads N to this, so every split count divides it
_REF_QUANTUM = _MAX_SPLITS * _TN
_NO_INDEX = 2 ** 31 - 1


def use_gpu_kernel() -> bool:
    """The one platform decision: the Triton kernel runs on a GPU, the
    plain XLA path everywhere else."""
    return jax.default_backend() == "gpu"


def _argmin_kernel(qx_ref, qy_ref, qz_ref, rx_ref, ry_ref, rz_ref,
                   d_ref, i_ref, *, tq, tn, chunks_per_split):
    c0 = pl.program_id(1) * chunks_per_split
    qx = qx_ref[...][:, None]
    qy = qy_ref[...][:, None]
    qz = qz_ref[...][:, None]

    def step(c, carry):
        best_d, best_c = carry
        cols = pl.ds((c0 + c) * tn, tn)
        dx = qx - rx_ref[cols][None, :]
        dy = qy - ry_ref[cols][None, :]
        dz = qz - rz_ref[cols][None, :]
        d2 = dx * dx + dy * dy + dz * dz
        better = d2 < best_d  # strict: the earlier chunk keeps ties
        return (jnp.where(better, d2, best_d),
                jnp.where(better, c0 + c, best_c))

    best_d, best_c = jax.lax.fori_loop(
        0, chunks_per_split, step,
        (jnp.full((tq, tn), jnp.inf, jnp.float32),
         jnp.zeros((tq, tn), jnp.int32)))
    d_min = jnp.min(best_d, axis=1)
    col = best_c * tn + jax.lax.broadcasted_iota(jnp.int32, (tq, tn), 1)
    d_ref[...] = d_min
    i_ref[...] = jnp.min(
        jnp.where(best_d == d_min[:, None], col, _NO_INDEX), axis=1)


def prepare_nn_ref_argmin(ref_xyz: jax.Array) -> jax.Array:
    """(N, 3) → (3, N′) coordinate planes padded with +PAD_COORD to a
    multiple of the split quantum.  Hoist it out of loops: XLA does not
    reliably lift it out of a scan body."""
    r_n = ref_xyz.shape[0]
    rp = -(-r_n // _REF_QUANTUM) * _REF_QUANTUM
    return jnp.full((3, rp), PAD_COORD, jnp.float32).at[:, :r_n].set(
        ref_xyz.T.astype(jnp.float32))


def _num_splits(n_query_tiles: int) -> int:
    splits = 1
    while splits < _MAX_SPLITS and n_query_tiles * splits < _TARGET_PROGRAMS:
        splits *= 2
    return splits


@functools.partial(jax.jit, static_argnames=("interpret",))
def nn_argmin_prepared(
    query_xyz: jax.Array, rt: jax.Array, interpret: bool = False
) -> Tuple[jax.Array, jax.Array]:
    """Exact 1-NN: (Q, 3), (3, N′) planes → (idx (Q,) int32, sq (Q,) f32).

    ``rt`` comes from prepare_nn_ref_argmin.  Dead queries must carry
    −PAD_COORD; gather the winners with plain XLA takes."""
    q_n = query_xyz.shape[0]
    rp = rt.shape[1]
    if rp % _REF_QUANTUM:
        raise ValueError("rt must come from prepare_nn_ref_argmin")
    qp = -(-q_n // _TQ) * _TQ
    q = jnp.full((3, qp), -PAD_COORD, jnp.float32).at[:, :q_n].set(
        query_xyz.T.astype(jnp.float32))
    n_qt = qp // _TQ
    splits = _num_splits(n_qt)
    kernel = functools.partial(
        _argmin_kernel, tq=_TQ, tn=_TN,
        chunks_per_split=rp // (_TN * splits))
    q_spec = pl.BlockSpec((_TQ,), lambda i, s: (i,))
    r_spec = pl.BlockSpec((rp,), lambda i, s: (0,))
    out_spec = pl.BlockSpec((_TQ,), lambda i, s: (s * n_qt + i,))
    d, i = pl.pallas_call(
        kernel,
        grid=(n_qt, splits),
        in_specs=[q_spec] * 3 + [r_spec] * 3,
        out_specs=[out_spec, out_spec],
        out_shape=[jax.ShapeDtypeStruct((splits * qp,), jnp.float32),
                   jax.ShapeDtypeStruct((splits * qp,), jnp.int32)],
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=_NUM_WARPS, num_stages=_NUM_STAGES),
        interpret=interpret,
        name="nn_argmin",
    )(q[0], q[1], q[2], rt[0], rt[1], rt[2])
    # second pass over splits: argmin takes the first (lowest-index) split
    d = d.reshape(splits, qp)
    i = i.reshape(splits, qp)
    win = jnp.argmin(d, axis=0)
    idx = jnp.take_along_axis(i, win[None, :], axis=0)[0]
    return idx[:q_n], jnp.min(d, axis=0)[:q_n]

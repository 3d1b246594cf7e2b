"""N-lane max-plus trellis step as a Pallas kernel for the GPU (Triton route).

One call computes, for N independent lanes sharing one transition block,

    val[n, i] = max_k ( delta[n, k] + logA[k, i] )
    arg[n, i] = lowest k attaining the max

which is ``ops.maxplus.maxplus_step`` without the emission term, for every
lane at once.  ``logA`` may be rectangular ``(K, Kd)``: the state-sharded
path (``parallel.sharded``) calls it on its local column block.

Why a kernel: XLA's reduction emitter computes each ``(n, i)`` output of
``vmap(maxplus_step)`` on its own, so the ``(K, K)`` transition matrix is
streamed once per lane.  Here each block loads a ``(BK, BI)`` tile of
``logA`` once and updates the running (max, argmax) of all its lanes, so
lanes that share a block share the stream.

Grid ``(dest tiles, source splits, lane groups)``.  The source axis is cut
into ``splits`` contiguous ranges so that a few thousand destination
columns still fill every SM; each split writes a partial (max, argmax)
pair and :func:`combine_splits` reduces them in ascending split order.

Tie contract: inside a tile ``argmax`` keeps the lowest index, tiles are
visited in ascending order and replace the running pair only on a strictly
greater value, and splits combine by first occurrence, so on equal scores
the lowest source index wins, as ``jnp.argmax`` does.  Rows and columns
past the array ends are masked with ``-inf``; an all ``-inf`` column keeps
the lowest index of its split, hence index 0 after the combine.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

NEG_INF = np.float32(-np.inf)  # numpy scalar: no backend init at import


@dataclasses.dataclass(frozen=True)
class StepTiles:
    """Block shape of one kernel launch.  All sizes are powers of two."""

    cols: int = 128    # BI: destination columns per block
    rows: int = 16     # BK: source rows per loop iteration
    lanes: int = 8     # NB: lanes per block
    splits: int = 4    # contiguous source ranges, one block each
    num_warps: int = 4
    num_stages: int = 3


def default_tiles(n_lanes: int) -> StepTiles:
    """The tiles measured fastest on an H100 at K=3968 and K=16384 (see
    PERF.md): one lane streams tall tiles over 8 source splits; a few
    lanes share (32, 128) tiles; from 8 lanes up, groups of 8 lanes share
    (16, 128) tiles."""
    if n_lanes <= 1:
        return StepTiles(rows=64, lanes=1, splits=8)
    if n_lanes < 8:
        return StepTiles(rows=32, lanes=4 if n_lanes >= 4 else 2)
    return StepTiles()


def _step_kernel(delta_ref, logA_ref, val_ref, arg_ref, *, K: int, Kd: int,
                 N: int, span: int, t: StepTiles):
    i = pl.program_id(0)
    s = pl.program_id(1)
    g = pl.program_id(2)
    BI, BK, NB = t.cols, t.rows, t.lanes
    cols = i * BI + jnp.arange(BI)
    cmask = cols < Kd
    lanes = g * NB + jnp.arange(NB)
    lmask = lanes < N
    k_lo = s * span

    def body(j, carry):
        best_v, best_a = carry
        k0 = k_lo + j * BK
        rmask = (k0 + jnp.arange(BK)) < K
        tile = plgpu.load(logA_ref.at[pl.ds(k0, BK), pl.ds(i * BI, BI)],
                          mask=rmask[:, None] & cmask[None, :],
                          other=NEG_INF).astype(jnp.float32)      # (BK, BI)
        d = plgpu.load(delta_ref.at[pl.ds(g * NB, NB), pl.ds(k0, BK)],
                       mask=lmask[:, None] & rmask[None, :],
                       other=NEG_INF)                             # (NB, BK)
        scores = d[:, :, None] + tile[None, :, :]                # (NB, BK, BI)
        v = jnp.max(scores, axis=1)
        a = jnp.argmax(scores, axis=1).astype(jnp.int32) + k0
        better = v > best_v  # strict: the earlier (lower-k) tile keeps ties
        return jnp.where(better, v, best_v), jnp.where(better, a, best_a)

    init = (jnp.full((NB, BI), NEG_INF, jnp.float32),
            jnp.full((NB, BI), k_lo, jnp.int32))
    best_v, best_a = jax.lax.fori_loop(0, span // BK, body, init)
    omask = lmask[:, None] & cmask[None, :]
    plgpu.store(val_ref.at[s, pl.ds(g * NB, NB), pl.ds(i * BI, BI)], best_v,
                mask=omask)
    plgpu.store(arg_ref.at[s, pl.ds(g * NB, NB), pl.ds(i * BI, BI)], best_a,
                mask=omask)


def combine_splits(vals, args):
    """(S, N, Kd) partial pairs -> (N, Kd) (max, argmax); the first split
    holding the max wins, so the lowest source index is kept on ties."""
    if vals.shape[0] == 1:
        return vals[0], args[0]
    sel = jnp.argmax(vals, axis=0)
    val = jnp.max(vals, axis=0)
    arg = jnp.take_along_axis(args, sel[None], axis=0)[0]
    return val, arg


@functools.partial(jax.jit, static_argnames=("tiles", "interpret"))
def maxplus_lanes_triton(delta, logA, tiles: StepTiles | None = None,
                         interpret: bool = False):
    """(N, K) fp32 lanes x (K, Kd) fp32 block -> ((N, Kd) max, (N, Kd) int32
    argmax).  ``interpret=True`` runs the kernel body on the CPU (tests)."""
    N, K = delta.shape
    K2, Kd = logA.shape
    if K2 != K:
        raise ValueError(f"delta has {K} sources, logA {K2}")
    t = tiles or default_tiles(N)
    splits = max(1, min(t.splits, -(-K // t.rows)))
    span = -(-(-(-K // splits)) // t.rows) * t.rows  # rows per split, tiled
    grid = (-(-Kd // t.cols), splits, -(-N // t.lanes))
    kernel = functools.partial(_step_kernel, K=K, Kd=Kd, N=N, span=span, t=t)
    vals, args = pl.pallas_call(
        kernel,
        out_shape=(jax.ShapeDtypeStruct((splits, N, Kd), jnp.float32),
                   jax.ShapeDtypeStruct((splits, N, Kd), jnp.int32)),
        grid=grid,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=t.num_warps,
                                             num_stages=t.num_stages),
        interpret=interpret,
        name="maxplus_lanes",
    )(delta.astype(jnp.float32), logA)
    return combine_splits(vals, args)

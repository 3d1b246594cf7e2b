"""Fused full-state decoder: one forward pass with a full pointer table.

The forward recursion runs over all T steps, materializing the (T, K)
pointer table; backtrack is a reverse scan of O(1) gathers.  Decoded
paths are bit-identical to ``vanilla`` (same framework numerics contract,
verified in tests).  :func:`fused_decode_batch` runs a whole batch as the
lanes of one step, so with the Triton step the sequences share one
``logA`` stream per trellis step.

Capability mapping vs the reference: this covers the *performance* role of
FLASH (``src/FLASH_Viterbi_multithread.c``) at moderate T — the full
pointer table at K=4096, T=256 is 4 MB of device memory, so the
reference's two-phase anchor scheme buys nothing; the phases collapse into
one pass.  The O(N*K)-memory FLASH semantics (for long T) live in
``algorithms.flash``; the sharded multi-card path in ``parallel.sharded``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops import maxplus as mp
from .base import Decoder, register


def fused_decode(logA, logB, logPi, y, use_pallas: bool | str = "auto",
                 precision: str = "fp32"):
    """One sequence: the one-lane case of :func:`fused_decode_batch`.

    ``precision="bf16"`` halves the logA stream by quantizing the
    transition matrix to bfloat16 — an *approximate* mode: the path's
    log-likelihood stays close to optimal, but the state sequence itself
    can differ substantially (Viterbi reroutes on tiny score
    perturbations).  The default fp32 mode is the exact-parity contract."""
    return fused_decode_batch(logA, logB, logPi, y[None], use_pallas=use_pallas,
                              precision=precision)[0]


def fused_decode_batch(logA, logB, logPi, ys, use_pallas: bool | str = "auto",
                       precision: str = "fp32"):
    """Decode a whole (BATCH, T) batch, one lane per sequence.

    Returns (BATCH, T) paths identical to per-sequence ``fused_decode``.
    ``use_pallas`` chooses the Triton step (``ops.maxplus.use_kernel_for``).
    """
    if precision == "bf16":
        logA = logA.astype(jnp.bfloat16)
    emits = jnp.transpose(logB[:, ys], (2, 1, 0))  # (K,Bs,T) -> (T,Bs,K)
    delta0 = logPi[None, :] + emits[0]

    def step(d, e):
        val, arg = mp.maxplus_lanes(d, logA, use_pallas)
        return val + e, arg

    dfin, ptrs = jax.lax.scan(step, delta0, emits[1:])
    last = jnp.argmax(dfin, axis=1).astype(jnp.int32)  # (Bs,)
    return jax.vmap(mp.backtrack, in_axes=(1, 0))(ptrs, last)  # (Bs, T)


def _memory(K: int, T: int, **_) -> int:
    # full pointer table + delta carry and step outputs
    return T * K * 4 + 4 * K * 4


@register("fused")
def _build(use_pallas: bool | str = "auto", precision: str = "fp32",
           **static) -> Decoder:
    def fn(logA, logB, logPi, y):
        return fused_decode(logA, logB, logPi, y, use_pallas=use_pallas,
                            precision=precision)

    return Decoder("fused", fn, {"use_pallas": use_pallas,
                                 "precision": precision, **static}, _memory)

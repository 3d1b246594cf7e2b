"""Checkpoint (sqrt-T) Viterbi: O(K*sqrt(T)) memory via recompute-backtrack.

Capability parity with ``Base_line/C implementations/checkpoint Viterbi.c``
(:122-251): the forward pass keeps only K-vector snapshots every
``step = floor(sqrt(T))`` positions; the backward phase re-runs the DP inside
each segment (storing that segment's pointer table only) and backtracks,
sequentially from the last segment to the first.

Shape discipline: time is padded to ``C*step`` with masked no-op steps
and identity pointer rows, so both phases are fixed-shape ``lax.scan``s
(outer scan over segments, inner over steps) — ``jax.checkpoint``-style
recompute without dynamic shapes.  It is the long-T single-card decoder:
no (T, K) pointer table exists at any point.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from ..ops import maxplus as mp
from .base import Decoder, register


def checkpoint_decode(logA, logB, logPi, y, step: int = 0):
    T = y.shape[0]
    K = logA.shape[0]
    if step <= 0:
        step = int(math.floor(math.sqrt(T)))
    C = (T + step - 1) // step  # segments starting at 0, step, 2*step, ...
    Tp = C * step + 1

    emits = logB[:, y].T  # (T, K)
    pad = jnp.broadcast_to(emits[-1], (Tp - T, K))
    emits_p = jnp.concatenate([emits, pad])  # (Tp, K); padded rows masked off
    delta0 = logPi + emits[0]
    iota = jnp.arange(K, dtype=jnp.int32)

    seg_emits = emits_p[1:].reshape(C, step, K)
    seg_valid = (jnp.arange(1, Tp) < T).reshape(C, step)

    # ---- forward: snapshots at segment starts --------------------------------
    def fwd_seg(delta, x):
        e, v = x

        def fwd_step(d, xx):
            ee, vv = xx
            dn = mp.maxplus_step_noptr(d, logA, ee)
            return jnp.where(vv, dn, d), None

        d_end, _ = jax.lax.scan(fwd_step, delta, (e, v))
        return d_end, delta  # emit the snapshot at this segment's *start*

    delta_final, snaps = jax.lax.scan(fwd_seg, delta0, (seg_emits, seg_valid))
    last = mp.argmax_final(delta_final)

    # ---- backward: per-segment recompute + backtrack -------------------------
    def bwd_seg(state, x):
        snap, e, v = x

        def fwd_step(d, xx):
            ee, vv = xx
            dn, p = mp.maxplus_step(d, logA, ee)
            return jnp.where(vv, dn, d), jnp.where(vv, p, iota)

        _, ptrs = jax.lax.scan(fwd_step, snap, (e, v))  # (step, K)
        prev, path = jax.lax.scan(
            lambda s, row: (row[s], row[s]), state, ptrs, reverse=True
        )
        return prev, path  # path: states at local times 0..step-1 shifted by -1?

    _, paths = jax.lax.scan(
        bwd_seg, last, (snaps, seg_emits, seg_valid), reverse=True
    )
    # paths[c, j] = state at time c*step + j   (identity rows make states past
    # T-1 equal ``last``), and the final state itself:
    full = jnp.concatenate([paths.reshape(-1), last[None]])
    return full[:T]


def _memory(K: int, T: int, step: int = 0, **_) -> int:
    """Reference-exact (checkpoint Viterbi.c:250): sizeof(T1_previous) +
    sizeof(T1) + sizeof(T1_current) + sizeof(checkpoints) + the max
    backward-subroutine tables sizeof(T1_sub)+sizeof(T2_sub), where
    T_sub = this_step + (count != T-1)."""
    if step <= 0:
        step = int(math.floor(math.sqrt(T)))
    checkpoints = list(range(0, T, step))
    C = len(checkpoints)
    subs = []
    count_first = True
    for i in range(C - 1, -1, -1):
        this_step = step if i != C - 1 else T - checkpoints[C - 1]
        t_sub = this_step + (0 if count_first else 1)
        count_first = False
        subs.append(8 * K * t_sub)
    # T1_previous[K] + snapshot matrix T1[K][C] + T1_current[K]
    # + checkpoints[T/step+1] + max subroutine tables (:188-250)
    return 2 * 4 * K + 4 * K * C + 4 * (T // step + 1) + max(subs)


@register("checkpoint")
def _build(step: int = 0, **static) -> Decoder:
    def fn(logA, logB, logPi, y):
        return checkpoint_decode(logA, logB, logPi, y, step=step)

    return Decoder("checkpoint", fn, {"step": step, **static}, _memory)

"""FLASH-BS Viterbi: top-k beam pruning over the anchored decode.

The reference (``src/FLASH_BS_Viterbi_multithread.c``) maintains the beam as
a size-B min-heap with sequential insert/replace-min ops (:50-211) — a CPU
memory-frugality device, not semantics.  Redesign (SURVEY.md §7): the
beam is ``jax.lax.top_k`` of the dense score vector; one step gathers the B
beam rows of ``logA`` and does a (B, K) max-plus sweep — O(K*B) work per
step with fully static shapes.

Semantics vs the reference (documented deltas, SURVEY.md §3.6):

* beam *membership* matches (top-B by score, ties keep the lowest state
  index — the heap's strict-``>`` replacement does the same);
* intra-step argmax tie-breaks differ (our beam is score-sorted, the heap
  array is heap-ordered) — only matters on exact fp32 score ties;
* the reference's final-argmax leaf-scan quirk (:376-381) is not reproduced
  here (we take the true beam best); the bit-exact heap behavior lives in
  ``oracle.reference.flash_bs``;
* when a segment's forced end state fell out of the segment's final beam the
  reference emits -1 (``Find_T3_State`` :73-86); we do the same.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .base import Decoder, register
from .flash import flash_midpoints, prop_schedule, segment_layout


def beam_topk(full_scores: jax.Array, B: int):
    """(vals, states): top-B scores, descending, lowest index on ties."""
    vals, states = jax.lax.top_k(full_scores, B)
    return vals, states.astype(jnp.int32)


def beam_step(vals, states, logA, emit):
    """One beam trellis step.

    Args:
      vals: (B,) fp32 beam scores at t-1;  states: (B,) int32 beam states.
      emit: (K,) log emission column at t.

    Returns:
      (full (K,) fp32 scores for every destination state,
       best_slot (K,) int32 argmax beam slot per destination).
    """
    rows = logA[states]  # (B, K)
    scores = vals[:, None] + rows
    return jnp.max(scores, axis=0) + emit, jnp.argmax(scores, axis=0).astype(jnp.int32)


def _phase1_beam(logA, logPi, emits, mids, B: int):
    """Multi-anchor beam forward pass (reference nvviterNdivide :295-399)."""
    T, K = emits.shape
    P = len(mids)
    full0 = logPi + emits[0]
    vals0, states0 = beam_topk(full0, B)
    planes0 = jnp.full((P, B), -1, dtype=jnp.int32)
    prop = prop_schedule(mids, T)

    def step(carry, x):
        vals, states, planes = carry
        emit, pr = x
        full, slot = beam_step(vals, states, logA, emit)
        nv, ns = beam_topk(full, B)
        best_slot = slot[ns]  # (B,) winning old-beam slot per new beam entry
        if P:
            moved = jnp.take_along_axis(planes, best_slot[None, :], axis=1)
            rec = states[best_slot][None, :]
            planes = jnp.where(pr[:, None], moved, rec)
        return (nv, ns, planes), None

    (vals, states, planes), _ = jax.lax.scan(
        step, (vals0, states0, planes0), (emits[1:], jnp.asarray(prop))
    )
    last = states[0]  # beam is score-sorted: slot 0 is the global best
    anchors = planes[:, 0] if P else jnp.zeros((0,), jnp.int32)
    return last, anchors


def _segment_beam(logA, logPi, seg_emits, init_state, is_first, end_state, nsteps, B: int):
    """Forced-boundary beam decode of one segment, pointer tables in beam
    space (O(L*B) memory).  Returns (Lmax,) states (or -1 on beam fallout)."""
    Lmax, K = seg_emits.shape
    safe = jnp.maximum(init_state, 0)
    full0 = jnp.where(is_first, logPi, logA[safe]) + seg_emits[0]
    vals0, states0 = beam_topk(full0, B)
    iota_b = jnp.arange(B, dtype=jnp.int32)

    def step(carry, x):
        vals, states = carry
        emit, valid = x
        full, slot = beam_step(vals, states, logA, emit)
        nv, ns = beam_topk(full, B)
        bs = slot[ns]
        nv = jnp.where(valid, nv, vals)
        ns = jnp.where(valid, ns, states)
        bs = jnp.where(valid, bs, iota_b)
        return (nv, ns), (ns, bs)

    valid = jnp.arange(1, Lmax) <= nsteps
    (_, states_f), (states_hist, slot_ptrs) = jax.lax.scan(
        step, (vals0, states0), (seg_emits[1:], valid)
    )
    states_hist = jnp.concatenate([states0[None], states_hist])  # (Lmax, B)

    match = states_f == end_state
    found = jnp.any(match)
    end_slot = jnp.argmax(match).astype(jnp.int32)

    def walk(slot, ptr_row):
        prev = ptr_row[slot]
        return prev, prev

    first_slot, slots = jax.lax.scan(walk, end_slot, slot_ptrs, reverse=True)
    slots = jnp.concatenate([slots, end_slot[None]])  # (Lmax,)
    path = jnp.take_along_axis(states_hist, slots[:, None], axis=1)[:, 0]
    return jnp.where(found, path, -1)


def flash_bs_decode(logA, logB, logPi, y, beam_width: int, num_segments: int = 8):
    T = y.shape[0]
    K = int(logA.shape[0])
    B = min(int(beam_width), K)  # clamp: beam cannot exceed K
    N = int(num_segments)
    if N < 1 or T < 2 * N:
        N = max(1, min(N, T // 2)) or 1
    emits = logB[:, y].T

    mids = flash_midpoints(0, T - 1, N) if N > 1 else []
    last, anchors = _phase1_beam(logA, logPi, emits, mids, B)

    starts_l, lens_l, Lmax = segment_layout(mids, T)
    starts = jnp.asarray(starts_l, jnp.int32)
    lens = jnp.asarray(lens_l, jnp.int32)

    idx = jnp.minimum(starts[:, None] + jnp.arange(Lmax)[None, :], T - 1)
    seg_emits = emits[idx]
    init_states = jnp.concatenate([jnp.zeros((1,), jnp.int32), anchors])
    end_states = jnp.concatenate([anchors, last[None]])
    is_first = jnp.arange(len(starts_l)) == 0

    paths = jax.vmap(_segment_beam, in_axes=(None, None, 0, 0, 0, 0, 0, None))(
        logA, logPi, seg_emits, init_states, is_first, end_states, lens - 1, B
    )
    pos = starts[:, None] + jnp.arange(Lmax)[None, :]
    pos = jnp.where(jnp.arange(Lmax)[None, :] < lens[:, None], pos, T)
    return jnp.zeros((T,), jnp.int32).at[pos.reshape(-1)].set(paths.reshape(-1), mode="drop")


def _memory(K: int, T: int, beam_width: int = 64, num_segments: int = 8, **_) -> int:
    """Reference-exact (FLASH_BS_Viterbi_multithread.c:548-576):
    max(phase-1 heap planes, per-thread heap double buffers) +
    sizeof(ThreadPool) + the sizeof-of-expression bug (+8).
    element = {float, int, int} = 12 bytes."""
    from .flash import _threadpool_sizeof

    B, N = min(beam_width, K), max(1, num_segments)
    phase1 = 0
    if N > 2 and T >= 2 * N:
        phase1 = (N - 1) * 4 + 2 * (N - 1) * (B + 1) * 12
    tmp = N * 2 * (B + 1) * 12
    return max(phase1, tmp) + _threadpool_sizeof(N) + 8


@register("flash_bs")
def _build(beam_width: int = 64, num_segments: int = 8, **static) -> Decoder:
    def fn(logA, logB, logPi, y):
        return flash_bs_decode(logA, logB, logPi, y, beam_width=beam_width,
                               num_segments=num_segments)

    return Decoder(
        "flash_bs", fn, {"beam_width": beam_width, "num_segments": num_segments,
                         **static},
        _memory,
    )

"""Plain beam-search Viterbi (full tables).

Capability counterpart of the reference's ``SIEVE_BEAMSEARCH.beam_search``
(``Base_line/Python implementations/sieve_beam_search.py:267-347``, no C
port).  The reference version is adjacency-dict based and only
self-consistent for sequential frame values (its tables are indexed by
frame *value*, see ``oracle.sieve_bs.beam_search`` which ports it
verbatim); this decoder is the framework's proper dense equivalent:
``jax.lax.top_k`` beam, gathered transition rows, beam-space pointer
tables, O(T*B) memory.  With ``beam_width == K`` it equals vanilla exactly
(verified in tests).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .base import Decoder, register
from .flash_bs import beam_step, beam_topk


def beam_decode(logA, logB, logPi, y, beam_width: int):
    T = y.shape[0]
    K = int(logA.shape[0])
    B = min(int(beam_width), K)  # clamp: beam cannot exceed K
    emits = logB[:, y].T  # (T, K)
    vals0, states0 = beam_topk(logPi + emits[0], B)

    def step(carry, emit):
        vals, states = carry
        full, slot = beam_step(vals, states, logA, emit)
        nv, ns = beam_topk(full, B)
        return (nv, ns), (ns, slot[ns])

    (_, _), (states_hist, slot_ptrs) = jax.lax.scan(step, (vals0, states0),
                                                    emits[1:])
    states_hist = jnp.concatenate([states0[None], states_hist])  # (T, B)

    end_slot = jnp.asarray(0, jnp.int32)  # beam is score-sorted: slot 0 best

    def walk(slot, ptr_row):
        prev = ptr_row[slot]
        return prev, prev

    _, slots = jax.lax.scan(walk, end_slot, slot_ptrs, reverse=True)
    slots = jnp.concatenate([slots, end_slot[None]])  # (T,)
    return jnp.take_along_axis(states_hist, slots[:, None], axis=1)[:, 0]


def _memory(K: int, T: int, beam_width: int = 64, **_) -> int:
    """Derived from the decoder's live buffers (no reference counterpart —
    the reference beam_search keeps full T1/T2 dicts): states_hist (T, B)
    int32 + slot_ptrs (T-1, B) int32 ~= T*B*8, plus the double-buffered
    beam registers (vals+states, two steps live under scan) 2*(B*4+B*4)
    and the top-k temporary (B*8)."""
    B = beam_width
    return T * B * 8 + 4 * B * 8


@register("beam")
def _build(beam_width: int = 64, **static) -> Decoder:
    def fn(logA, logB, logPi, y):
        return beam_decode(logA, logB, logPi, y, beam_width=beam_width)

    return Decoder("beam", fn, {"beam_width": beam_width, **static}, _memory)

"""Adaptive decoder selection — the "Adaptive" in FLASH made first-class.

The reference leaves adaptivity to the user: its README only advises that
"FLASH_BS [is] more memory-efficient for large state spaces; FLASH may be
faster for small state spaces; performance depends on T and cores"
(/root/reference/README.md:251-255), and every run hard-codes one
algorithm at compile time.  Here ``algorithm="auto"`` picks an exact
decoder for the problem shape, and an optional ``memory_budget_bytes``
filters candidates by their analytic working set (each decoder's
``analytic_memory``), falling back to the leanest mode when nothing fits.

The order of the candidates below was set on the machine this program was
first written for and has not been measured on the H100 yet:

* short/medium T: ``flash`` pointer with 16 segments, then ``checkpoint``,
  ``fused`` and ``flash`` lean;
* long T (>= ``LONG_T`` steps): ``fused`` while its (T, K) pointer table
  fits ``LONG_T_PTR_BUDGET``, then ``checkpoint`` (no table at all);
* tiny T: the D&C machinery has nothing to split; plain ``fused``;
* ``beam_width`` given: the beam family (``flash_bs``).

Selection happens at trace time (shapes are static under jit), so "auto"
is itself jittable and each distinct shape compiles its chosen decoder.
Selection sees the *padded* state count (the device arrays' true K) —
the same K its working-set estimates are honest for.
"""

from __future__ import annotations

import math

from .base import Decoder, build, register
from .flash import LEAF_LANES, LEAN_LEAF

#: sequence length at which long-T handling kicks in
LONG_T = 8192
#: pointer-table budget for the long-T fused route (the batch multiplies
#: it, so config-5's 4 GB per sequence goes to checkpoint/lean instead)
LONG_T_PTR_BUDGET = 1 * 1024 * 1024 * 1024
#: below this there is nothing worth segmenting
TINY_T = 32


def rank(K: int, T: int, beam_width: int | None = None) -> list[tuple[str, dict]]:
    """Candidate (algorithm, static-kwargs) in preference order."""
    if beam_width is not None:
        # one candidate: the beamed D&C engine.  The dense `beam` decoder
        # is NOT a fallback — its (T, B) tables are as large as flash_bs's;
        # there is nothing leaner to fall to.
        return [("flash_bs", {"beam_width": beam_width, "num_segments": 8})]
    if T < TINY_T:
        return [("fused", {}), ("checkpoint", {})]
    if T >= LONG_T:
        if T * K * 4 <= LONG_T_PTR_BUDGET:
            return [("fused", {}), ("checkpoint", {}),
                    ("flash", {"mode": "lean"})]
        return [("checkpoint", {}), ("flash", {"mode": "lean"})]
    return [("flash", {"num_segments": 16}), ("checkpoint", {}),
            ("fused", {}), ("flash", {"mode": "lean"})]


def device_working_set(name: str, kw: dict, K: int, T: int) -> int:
    """Implementation-honest peak device working set of a decoder's scratch
    (excluding the model tables and the (T, K) emission rows, which every
    decoder holds).

    This deliberately differs from ``analytic_memory`` — that figure is
    *reference-exact* (it reproduces the C binaries' ``memory:`` output,
    which accounts the lean algorithm), while the pointer/fused modes
    trade extra device memory for speed.  The budget filter must see that
    trade.
    """
    N = kw.get("num_segments", 8)
    B = kw.get("beam_width", 64)
    if name == "flash" and kw.get("mode") != "lean":
        # phase-2 pointer tables of all segments cover the sequence once
        return T * K * 4 + 4 * K * 4
    if name == "flash":
        # hybrid lean (flash.flash_decode mode="lean"): peak is the larger
        # of (a) a lean round — its S intervals' gathered emissions, twice
        # (gathered and time-major), over the T + S rows they span, plus
        # the (delta, t2) carries, S bounded by the last pre-leaf round
        # (intervals of length ~2*LEAN_LEAF) — and (b) the leaf pass's
        # (LEAN_LEAF-1, LEAF_LANES, K) pointer table and emissions, plus
        # the O(N*K) anchor planes.  Mirrors _lean_round/_decode_leaves.
        leaf = int(kw.get("lean_leaf", LEAN_LEAF))
        if leaf <= 0:  # pure lean: no leaf pass, rounds split to length 2
            s_max = max(N, (T + 3) // 4)
            return (2 * (T + s_max) + 2 * s_max) * K * 4 + (2 * N + 4) * K * 4
        seg_len = -(-T // max(N, 1))
        if seg_len <= leaf:  # segments go straight to leaves, no rounds
            round_b = 0
            llen, n_leaves = seg_len, N
        else:
            s_max = max(N, T // max(2 * leaf, 1))
            round_b = (2 * (T + s_max) + 2 * s_max) * K * 4
            llen, n_leaves = leaf, max(1, -(-T // max(leaf, 2)))
        leaf_b = 2 * max(llen - 1, 1) * min(LEAF_LANES, n_leaves) * K * 4
        return max(round_b, leaf_b) + (2 * N + 4) * K * 4
    if name == "checkpoint":
        # honor a caller step override; default is what the decode runs
        step = int(kw.get("step", 0) or 0)
        if step <= 0:
            step = math.isqrt(max(T, 1))
        return (T // step + 1) * K * 4 + step * K * 4
    if name == "fused":
        return build("fused").analytic_memory(K=K, T=T)  # honest for fused
    if name == "vanilla":
        return 2 * T * K * 4              # full T1 + T2 tables
    if name in ("flash_bs", "beam"):
        return T * B * 8 + 4 * B * 8
    return T * K * 4


def choose(K: int, T: int, memory_budget_bytes: int | None = None,
           beam_width: int | None = None,
           static: dict | None = None) -> tuple[str, dict]:
    """The (algorithm, kwargs) ``auto`` will run for this shape.

    ``static`` carries caller overrides (num_segments, mode, ...): they
    are merged into every candidate BEFORE the working-set filter, so the
    budget is checked against the configuration that would actually run.
    """
    over = static or {}
    cands = [(name, {**kw, **over}) for name, kw in rank(K, T, beam_width)]
    if memory_budget_bytes is None:
        return cands[0]
    for name, kw in cands:
        if device_working_set(name, kw, K, T) <= memory_budget_bytes:
            return name, kw
    # nothing fits: take the leanest candidate rather than crash —
    # min() is stable, so ties keep the faster (earlier) entry
    return min(cands, key=lambda c: device_working_set(c[0], c[1], K, T))


@register("auto")
def _build(memory_budget_bytes: int | None = None,
           beam_width: int | None = None, **static) -> Decoder:
    cache: dict = {}

    def fn(logA, logB, logPi, y):
        K, T = int(logA.shape[0]), int(y.shape[-1])
        name, kw = choose(K, T, memory_budget_bytes, beam_width, static)
        key = (name, tuple(sorted(kw.items())))
        if key not in cache:
            cache[key] = build(name, **kw)
        return cache[key](logA, logB, logPi, y)

    def memory(K: int, T: int, K_padded: int | None = None, **_) -> int:
        # selection happens at the padded K (the device arrays' trace
        # shape) — re-derive the choice there when the caller supplies it
        # (decode() does), then report the figure at the logical K
        name, kw = choose(K if K_padded is None else int(K_padded), T,
                          memory_budget_bytes, beam_width, static)
        return build(name, **kw).analytic_memory(K=K, T=T)

    return Decoder("auto", fn,
                   {"memory_budget_bytes": memory_budget_bytes,
                    "beam_width": beam_width, **static}, memory)

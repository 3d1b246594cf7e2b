"""Shared path-validation helpers: f64 rescoring and FLASH tie-flip
arbitration.

Used by ``bench.harness._parity``, ``scripts/fuzz_hunt.py`` and the
hardware measurement scripts so the "what counts as a failure" logic has
exactly one implementation.

Background (docs/DESIGN.md §1): FLASH restarts each segment's DP from its
anchor state, rounding fp32 differently from the global sweep, so it
legitimately flips exact-tie argmaxes at large T*K — the reference C FLASH
does the same (``tests/test_reference_parity.py::test_flash_tie_flip_c_parity``).
A flash-family path that mismatches vanilla must therefore be arbitrated
against the bit-exact f32 FLASH mirror (``oracle.reference.flash``), and a
cross-algorithm comparison at scale can only use f64-rescored path scores.
"""

from __future__ import annotations

import math

import numpy as np


def path_score_f64(A, B_mat, Pi, y, path) -> float:
    """f64 log-score of ``path`` under probability tables (A, B, Pi)."""
    with np.errstate(divide="ignore"):
        lA = np.log(np.asarray(A, np.float64))
        lB = np.log(np.asarray(B_mat, np.float64))
        lP = np.log(np.asarray(Pi, np.float64))
    return log_path_score_f64(lA, lB, lP, y, path)


def log_path_score_f64(logA, logB, logPi, y, path) -> float:
    """f64 log-score of ``path`` under (possibly fp32) log tables."""
    lA = np.asarray(logA, np.float64)
    lB = np.asarray(logB, np.float64)
    lP = np.asarray(logPi, np.float64)
    p = np.asarray(path)
    yv = np.asarray(y)
    return float(lP[p[0]] + lB[p[0], yv[0]]
                 + lA[p[:-1], p[1:]].sum() + lB[p[1:], yv[1:]].sum())


def beam_family_score_f64(A, B_mat, Pi, y, path) -> tuple[float, int]:
    """f64 log-score under the SIEVE-BS family's flattened-path semantics.

    Quirks honored: a zero emission probability contributes 0, not -inf
    (``SIEVE-BS.c:428``, ``sieve_beam_search.py:119-123``); -1 fallout
    sentinels break the transition chain (``SIEVE-Mp.c:412-420``); and a
    zero-probability TRANSITION in the flattened output is a *junction
    discontinuity* — beam pruning can force adjacent recursion nodes
    through unconnected states, and the reference's own output does this
    (the f64 oracle reproduces each one bit-for-bit; verified on the
    K=64/seed=7 fixture in tests/test_validate.py).  Discontinuities
    contribute 0 to the score and are counted.

    Returns (score, junction_breaks).
    """
    with np.errstate(divide="ignore"):
        lA = np.log(np.asarray(A, np.float64))
        lB = np.log(np.asarray(B_mat, np.float64))
        lP = np.log(np.asarray(Pi, np.float64))
    lBq = np.where(np.isneginf(lB), 0.0, lB)
    p = np.asarray(path)
    yv = np.asarray(y)
    ok = p >= 0
    s = float(lP[p[0]] + lBq[p[0], yv[0]]) if ok[0] else 0.0
    pair = ok[:-1] & ok[1:]
    trans = lA[np.maximum(p[:-1], 0), np.maximum(p[1:], 0)]
    breaks = int((pair & np.isneginf(trans)).sum())
    s += float(np.where(pair & np.isfinite(trans), trans, 0.0).sum())
    s += float(np.where(ok[1:], lBq[np.maximum(p[1:], 0), yv[1:]], 0.0).sum())
    return s, breaks


def beam_path_invariants(A, B_mat, Pi, y, path) -> str:
    """Mirror-free sanity witness for beam-family rows at scales where no
    oracle is affordable in a bench loop: every state must be a valid id
    or the -1 sentinel, and the quirk-scored f64 must be finite.  Junction
    discontinuities are reported, not failed (a reference property — see
    :func:`beam_family_score_f64`).  This is a sanity check, not a parity
    proof — the one-time heavyweight witnesses (compiled C + fp32 mirror)
    live in scripts/sieve_bs_witness.py."""
    p = np.asarray(path)
    K = np.asarray(A).shape[0]
    if not bool(((p >= -1) & (p < K)).all()):
        return "invariants-VIOLATED"
    s, breaks = beam_family_score_f64(A, B_mat, Pi, y, p)
    if np.isfinite(s):
        return f"invariants-ok:score={s:.3f},junction_breaks={breaks}"
    return "invariants-VIOLATED"


def dp_divergence_tolerance_f64(T: int, ref_score: float) -> float:
    """Legitimate f64-score gap between two fp32-DP decoders of the SAME
    problem that accumulate rounding differently (different segmentations,
    restart points, or sweep orders).

    The fp32 recursion rounds once per step at magnitude ~|s|*t/T; argmax
    selects on the ROUNDED scores, so the chosen paths' true (f64) scores
    drift apart roughly like eps*|s|*sqrt(T) with a selection bias factor.
    Calibration: the observed gaps come from runs on another machine (the
    one this program was first built for; not yet re-measured on the
    H100).  At T=65536 they were ~4x eps*|s|*sqrt(T) — checkpoint vs
    flash N=8 at K=1024: 31.5 nats; flash N=4 vs N=2 at K=16384: 39.5
    nats — and MONOTONE in restart count (more restarts = shorter fp32 spans =
    better scores), confirming rounding accumulation, not bugs.  The
    bound here is 4x the observed factor.  Honest caveat: at this scale
    one genuinely wrong transition (~10-15 nats) is INSIDE the tolerance
    — score comparison cannot catch single-transition bugs at long T;
    bit-exactness at small scale plus path-validity (finite f64) carry
    that burden.
    """
    eps = 2.0 ** -23
    return max(2.0, 16.0 * eps * abs(ref_score) * float(np.sqrt(T)))


def score_tolerance_f64(T: int, ref_score: float) -> float:
    """Gross-breakage bound for comparing two fp32-optimal paths' f64
    scores.  Tie-flip accumulation stays well under one transition's
    weight; a genuine algorithmic error costs O(-log p) ~ 5-15 per bad
    transition, which this bound still catches (max 2.0, or 64 final-score
    ulps when the score is large)."""
    return max(2.0, 64.0 * 2.0 ** -23 * abs(ref_score))


def effective_flash_segments(T: int, num_segments: int) -> int:
    """The segment count ``flash_decode`` actually runs with (its clamp)."""
    N = int(num_segments)
    if N < 1 or T < 2 * N:
        N = max(1, min(N, T // 2)) or 1
    return N


# one mirror sweep costs ~T*log2(T) trellis steps of K^2 vectorized numpy;
# 4e10 cells ~= 1-2 min single-threaded — covers the K=3965/T=256 headline,
# gates long-T shapes where the mirror would take hours
FLASH_MIRROR_MAX_CELLS = 4e10


def flash_mirror_cells(K: int, T: int) -> float:
    return float(T) * K * K * (1 + math.ceil(math.log2(max(2, T))))


def arbitrate_flash_tie_flip(A, B_mat, Pi, y, path, num_segments: int,
                             max_cells: float = FLASH_MIRROR_MAX_CELLS):
    """Arbitrate a flash-vs-vanilla path mismatch.

    Every flash variant resolves exact fp32 ties its own way — and all
    are legitimate: pointer mode backtracks the one-shot segment DP's
    pointer table, the C recursion (== lean mode == the f32 mirror)
    re-restarts midpoint DPs, and vanilla sweeps globally.  On fixtures
    with interior exact ties, pointer mode can therefore differ from BOTH
    vanilla and the mirror while remaining fp32-optimal (observed:
    K=194, T=1024, seed=91031 — pointer == vanilla at 2 positions where
    lean == mirror == the compiled C binary flip).

    Returns:
      "mirror-exact"    — bit-matches the f32 FLASH mirror (C semantics);
      "tie-equivalent"  — differs from the mirror only by legitimate tie
                          resolution: no -inf transition, f64-rescored
                          within ``score_tolerance_f64`` of the mirror;
      False             — genuine mismatch (invalid path or score gap);
      None              — no faithful arbitration at this shape: effective
                          segments <= 2 (the mirror's single-binary-split
                          fallback, reference :281, is a different
                          segmentation) or mirror cost above ``max_cells``.
    """
    T = len(np.asarray(y))
    n_eff = effective_flash_segments(T, num_segments)
    if n_eff <= 2:
        return None
    K = np.asarray(A).shape[0]
    if flash_mirror_cells(K, T) > max_cells:
        return None
    from .reference import flash as flash_mirror
    want = flash_mirror(A, B_mat, Pi, y, threads=n_eff, numerics="f32")
    if bool((np.asarray(path) == np.asarray(want)).all()):
        return "mirror-exact"
    s_got = path_score_f64(A, B_mat, Pi, y, path)
    s_ref = path_score_f64(A, B_mat, Pi, y, want)
    if np.isfinite(s_got) and abs(s_got - s_ref) <= score_tolerance_f64(T, s_ref):
        return "tie-equivalent"
    return False

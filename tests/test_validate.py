"""Unit tests for oracle.validate — the shared failure-arbitration logic
used by bench parity, the fuzz hunt, and the hardware scripts."""

import numpy as np
import pytest

from flash_viterbi_tpu.models.generate import make_sparse_hmm
from flash_viterbi_tpu.oracle.validate import (
    arbitrate_flash_tie_flip,
    effective_flash_segments,
    flash_mirror_cells,
    log_path_score_f64,
    path_score_f64,
    score_tolerance_f64,
)


def test_effective_flash_segments_matches_decoder_clamp():
    # mirrors flash_decode's clamp exactly (algorithms/flash.py)
    assert effective_flash_segments(2048, 4) == 4
    assert effective_flash_segments(10, 8) == 5   # T < 2N -> T//2
    assert effective_flash_segments(3, 8) == 1
    assert effective_flash_segments(1, 8) == 1
    assert effective_flash_segments(100, 0) == 1
    assert effective_flash_segments(7, 3) == 3    # T >= 2N: untouched


def test_score_helpers_agree():
    import flash_viterbi_tpu as fvt

    hmm, y = make_sparse_hmm(K=16, M=4, T=8, prob=0.5, seed=3)
    lh = hmm.log()
    # a valid path (an arbitrary one may cross a -inf transition)
    path = np.asarray(fvt.decode(hmm, y, algorithm="vanilla",
                                 warmup=False).path)
    a = path_score_f64(hmm.A, hmm.B, hmm.Pi, y, path)
    b = log_path_score_f64(lh.logA, lh.logB, lh.logPi, y, path)
    # same quantity, prob-tables vs f32-truncated log-tables: close but
    # not identical (the log tables round at fp32)
    assert np.isfinite(a) and abs(a - b) < 1e-2 * max(1.0, abs(a))


def test_score_tolerance_catches_one_bad_transition():
    # a genuinely wrong transition costs O(-log p) ~ 11 at the framework's
    # configs; the tolerance must stay below that at every scale it runs,
    # including the config-5 score magnitude (~ -7e5)
    for s in (-1e2, -1e4, -7e5):
        assert score_tolerance_f64(65536, s) < 8.0


def test_arbitrate_declines_small_segments_and_large_shapes():
    hmm, y = make_sparse_hmm(K=16, M=4, T=8, prob=0.5, seed=3)
    # n_eff <= 2: the mirror's single-binary-split fallback is a different
    # segmentation — no faithful arbitration
    assert arbitrate_flash_tie_flip(hmm.A, hmm.B, hmm.Pi, y,
                                    np.zeros(8, np.int64), 2) is None
    # cost gate
    assert flash_mirror_cells(3965, 65536) > 4e10
    assert arbitrate_flash_tie_flip(hmm.A, hmm.B, hmm.Pi, y,
                                    np.zeros(8, np.int64), 4,
                                    max_cells=1.0) is None


def test_arbitrate_confirms_and_refutes():
    import flash_viterbi_tpu as fvt

    hmm, y = make_sparse_hmm(K=48, M=6, T=24, prob=0.3, seed=5)
    r = fvt.decode(hmm, y, algorithm="flash", num_segments=4, warmup=False)
    ok = arbitrate_flash_tie_flip(hmm.A, hmm.B, hmm.Pi, y,
                                  np.asarray(r.path), 4)
    assert ok == "mirror-exact"
    wrong = np.asarray(r.path).copy()
    wrong[5] = (wrong[5] + 1) % 48
    assert arbitrate_flash_tie_flip(hmm.A, hmm.B, hmm.Pi, y, wrong, 4) is False


def test_arbitrate_tie_equivalent_tier():
    """The fixture where pointer mode legitimately differs from the C
    recursion on interior exact ties (seed 91031): pointer must land in
    the tie-equivalent tier, lean in mirror-exact."""
    import flash_viterbi_tpu as fvt

    rng = np.random.RandomState(91031)
    K = int(rng.randint(128, 513))
    M = int(rng.randint(8, 51))
    T = int(rng.choice([128, 256, 512, 1024]))
    prob = float(rng.uniform(0.05, 0.3))
    segs = int(rng.choice([4, 6, 8]))
    hmm, y = make_sparse_hmm(K=K, M=M, T=T, prob=prob, seed=91031)
    p = np.asarray(fvt.decode(hmm, y, algorithm="flash", num_segments=segs,
                              warmup=False).path)
    l = np.asarray(fvt.decode(hmm, y, algorithm="flash", num_segments=segs,
                              mode="lean", warmup=False).path)
    assert (p != l).sum() == 2  # the interior tie flips exist
    assert arbitrate_flash_tie_flip(hmm.A, hmm.B, hmm.Pi, y, p,
                                    segs) == "tie-equivalent"
    assert arbitrate_flash_tie_flip(hmm.A, hmm.B, hmm.Pi, y, l,
                                    segs) == "mirror-exact"


def test_beam_invariants_ok_and_violated():
    import flash_viterbi_tpu as fvt
    from flash_viterbi_tpu.oracle.sieve_bs import sieve_bs as oracle_sbs
    from flash_viterbi_tpu.oracle.validate import (
        beam_family_score_f64, beam_path_invariants)

    hmm, y = make_sparse_hmm(K=64, M=8, T=32, prob=0.2, seed=7)
    path = np.asarray(fvt.decode(hmm, y, algorithm="sieve_bs",
                                 beam_width=16, warmup=False).path)[:32]
    v = beam_path_invariants(hmm.A, hmm.B, hmm.Pi, y, path)
    # this fixture has 2 junction discontinuities — and the f64 oracle
    # (reference semantics) reproduces the exact same flattened path, so
    # they are a reference property, not a decoder bug
    pairs = oracle_sbs(hmm.A, hmm.B, hmm.Pi, y, beam_width=16)
    flat = np.asarray([pairs[0][0], pairs[0][1]] + [p[1] for p in pairs[1:]])
    np.testing.assert_array_equal(path, flat[:32])
    assert v.startswith("invariants-ok:score=")
    assert v.endswith("junction_breaks=2")
    # an out-of-range state must be flagged
    wrong = path.copy()
    wrong[3] = 64
    assert beam_path_invariants(hmm.A, hmm.B, hmm.Pi, y, wrong) \
        == "invariants-VIOLATED"
    # sentinel handling: -1 breaks the chain, score stays finite
    sent = path.copy()
    sent[5] = -1
    s, _ = beam_family_score_f64(hmm.A, hmm.B, hmm.Pi, y, sent)
    assert np.isfinite(s)


def test_beam_invariants_match_quirk_semantics():
    # the quirk score must treat zero emissions as 0, not -inf: zero an
    # emission ON the decoded path and check the score stays finite
    from flash_viterbi_tpu.oracle.validate import beam_family_score_f64

    hmm, y = make_sparse_hmm(K=32, M=6, T=16, prob=0.4, seed=9)
    B = np.asarray(hmm.B).copy()
    import flash_viterbi_tpu as fvt
    path = np.asarray(fvt.decode(hmm, y, algorithm="sieve_bs",
                                 beam_width=8, warmup=False).path)[:16]
    B[path[4], np.asarray(y)[4]] = 0.0  # zero emission ON the path
    s, _ = beam_family_score_f64(hmm.A, B, hmm.Pi, y, path)
    assert np.isfinite(s)


def test_dp_divergence_tolerance_scales():
    from flash_viterbi_tpu.oracle.validate import (
        dp_divergence_tolerance_f64, score_tolerance_f64)

    # calibrated regime (oracle.validate.dp_divergence_tolerance_f64):
    # observed legitimate gaps 31.5 (K=1024) / 39.5 (K=16384) nats at
    # T=65536 must pass, with
    # ~4x headroom but not unbounded
    tol = dp_divergence_tolerance_f64(65536, -659486.0)
    assert 39.5 < tol < 400.0
    tol2 = dp_divergence_tolerance_f64(65536, -481416.0)
    assert 31.5 < tol2 < 300.0
    # short-T small-score regime stays tight (floor)
    assert dp_divergence_tolerance_f64(256, -2198.0) == 2.0
    # the plain (same-sweep) tolerance is much tighter than the
    # cross-segmentation one at long T
    assert score_tolerance_f64(65536, -659486.0) < tol / 5

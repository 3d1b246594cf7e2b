"""Degenerate shapes: every algorithm must agree with vanilla on tiny
T/M and handle bad arguments cleanly (verify-skill probes)."""

import numpy as np
import pytest

import flash_viterbi_tpu as fvt
from flash_viterbi_tpu.oracle import framework as ofw

ALGS = [
    ("vanilla", {}),
    ("checkpoint", {}),
    ("fused", {}),
    ("flash", {"num_segments": 8}),
    ("flash", {"num_segments": 8, "mode": "lean"}),
    ("sieve_mp", {}),
    ("beam", {}),  # beam_width filled with K at call site
    ("flash_bs", {"num_segments": 8}),
]


@pytest.mark.parametrize("T", [1, 2, 3, 4])
def test_tiny_T_all_algorithms(T):
    hmm, y = fvt.make_sparse_hmm(K=16, M=4, T=T, prob=0.5, seed=T)
    want = ofw.vanilla(hmm.A, hmm.B, hmm.Pi, y)
    for alg, kw in ALGS:
        kw = dict(kw)
        if alg in ("beam", "flash_bs"):
            kw["beam_width"] = hmm.K
        r = fvt.decode(hmm, y, algorithm=alg, pad_to=1, warmup=False, **kw)
        np.testing.assert_array_equal(r.path, want, err_msg=f"{alg} {kw}")


def test_t1_forced_pallas(interpret_kernel):
    """T=1 through the Triton step hits the empty-scan path."""
    hmm, y = fvt.make_sparse_hmm(K=64, M=5, T=1, prob=0.25, seed=5249)
    want = ofw.vanilla(hmm.A, hmm.B, hmm.Pi, y)
    for alg, kw in (("fused", {}), ("flash", {"num_segments": 8}),
                    ("flash", {"num_segments": 8, "mode": "lean"})):
        r = fvt.decode(hmm, y, algorithm=alg, pad_to=1, warmup=False, **kw)
        np.testing.assert_array_equal(r.path, want)


def test_single_symbol_alphabet():
    hmm, y = fvt.make_sparse_hmm(K=8, M=1, T=5, prob=0.9, seed=5)
    want = ofw.vanilla(hmm.A, hmm.B, hmm.Pi, y)
    r = fvt.decode(hmm, y, algorithm="flash", pad_to=1, warmup=False)
    np.testing.assert_array_equal(r.path, want)


def test_unknown_algorithm_raises():
    hmm, y = fvt.make_sparse_hmm(K=8, M=4, T=4, prob=0.5, seed=1)
    with pytest.raises(KeyError, match="unknown algorithm"):
        fvt.decode(hmm, y, algorithm="nope")


def test_segments_exceeding_half_T_clamp(small_problem):
    hmm, y = small_problem
    v = fvt.decode(hmm, y, algorithm="vanilla", warmup=False)
    f = fvt.decode(hmm, y, algorithm="flash", num_segments=1000, warmup=False)
    np.testing.assert_array_equal(v.path, f.path)


def test_redispatch_retries_transient_failures():
    from flash_viterbi_tpu.utils.failsafe import with_redispatch

    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("UNAVAILABLE: synthetic transient failure")
        return "ok"

    assert with_redispatch(flaky, retries=3, backoff_s=0.0) == "ok"
    assert calls["n"] == 3

    import pytest as _pytest

    calls["n"] = 0
    with _pytest.raises(RuntimeError):
        with_redispatch(flaky, retries=1, backoff_s=0.0)


def test_decode_retries_kwarg(small_problem):
    import flash_viterbi_tpu as fvt

    hmm, y = small_problem
    r = fvt.decode(hmm, y, algorithm="vanilla", pad_to=1, warmup=False,
                   retries=2)
    assert r.path.shape[0] == len(y)

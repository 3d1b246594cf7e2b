"""SIEVE family oracle parity.

* sieve_mp vs the compiled reference C binary (bit-exact paths).
* sieve_dynamic vs the reference *Python* ``Sieve.sieve`` run in-process
  from /root/reference (the original has no C port, SURVEY.md §2.3) —
  imported at test time, never copied.
* Log-likelihood sanity vs vanilla (SIEVE is an exact method; its paths may
  differ from vanilla's only through the reference's right-child re-argmax
  quirk, so we compare scores, not states).
"""

import io
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest

from flash_viterbi_tpu.models.generate import make_sparse_hmm
from flash_viterbi_tpu.oracle import reference as oref
from flash_viterbi_tpu.oracle.sieve import sieve_dynamic, sieve_mp
from flash_viterbi_tpu.utils.io import save_dataset

from .ref_compile import build_and_run, have_gcc, have_glib, have_reference

REF_PY = "/root/reference/Base_line/Python implementations"


def _loglik(hmm, y, path):
    with np.errstate(divide="ignore"):
        lA, lB, lPi = (np.log(x) for x in (hmm.A, hmm.B, hmm.Pi))
    s = lPi[path[0]] + lB[path[0], y[0]]
    s += sum(lA[path[t - 1], path[t]] + lB[path[t], y[t]] for t in range(1, len(y)))
    return s


@pytest.mark.skipif(not have_gcc(), reason="gcc not available")
@pytest.mark.parametrize("K,M,T,prob,seed", [
    (64, 12, 32, 0.3, 7),
    (32, 8, 17, 0.4, 1),
    (48, 6, 33, 0.25, 11),
])
@pytest.mark.skipif(not have_reference(), reason="reference checkout not mounted")
def test_sieve_mp_c_bit_parity(tmp_path, K, M, T, prob, seed):
    hmm, y = make_sparse_hmm(K=K, M=M, T=T, prob=prob, seed=seed)
    d = tmp_path / "data"; d.mkdir()
    w = tmp_path / "work"; w.mkdir()
    save_dataset(str(d), hmm, y, prob=prob)
    want = build_and_run("sieve_mp", str(w), K, M, T, prob, str(d))
    got = sieve_mp(hmm.A, hmm.B, hmm.Pi, y, numerics="c")
    np.testing.assert_array_equal(got, want)


@pytest.mark.skipif(not have_reference(), reason="reference checkout not mounted")
@pytest.mark.skipif(not have_gcc(), reason="gcc not available")
def test_sieve_mp_c_bit_parity_nonuniform_pi(tmp_path):
    """The C top-level call passes the model Pi (SIEVE-Mp.c:499,
    isPiNone=0); the generators always emit uniform Pi, so this fixture
    perturbs it to pin the root-Pi handling."""
    import dataclasses

    K, M, T, prob, seed = 48, 8, 32, 0.3, 5
    hmm, y = make_sparse_hmm(K=K, M=M, T=T, prob=prob, seed=seed)
    rng = np.random.RandomState(99)
    Pi = rng.uniform(0.05, 1.0, K)
    hmm = dataclasses.replace(hmm, Pi=Pi / Pi.sum())
    d = tmp_path / "data"; d.mkdir()
    w = tmp_path / "work"; w.mkdir()
    save_dataset(str(d), hmm, y, prob=prob)
    want = build_and_run("sieve_mp", str(w), K, M, T, prob, str(d))
    got = sieve_mp(hmm.A, hmm.B, hmm.Pi, y, numerics="c")
    np.testing.assert_array_equal(got, want)


def test_sieve_mp_close_to_vanilla(small_problem):
    """SIEVE-Mp paths may differ from vanilla only where the reference's
    right-child re-argmax quirk bites (right recursions pass last=-1,
    SIEVE-Mp.c:452) — which can even yield A=0 transitions at segment
    boundaries (ll = -inf).  The real parity bar is the C binary
    (test_sieve_mp_c_bit_parity); here we check the bulk agrees."""
    hmm, y = small_problem
    v = oref.vanilla(hmm.A, hmm.B, hmm.Pi, y, numerics="c")
    s = sieve_mp(hmm.A, hmm.B, hmm.Pi, y, numerics="c")
    assert _loglik(hmm, y, s) <= _loglik(hmm, y, v) + 1e-6
    assert (v == s).mean() > 0.85  # only quirk positions may differ


@pytest.mark.skipif(not (have_gcc() and have_glib()),
                    reason="gcc or glib/shim not available")
@pytest.mark.parametrize("K,M,T,prob,seed,bw", [
    (48, 8, 24, 0.25, 3, 8),
    (64, 12, 32, 0.3, 7, 16),
    (32, 6, 17, 0.4, 1, 4),
])
@pytest.mark.skipif(not have_reference(), reason="reference checkout not mounted")
@pytest.mark.parametrize("name", ["sieve_bs", "sieve_bs_mp"])
def test_sieve_bs_c_bit_parity(tmp_path, name, K, M, T, prob, seed, bw):
    """Oracles vs the compiled reference C binaries (built against real
    glib or the vendored csrc/glibshim header) — closes the parity chain
    that previously stopped at the reference Python."""
    from flash_viterbi_tpu.oracle.sieve_bs import sieve_bs, sieve_bs_mp

    oracle = {"sieve_bs": sieve_bs, "sieve_bs_mp": sieve_bs_mp}[name]
    hmm, y = make_sparse_hmm(K=K, M=M, T=T, prob=prob, seed=seed)
    d = tmp_path / "data"; d.mkdir()
    w = tmp_path / "work"; w.mkdir()
    save_dataset(str(d), hmm, y, prob=prob)
    cpath = build_and_run(name, str(w), K, M, T, prob, str(d), beam=bw)
    pairs = oracle(hmm.A, hmm.B, hmm.Pi, y, beam_width=bw)
    flat = np.asarray([pairs[0][0], pairs[0][1]] + [p[1] for p in pairs[1:]])
    assert len(flat) == len(cpath)
    np.testing.assert_array_equal(cpath, flat)


@pytest.mark.skipif(not have_reference(), reason="reference checkout not mounted")
@pytest.mark.skipif(not (have_gcc() and have_glib()),
                    reason="gcc or glib/shim not available")
@pytest.mark.parametrize("name", ["sieve_bs", "sieve_bs_mp"])
def test_sieve_bs_device_c_parity_nonuniform_pi(tmp_path, name):
    """The C binaries re-init every recursion node from the MODEL Pi
    (SIEVE-BS.c:367, SIEVE-BS-Mp.c:332); the reference Python threads
    Baseline.py's uniform log(1/K) instead — indistinguishable on the
    generators' uniform-Pi fixtures.  The device decoders follow the C
    binaries; this non-uniform-Pi fixture pins that choice (and would
    catch a uniform-prior regression outright, not just on fp ties)."""
    import dataclasses

    import jax.numpy as jnp

    from flash_viterbi_tpu import decode

    K, M, T, prob, seed, bw = 40, 8, 24, 0.3, 13, 10
    hmm, y = make_sparse_hmm(K=K, M=M, T=T, prob=prob, seed=seed)
    rng = np.random.RandomState(77)
    Pi = rng.uniform(0.05, 1.0, K)
    hmm = dataclasses.replace(hmm, Pi=Pi / Pi.sum())
    d = tmp_path / "data"; d.mkdir()
    w = tmp_path / "work"; w.mkdir()
    save_dataset(str(d), hmm, y, prob=prob)
    cpath = build_and_run(name, str(w), K, M, T, prob, str(d), beam=bw)
    r = decode(hmm, y, algorithm=name, beam_width=bw, pad_to=1, warmup=False)
    np.testing.assert_array_equal(r.path[: len(cpath)], cpath)
    # the fp32 mirrors share the model-Pi convention: bit-exact vs device
    from flash_viterbi_tpu.oracle import framework as fw

    mirror = {"sieve_bs": fw.sieve_bs, "sieve_bs_mp": fw.sieve_bs_mp}[name]
    got = mirror(hmm.A, hmm.B, hmm.Pi, y, beam_width=bw)
    if name == "sieve_bs":
        flat = np.asarray([got[0][0], got[0][1]] + [p[1] for p in got[1:]])
        np.testing.assert_array_equal(r.path[: len(flat)], flat)
    else:
        np.testing.assert_array_equal(r.path, np.asarray(got)[:T])


def _load_ref_module(name):
    sys.path.insert(0, REF_PY)
    try:
        if name == "Viterbi":
            from Viterbi import Sieve
            return Sieve
        from sieve_beam_search import SIEVE_BEAMSEARCH
        return SIEVE_BEAMSEARCH
    finally:
        sys.path.remove(REF_PY)


@pytest.mark.parametrize("K,M,T,prob,seed,bw", [
    (48, 8, 24, 0.25, 3, 8),
    (64, 12, 32, 0.3, 7, 16),
    (32, 6, 17, 0.4, 1, 4),
])
@pytest.mark.skipif(not have_reference(), reason="reference checkout not mounted")
def test_sieve_bs_matches_reference_python(K, M, T, prob, seed, bw):
    from flash_viterbi_tpu.oracle.sieve_bs import build_adjacency, sieve_bs, sieve_bs_mp

    hmm, y = make_sparse_hmm(K=K, M=M, T=T, prob=prob, seed=seed)
    SIEVE_BEAMSEARCH = _load_ref_module("sieve_beam_search")
    pi, A_out, A_in, ac = build_adjacency(hmm.A, hmm.B, lazy=False)
    idx = list(range(K))

    for method, ours in (("viterbi_space_efficient", sieve_bs),
                         ("viterbi_middlepath", sieve_bs_mp)):
        bs = SIEVE_BEAMSEARCH(pi, A_out, A_in, ac, bw)
        bs.viterbi_preprocessing_descendants_pruning_root(idx, T, K)
        bs.viterbi_preprocessing_ancestors_pruning_root(idx, T, K)
        with redirect_stdout(io.StringIO()):
            getattr(bs, method)(idx, frames=list(np.asarray(y)), Pi=pi, K=K)
        want = [tuple(int(v) for v in p) for p in bs.path]
        got = [tuple(int(v) for v in p)
               for p in ours(hmm.A, hmm.B, hmm.Pi, y, beam_width=bw)]
        assert got == want, method


@pytest.mark.skipif(not have_reference(), reason="reference checkout not mounted")
def test_beam_search_matches_reference_python():
    from flash_viterbi_tpu.oracle.sieve_bs import beam_search, build_adjacency

    K, T, bw = 48, 24, 8
    # sequential frames 0..T-1: the only domain where the reference's
    # frame-value table indexing (sieve_beam_search.py:301-340) is
    # self-consistent — it IndexErrors on repeated symbols.
    hmm, _ = make_sparse_hmm(K=K, M=T, T=T, prob=0.25, seed=3)
    y = np.arange(T)
    SIEVE_BEAMSEARCH = _load_ref_module("sieve_beam_search")
    pi, A_out, A_in, ac = build_adjacency(hmm.A, hmm.B, lazy=False)
    bs = SIEVE_BEAMSEARCH(pi, A_out, A_in, ac, bw)
    wpath, wll, _ = bs.beam_search(list(range(K)), frames=list(y),
                                   Pi={i: pi[i] for i in range(K)})
    gpath, gll = beam_search(hmm.A, hmm.B, hmm.Pi, y, beam_width=bw)
    np.testing.assert_array_equal(np.asarray(wpath), gpath)
    assert wll == gll


@pytest.mark.skipif(not have_reference(), reason="reference checkout not mounted")
def test_sieve_dag_matches_reference_python():
    from flash_viterbi_tpu.models.generate import make_dag_hmm
    from flash_viterbi_tpu.oracle.sieve import sieve_dag

    K, M, T, seed = 24, 8, 16, 3
    hmm, y = make_dag_hmm(K=K, M=M, T=T, seed=seed, sanitize=True)
    Sieve = _load_ref_module("Viterbi")
    sv = Sieve(np.full(K, 1.0 / K), hmm.A, hmm.B, np.asarray(y))
    sv.initial_state = None
    with np.errstate(divide="ignore", invalid="ignore"), \
            redirect_stdout(io.StringIO()):
        sv.sieve_dag(np.arange(K), hmm.A, hmm.B, np.asarray(y),
                     Pi=np.full(K, 1.0 / K), K=K)
    want = [tuple(int(v) for v in p) for p in sv.path]
    got = [tuple(int(v) for v in p) for p in sieve_dag(hmm.A, hmm.B, hmm.Pi, y)]
    assert got == want


@pytest.mark.skipif(not have_reference(), reason="reference checkout not mounted")
def test_sieve_dynamic_matches_reference_python(small_problem):
    hmm, y = small_problem
    K = hmm.K
    b = 5

    sys.path.insert(0, REF_PY)
    try:
        from Viterbi import Sieve
    finally:
        sys.path.remove(REF_PY)

    sv = Sieve(hmm.Pi, hmm.A, hmm.B, np.asarray(y))
    sv.initial_state = None
    idx = np.arange(K)
    sv.viterbi_preprocessing_ancestors_pruning_root(idx, b, K)
    sv.viterbi_preprocessing_descendants_pruning_root(idx, b, K)
    with redirect_stdout(io.StringIO()):
        sv.sieve(idx, hmm.A, hmm.B, np.asarray(y),
                 Pi=np.asarray(hmm.Pi), K=K)
    want = [tuple(int(v) for v in p) for p in sv.path]

    got = sieve_dynamic(hmm.A, hmm.B, hmm.Pi, y, b_hops=b)
    assert got == want

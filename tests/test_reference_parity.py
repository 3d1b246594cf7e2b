"""Bit-exact parity: our numpy oracle vs the compiled reference C programs.

This is the framework's golden-path anchor (SURVEY.md §4): generate seeded
fixtures, run the actual reference binaries on them, and require identical
``path:`` output from ``oracle.reference`` with ``numerics="c"``.
"""

import numpy as np
import pytest

from flash_viterbi_tpu.models.generate import make_sparse_hmm
from flash_viterbi_tpu.oracle import reference as oref
from flash_viterbi_tpu.utils.io import save_dataset

from .ref_compile import (build_and_run, build_and_run_full, have_gcc,
                          have_reference)

pytestmark = [
    pytest.mark.skipif(not have_gcc(), reason="gcc not available"),
    pytest.mark.skipif(not have_reference(),
                       reason="reference checkout not mounted"),
]

K, M, T, PROB, SEED = 64, 12, 32, 0.3, 7


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("ref_data")
    hmm, y = make_sparse_hmm(K=K, M=M, T=T, prob=PROB, seed=SEED)
    save_dataset(str(d), hmm, y, prob=PROB)
    return str(d), hmm, y


def test_vanilla_bit_parity(fixture_dir, tmp_path):
    d, hmm, y = fixture_dir
    want = build_and_run("vanilla", str(tmp_path), K, M, T, PROB, d)
    got = oref.vanilla(hmm.A, hmm.B, hmm.Pi, y, numerics="c")
    np.testing.assert_array_equal(got, want)


def test_checkpoint_bit_parity(fixture_dir, tmp_path):
    d, hmm, y = fixture_dir
    want = build_and_run("checkpoint", str(tmp_path), K, M, T, PROB, d)
    got = oref.checkpoint(hmm.A, hmm.B, hmm.Pi, y, numerics="c")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("threads", [1, 2, 4])
def test_flash_bit_parity(fixture_dir, tmp_path, threads):
    d, hmm, y = fixture_dir
    want = build_and_run("flash", str(tmp_path), K, M, T, PROB, d, threads=threads)
    got = oref.flash(hmm.A, hmm.B, hmm.Pi, y, threads=threads, numerics="c")
    np.testing.assert_array_equal(got, want)


def test_memory_accounting_matches_c(fixture_dir, tmp_path):
    """The analytic ``memory:`` figures must equal what the reference C
    binaries print — including FLASH's sizeof-of-expression bug (+8) and
    checkpoint's full snapshot-matrix accounting."""
    import flash_viterbi_tpu as fvt

    d, hmm, y = fixture_dir
    for name, alg, kw, ckw in [
        ("vanilla", "vanilla", {}, {}),
        ("checkpoint", "checkpoint", {}, {}),
        ("flash", "flash", {"num_segments": 6}, {"threads": 6}),
        ("flash", "flash", {"num_segments": 2}, {"threads": 2}),
        ("flash_bs", "flash_bs", {"num_segments": 6, "beam_width": 16},
         {"threads": 6, "beam": 16}),
    ]:
        _, want = build_and_run_full(name, str(tmp_path), K, M, T, PROB, d, **ckw)
        r = fvt.decode(hmm, y, algorithm=alg, warmup=False, **kw)
        assert r.memory_bytes == want, (name, ckw)


@pytest.mark.parametrize("threads,beam", [(1, 16), (4, 16), (4, 32)])
def test_flash_bs_bit_parity(fixture_dir, tmp_path, threads, beam):
    d, hmm, y = fixture_dir
    want = build_and_run("flash_bs", str(tmp_path), K, M, T, PROB, d,
                         threads=threads, beam=beam)
    got = oref.flash_bs(hmm.A, hmm.B, hmm.Pi, y, beam_width=beam,
                        threads=threads, numerics="c")
    np.testing.assert_array_equal(got, want)


@pytest.mark.skipif(not __import__("os").environ.get("FVT_SLOW_TESTS"),
                    reason="slow (~2 min): set FVT_SLOW_TESTS=1")
def test_flash_tie_flip_c_parity(tmp_path):
    """FLASH legitimately deviates from vanilla on exact fp32 ties: phase 2
    restarts each segment's DP from its anchor state, rounding differently
    from the global sweep.  At K=512, T=2048 (prob=0.112, seed=1) the
    deviation is 5 positions — and the compiled reference C FLASH
    (src/FLASH_Viterbi_multithread.c) deviates at the SAME positions,
    bit-identically to both our pointer-mode decoder and the f32 mirror
    ON THIS FIXTURE (the anchor-driven flips coincide; interior ties can
    legitimately differ per variant — see DESIGN.md §1 and
    test_validate.test_arbitrate_tie_equivalent_tier).  Pins the tie-flip
    arbitration used by bench._parity and scripts/fuzz_hunt."""
    import flash_viterbi_tpu as fvt

    Kb, Mb, Tb, prob, seed = 512, 50, 2048, 0.112, 1
    hmm, y = make_sparse_hmm(K=Kb, M=Mb, T=Tb, prob=prob, seed=seed)
    d = tmp_path / "data"; d.mkdir()
    w = tmp_path / "work"; w.mkdir()
    save_dataset(str(d), hmm, y, prob=prob)
    cpath = build_and_run("flash", str(w), Kb, Mb, Tb, prob, str(d), threads=4)

    r = fvt.decode(hmm, y, algorithm="flash", num_segments=4, warmup=False)
    np.testing.assert_array_equal(r.path, cpath)

    mirror = oref.flash(hmm.A, hmm.B, hmm.Pi, y, threads=4, numerics="f32")
    np.testing.assert_array_equal(mirror, cpath)

    van = fvt.decode(hmm, y, algorithm="vanilla", warmup=False)
    flips = np.nonzero(np.asarray(van.path) != np.asarray(cpath))[0]
    assert len(flips) == 5, flips  # the documented tie flips exist


@pytest.mark.skipif(not __import__("os").environ.get("FVT_SLOW_TESTS"),
                    reason="slow (~2 min): set FVT_SLOW_TESTS=1")
def test_medium_shape_c_parity_sweep(tmp_path):
    """C-bit parity beyond toy shapes, one medium fixture per family,
    each family checked through its documented chain (DESIGN.md §1):
    C binary == oracle(numerics='c'), framework == its f32 mirror, and
    for the SIEVE-BS family the device decoder == the C binary directly
    (both fp32-facing at these shapes)."""
    import flash_viterbi_tpu as fvt
    from flash_viterbi_tpu.oracle import framework as ofw

    def fixture(K, M, T, prob, seed, sub):
        hmm, y = make_sparse_hmm(K=K, M=M, T=T, prob=prob, seed=seed)
        d = tmp_path / f"d{sub}"; d.mkdir()
        w = tmp_path / f"w{sub}"; w.mkdir()
        save_dataset(str(d), hmm, y, prob=prob)
        return hmm, y, str(d), str(w)

    # checkpoint @ K=512, T=2048
    Ka, Ma, Ta, pa, sa = 512, 50, 2048, 0.112, 1
    hmm, y, d, w = fixture(Ka, Ma, Ta, pa, sa, 0)
    cp = build_and_run("checkpoint", w, Ka, Ma, Ta, pa, d)
    np.testing.assert_array_equal(
        oref.checkpoint(hmm.A, hmm.B, hmm.Pi, y, numerics="c"), cp)
    # vanilla: same fixture, same chain
    cp = build_and_run("vanilla", w, Ka, Ma, Ta, pa, d)
    np.testing.assert_array_equal(
        oref.vanilla(hmm.A, hmm.B, hmm.Pi, y, numerics="c"), cp)

    # flash_bs @ K=512, T=1024, B=32
    Kb, Tb, bw, th = 512, 1024, 32, 4
    hmm, y, d, w = fixture(Kb, Ma, Tb, pa, sa, 1)
    cp = build_and_run("flash_bs", w, Kb, Ma, Tb, pa, d, threads=th, beam=bw)
    np.testing.assert_array_equal(
        oref.flash_bs(hmm.A, hmm.B, hmm.Pi, y, beam_width=bw, threads=th,
                      numerics="c"), cp)
    r = fvt.decode(hmm, y, algorithm="flash_bs", beam_width=bw,
                   num_segments=th, warmup=False)
    m = ofw.flash_bs(hmm.A, hmm.B, hmm.Pi, y, beam_width=bw, num_segments=th)
    np.testing.assert_array_equal(r.path, np.asarray(m)[:Tb])

    # SIEVE-BS family @ K=256: device decoder vs C binary directly
    from .ref_compile import have_glib
    if have_glib():
        Kc, Mc, Tc, pc, sc, bwc = 256, 20, 128, 0.1, 3, 24
        hmm, y, d, w = fixture(Kc, Mc, Tc, pc, sc, 2)
        for name in ("sieve_bs", "sieve_bs_mp"):
            cp = build_and_run(name, w, Kc, Mc, Tc, pc, d, beam=bwc)
            r = fvt.decode(hmm, y, algorithm=name, beam_width=bwc,
                           warmup=False)
            np.testing.assert_array_equal(np.asarray(r.path)[: len(cp)], cp)

"""JAX decoder correctness: bit-exact vs the framework-semantics numpy
mirrors, cross-algorithm equality, and padding invariance."""

import jax
import numpy as np
import pytest

from flash_viterbi_tpu import decode
from flash_viterbi_tpu.oracle import framework as ofw
from flash_viterbi_tpu.oracle import reference as oref


def test_vanilla_matches_numpy_mirror(small_problem):
    hmm, y = small_problem
    want = ofw.vanilla(hmm.A, hmm.B, hmm.Pi, y)
    got = decode(hmm, y, algorithm="vanilla", warmup=False)
    np.testing.assert_array_equal(got.path, want)


def test_vanilla_matches_reference_f32_semantics(small_problem):
    """The framework numerics contract == oracle.reference numerics='f32'."""
    hmm, y = small_problem
    want = oref.vanilla(hmm.A, hmm.B, hmm.Pi, y, numerics="f32")
    got = decode(hmm, y, algorithm="vanilla", warmup=False)
    np.testing.assert_array_equal(got.path, want)


@pytest.mark.parametrize("step", [0, 3, 5])
def test_checkpoint_equals_vanilla(small_problem, step):
    hmm, y = small_problem
    v = decode(hmm, y, algorithm="vanilla", warmup=False)
    c = decode(hmm, y, algorithm="checkpoint", step=step, warmup=False)
    np.testing.assert_array_equal(v.path, c.path)


@pytest.mark.parametrize("mode", ["pointer", "lean"])
@pytest.mark.parametrize("segments", [1, 2, 4, 7])
def test_flash_equals_vanilla(small_problem, mode, segments):
    hmm, y = small_problem
    v = decode(hmm, y, algorithm="vanilla", warmup=False)
    f = decode(hmm, y, algorithm="flash", num_segments=segments, mode=mode, warmup=False)
    np.testing.assert_array_equal(v.path, f.path)


@pytest.mark.parametrize("segments", [1, 4])
def test_flash_medium(medium_problem, segments):
    hmm, y = medium_problem
    v = decode(hmm, y, algorithm="vanilla", warmup=False)
    f = decode(hmm, y, algorithm="flash", num_segments=segments, warmup=False)
    np.testing.assert_array_equal(v.path, f.path)


def test_flash_bs_full_beam_equals_vanilla(small_problem):
    hmm, y = small_problem
    v = decode(hmm, y, algorithm="vanilla", warmup=False)
    f = decode(hmm, y, algorithm="flash_bs", beam_width=hmm.K, num_segments=4,
               pad_to=1, warmup=False)
    np.testing.assert_array_equal(v.path, f.path)


@pytest.mark.parametrize("beam,segments", [(16, 1), (16, 4), (32, 4)])
def test_flash_bs_matches_numpy_mirror(small_problem, beam, segments):
    hmm, y = small_problem
    want = ofw.flash_bs(hmm.A, hmm.B, hmm.Pi, y, beam_width=beam, num_segments=segments)
    got = decode(hmm, y, algorithm="flash_bs", beam_width=beam,
                 num_segments=segments, pad_to=1, warmup=False)
    np.testing.assert_array_equal(got.path, want)


def test_padding_invariance(small_problem):
    """Padding the state dimension must never change the decoded path."""
    hmm, y = small_problem
    p1 = decode(hmm, y, algorithm="flash", num_segments=4, pad_to=1, warmup=False)
    p128 = decode(hmm, y, algorithm="flash", num_segments=4, pad_to=128, warmup=False)
    np.testing.assert_array_equal(p1.path, p128.path)


def test_decode_result_protocol(small_problem):
    hmm, y = small_problem
    r = decode(hmm, y, algorithm="vanilla", warmup=False)
    out = r.reference_stdout()
    assert out.startswith("time: ")
    assert "path: [" in out and "memory: " in out
    assert r.memory_bytes > 0


@pytest.mark.parametrize("leaf", [0, 4, 64])
def test_lean_leaf_hybrid(small_problem, leaf):
    """Hybrid lean (binary-split to min_leaf, then batched pointer leaves)
    is bit-identical to vanilla at every leaf size (0 = the reference's
    full splitting)."""
    hmm, y = small_problem
    v = decode(hmm, y, algorithm="vanilla", pad_to=1, warmup=False)
    l = decode(hmm, y, algorithm="flash", mode="lean", num_segments=4,
               lean_leaf=leaf, pad_to=1, warmup=False)
    np.testing.assert_array_equal(l.path, v.path)


def test_auto_selection_rules():
    """auto's preference order per shape (no dispatch ceiling: one long
    sweep is one program) and the memory budget's fallback to leaner
    modes."""
    from flash_viterbi_tpu.algorithms.auto import choose, device_working_set

    assert choose(4096, 256) == ("flash", {"num_segments": 16})
    assert choose(1024, 256) == ("flash", {"num_segments": 16})
    # long T: fused while its (T, K) pointer table fits the budget,
    # checkpoint (no table at all) beyond it — config-5 shapes included
    assert choose(1024, 65536)[0] == "fused"
    assert choose(16384, 65536)[0] == "checkpoint"
    assert choose(1024, 8)[0] == "fused"
    assert choose(4096, 256, beam_width=64)[0] == "flash_bs"
    # a tiny budget can't shrink the beamed engine further: flash_bs is
    # already the only (and leanest) beamed candidate
    assert choose(4096, 256, memory_budget_bytes=1, beam_width=64)[0] == "flash_bs"
    # a budget below flash's pointer tables forces a leaner candidate
    flash_mem = device_working_set("flash", {"num_segments": 8}, 4096, 256)
    name, kw = choose(4096, 256, memory_budget_bytes=flash_mem - 1)
    assert (name, kw) != ("flash", {"num_segments": 8})
    assert device_working_set(name, kw, 4096, 256) < flash_mem
    # impossible budget: falls back to the candidate with the smallest
    # honest working set, never a crash — checkpoint at short T (hybrid
    # lean's leaf pointer tables outweigh √T snapshots), and it is minimal
    name, kw = choose(4096, 256, memory_budget_bytes=1)
    cands = ["flash", "checkpoint", "fused"]
    ws = {n: device_working_set(n, {"mode": "lean"} if n == "flash" else {},
                                4096, 256) for n in cands}
    assert name == min(ws, key=ws.get) == "checkpoint"
    # caller overrides reach the budget filter: pure lean (lean_leaf=0)
    # re-scans with up to T/4 live intervals — a bigger working set than
    # the hybrid's capped leaf pass
    ws_h = device_working_set("flash", {"mode": "lean"}, 4096, 256)
    ws_p = device_working_set("flash", {"mode": "lean", "lean_leaf": 0}, 4096, 256)
    assert ws_p > ws_h
    name, kw = choose(4096, 256, memory_budget_bytes=1, static={"num_segments": 32})
    assert kw["num_segments"] == 32


def test_auto_working_set_models_real_decode():
    """The budget filter must model the scratch the decode actually runs:
    checkpoint keeps floor(sqrt(T)) snapshot spacing."""
    from flash_viterbi_tpu.algorithms.auto import device_working_set

    K, T = 16384, 65536
    step = 256  # floor(sqrt(65536)), what checkpoint_decode runs
    got = device_working_set("checkpoint", {}, K, T)
    assert got == (T // step + 1) * K * 4 + step * K * 4
    assert got == device_working_set("checkpoint", {"step": step}, K, T)


def test_auto_memory_reporting_tracks_shape():
    """A reused auto Decoder must not report a stale choice recorded for a
    different shape (build() is public API; decode() rebuilds per call)."""
    from flash_viterbi_tpu.algorithms.auto import choose
    from flash_viterbi_tpu.algorithms.base import build

    import jax.numpy as jnp

    from flash_viterbi_tpu.models.generate import make_sparse_hmm

    d = build("auto")
    hmm, y = make_sparse_hmm(K=48, M=8, T=40, prob=0.2, seed=3)
    lh = hmm.log()
    d(jnp.asarray(lh.logA), jnp.asarray(lh.logB), jnp.asarray(lh.logPi),
      jnp.asarray(np.asarray(y), jnp.int32))  # records choice for (48, 40)
    # reporting for an unrelated long-T shape must re-derive its choice
    name, kw = choose(1024, 65536)
    want = build(name, **kw).analytic_memory(K=1024, T=65536)
    assert d.analytic_memory(K=1024, T=65536) == want


def test_auto_decodes_and_matches_vanilla(small_problem):
    hmm, y = small_problem
    want = decode(hmm, y, algorithm="vanilla", pad_to=1, warmup=False)
    got = decode(hmm, y, algorithm="auto", pad_to=1, warmup=False)
    np.testing.assert_array_equal(got.path, want.path)
    assert got.memory_bytes > 0


@pytest.mark.parametrize("K,M,T,N,seed", [
    (96, 10, 64, 4, 11), (96, 10, 64, 2, 11), (96, 10, 64, 1, 11),
    (96, 10, 64, 8, 11), (64, 8, 48, 4, 5), (128, 10, 96, 4, 13),
])
def test_long_shapes_checkpoint_and_lean(K, M, T, N, seed):
    """The two-pass √T scheme (checkpoint) and flash lean at the segment
    counts and lengths the long-sequence decoders are used with: both
    equal vanilla, as flash pointer mode does."""
    from flash_viterbi_tpu.models.generate import make_sparse_hmm

    hmm, y = make_sparse_hmm(K=K, M=M, T=T, prob=0.25, seed=seed)
    v = decode(hmm, y, algorithm="vanilla", pad_to=8, warmup=False)
    for alg, kw in [("checkpoint", {}), ("checkpoint", {"step": 7}),
                    ("flash", {"num_segments": N, "mode": "lean"}),
                    ("flash", {"num_segments": N})]:
        r = decode(hmm, y, algorithm=alg, pad_to=8, warmup=False, **kw)
        np.testing.assert_array_equal(r.path, v.path, err_msg=f"{alg} {kw}")

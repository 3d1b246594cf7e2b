"""Randomized cross-algorithm property test: on any seeded problem, every
exact algorithm must produce the identical path (the framework's central
invariant — same numerics contract, same tie-breaking)."""

import numpy as np
import pytest

import flash_viterbi_tpu as fvt
from flash_viterbi_tpu.oracle import framework as ofw

CASES = [
    # (K, M, T, prob, seed)
    (24, 3, 9, 0.6, 101),
    (40, 7, 21, 0.35, 102),
    (56, 11, 40, 0.2, 103),
    (72, 5, 13, 0.45, 104),
    (96, 16, 57, 0.15, 105),
    (33, 4, 26, 0.5, 106),   # K not a multiple of 8
    (128, 9, 31, 0.1, 107),
    (17, 2, 64, 0.7, 108),
]


@pytest.mark.parametrize("K,M,T,prob,seed", CASES)
def test_exact_algorithms_agree(K, M, T, prob, seed):
    hmm, y = fvt.make_sparse_hmm(K=K, M=M, T=T, prob=prob, seed=seed)
    want = ofw.vanilla(hmm.A, hmm.B, hmm.Pi, y)
    for alg, kw in [
        ("vanilla", {}),
        ("checkpoint", {}),
        ("fused", {}),
        ("flash", {"num_segments": 5}),
        ("flash", {"num_segments": 5, "mode": "lean"}),
        ("flash", {"num_segments": 5, "mode": "lean", "lean_leaf": 0}),
        ("flash", {"num_segments": 3, "mode": "lean", "lean_leaf": 4}),
        ("flash_bs", {"beam_width": K, "num_segments": 5}),
        ("beam", {"beam_width": K}),
    ]:
        r = fvt.decode(hmm, y, algorithm=alg, pad_to=1, warmup=False, **kw)
        np.testing.assert_array_equal(r.path, want,
                                      err_msg=f"{alg} {kw} K={K} T={T}")


SHARD_CASES = [
    # (K, M, T, prob, seed, mesh_shape, segs) — odd K/T exercise padding
    (33, 4, 26, 0.5, 206, (2, 2, 2), 4),
    (56, 11, 40, 0.2, 203, (1, 2, 2), 6),
    (72, 5, 23, 0.45, 204, (2, 2, 1), 4),
]


@pytest.mark.parametrize("K,M,T,prob,seed,mesh_shape,segs", SHARD_CASES)
def test_sharded_agrees_with_single_chip_fuzz(K, M, T, prob, seed,
                                              mesh_shape, segs):
    """Random problems through the public mesh path (decode_batch) must be
    bit-identical to per-sequence single-chip flash decodes."""
    from flash_viterbi_tpu.parallel.sharded import make_mesh

    hmm, y = fvt.make_sparse_hmm(K=K, M=M, T=T, prob=prob, seed=seed)
    rng = np.random.RandomState(seed)
    ys = np.stack([np.asarray(y, np.int32),
                   rng.randint(0, M, size=T).astype(np.int32)])
    r = fvt.decode_batch(hmm, ys, mesh=make_mesh(*mesh_shape),
                         num_segments=segs, warmup=False)
    for b in range(2):
        want = fvt.decode(hmm, ys[b], algorithm="flash", num_segments=segs,
                          mode="pointer", use_pallas=False, warmup=False)
        np.testing.assert_array_equal(
            r.path[b], want.path,
            err_msg=f"mesh={mesh_shape} segs={segs} K={K} T={T} b={b}")


DYN_SEEDS = [301, 302, 303, 304, 305, 306]


@pytest.mark.parametrize("seed", DYN_SEEDS)
def test_dynamic_median_family_fuzz(seed):
    """Randomized shapes through the host-driven dynamic-median decoders
    (the newest, least-exercised family) vs their reference-verified
    oracles — median pairs and flattened paths must agree exactly."""
    import jax.numpy as jnp

    from flash_viterbi_tpu.algorithms.sieve_bs import sieve_bs_decode
    from flash_viterbi_tpu.oracle.sieve_bs import ReferenceUndefined
    from flash_viterbi_tpu.oracle.sieve_bs import sieve_bs as oracle_bs

    rng = np.random.RandomState(seed)
    K = int(rng.randint(16, 96))
    M = int(rng.randint(2, 14))
    T = int(rng.randint(5, 48))
    prob = float(rng.uniform(0.15, 0.6))
    bw = int(rng.randint(2, max(3, K // 3)))
    hmm, y = fvt.make_sparse_hmm(K=K, M=M, T=T, prob=prob, seed=seed)
    lh = hmm.log()
    args = (jnp.asarray(lh.logA), jnp.asarray(lh.logB),
            jnp.asarray(lh.logPi), np.asarray(y))

    try:
        want = [tuple(int(v) for v in p)
                for p in oracle_bs(hmm.A, hmm.B, hmm.Pi, y, beam_width=bw)]
    except ReferenceUndefined:
        # reference crashes on this input (beam pruned every median
        # candidate); the device decoder must still be total
        got = sieve_bs_decode(*args, beam_width=bw)
        assert len(got) >= 1 and all(len(p) == 2 for p in got)
    else:
        got = sieve_bs_decode(*args, beam_width=bw)
        assert got == want, f"sieve_bs K={K} M={M} T={T} prob={prob:.2f} bw={bw}"

    # sieve_bs_mp: the fp32 framework mirror is the bit-exact yardstick
    # on arbitrary fixtures (the f64 oracle legitimately differs on
    # permuted-path ties — see algorithms/sieve.py docstring; tie-free
    # reference fidelity is pinned by the fixture tests in
    # sieve/beam decoder tests and test_sieve.py)
    from flash_viterbi_tpu.oracle.framework import sieve_bs_mp as mirror_bs_mp

    wantp = mirror_bs_mp(hmm.A, hmm.B, hmm.Pi, y, beam_width=bw)
    r = fvt.decode(hmm, y, algorithm="sieve_bs_mp", beam_width=bw,
                   pad_to=1, warmup=False)
    np.testing.assert_array_equal(
        r.path, wantp, err_msg=f"sieve_bs_mp K={K} M={M} T={T} bw={bw}")


@pytest.mark.parametrize("seed", DYN_SEEDS[:3])
def test_sieve_dynamic_fuzz(seed):
    """Randomized shapes through the device sieve (dynamic median, full
    state space) vs its oracle — median pairs must agree exactly."""
    import jax.numpy as jnp

    from flash_viterbi_tpu.algorithms.sieve_dyn import sieve_dynamic_decode
    from flash_viterbi_tpu.oracle.sieve import sieve_dynamic

    rng = np.random.RandomState(seed + 50)
    K = int(rng.randint(16, 80))
    M = int(rng.randint(2, 10))
    T = int(rng.randint(5, 40))
    prob = float(rng.uniform(0.2, 0.6))
    b = int(rng.randint(1, 4))
    hmm, y = fvt.make_sparse_hmm(K=K, M=M, T=T, prob=prob, seed=seed + 50)
    want = [tuple(int(v) for v in p)
            for p in sieve_dynamic(hmm.A, hmm.B, hmm.Pi, y, b_hops=b)]
    lh = hmm.log()
    got = sieve_dynamic_decode(jnp.asarray(lh.logA), jnp.asarray(lh.logB),
                               jnp.asarray(lh.logPi), np.asarray(y), b_hops=b)
    assert got == want, f"sieve K={K} M={M} T={T} b={b}"


@pytest.mark.parametrize("K,M,T,prob,seed", CASES)
def test_auto_budgeted_always_exact(K, M, T, prob, seed):
    """Whatever decoder a memory budget forces auto into — including the
    nothing-fits leanest fallback — the decoded path stays exact, and the
    selected candidate's modeled working set respects a satisfiable
    budget."""
    from flash_viterbi_tpu.algorithms.auto import choose, device_working_set

    hmm, y = fvt.make_sparse_hmm(K=K, M=M, T=T, prob=prob, seed=seed)
    want = ofw.vanilla(hmm.A, hmm.B, hmm.Pi, y)
    rng = np.random.RandomState(seed)
    # budgets spanning generous → impossible (log-uniform over bytes)
    budgets = [None] + [int(10 ** rng.uniform(2, 9)) for _ in range(4)]
    for budget in budgets:
        r = fvt.decode(hmm, y, algorithm="auto", pad_to=1, warmup=False,
                       memory_budget_bytes=budget)
        np.testing.assert_array_equal(
            r.path, want, err_msg=f"budget={budget} K={K} T={T}")
        if budget is not None:
            name, kw = choose(K, T, memory_budget_bytes=budget)
            ws = device_working_set(name, kw, K, T)
            fits_any = any(
                device_working_set(n, k, K, T) <= budget
                for n, k in [("flash", {"num_segments": 8}),
                             ("flash", {"mode": "lean"}),
                             ("checkpoint", {}), ("fused", {})])
            if fits_any:
                assert ws <= budget, (name, kw, ws, budget)


@pytest.mark.parametrize("seed_base", [600, 640])
def test_sieve_bs_mp_mirror_fuzz(seed_base):
    """Broad randomized sweep: the device sieve_bs_mp must be bit-exact
    with the fp32 framework mirror on every fixture — including NaN-row
    (zero-out-degree) models and permuted-path-tie configurations where
    the f64 reference oracle legitimately differs."""
    import warnings

    from flash_viterbi_tpu.oracle.framework import sieve_bs_mp as mirror

    for seed in range(seed_base, seed_base + 25):
        rng = np.random.RandomState(seed)
        K = int(rng.randint(16, 28))
        M = int(rng.randint(3, 8))
        T = int(rng.randint(6, 24))
        prob = float(rng.uniform(0.1, 0.25))
        bw = int(rng.randint(2, 6))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # NaN rows are intentional
            hmm, y = fvt.make_sparse_hmm(K=K, M=M, T=T, prob=prob, seed=seed)
        want = mirror(hmm.A, hmm.B, hmm.Pi, y, beam_width=bw)
        r = fvt.decode(hmm, y, algorithm="sieve_bs_mp", beam_width=bw,
                       pad_to=1, warmup=False)
        np.testing.assert_array_equal(
            r.path, want, err_msg=f"seed={seed} K={K} M={M} T={T} bw={bw}")


def test_sieve_bs_padding_invariance():
    """The uniform prior must use the LOGICAL state count (log(1/K), not
    log(1/Kp)) — padding to 128 dead states flips fp-tie outcomes
    otherwise.  Device decode at pad_to=128 must equal the mirror at the
    logical K and the pad_to=1 decode, including on tie-heavy fixtures."""
    from flash_viterbi_tpu.oracle.framework import sieve_bs as mirror

    for K, M, T, prob, seed in [(24, 3, 9, 0.6, 101), (100, 2, 40, 0.15, 31),
                                (17, 2, 16, 0.7, 108)]:
        hmm, y = fvt.make_sparse_hmm(K=K, M=M, T=T, prob=prob, seed=seed)
        bw = max(2, K // 3)
        a = fvt.decode(hmm, y, algorithm="sieve_bs", beam_width=bw,
                       pad_to=1, warmup=False)
        b = fvt.decode(hmm, y, algorithm="sieve_bs", beam_width=bw,
                       pad_to=128, warmup=False)
        np.testing.assert_array_equal(a.path, b.path,
                                      err_msg=f"K={K} seed={seed}")
        pairs = mirror(hmm.A, hmm.B, hmm.Pi, y, beam_width=bw)
        if pairs:
            flat = np.asarray([pairs[0][0], pairs[0][1]]
                              + [p[1] for p in pairs[1:]])[:T]
            want = np.full(T, -1, np.int64)
            want[: len(flat)] = flat
            np.testing.assert_array_equal(b.path, want,
                                          err_msg=f"K={K} seed={seed}")


@pytest.mark.parametrize("seed_base", [700, 730])
def test_sieve_bs_mirror_fuzz(seed_base):
    """Device sieve_bs (dynamic median) vs its fp32 framework mirror —
    bit-exact median pairs on arbitrary fixtures, NaN rows and
    reference-undefined (beam-exhausted) inputs included."""
    import warnings

    import jax.numpy as jnp

    from flash_viterbi_tpu.algorithms.sieve_bs import sieve_bs_decode
    from flash_viterbi_tpu.oracle.framework import sieve_bs as mirror

    for seed in range(seed_base, seed_base + 15):
        rng = np.random.RandomState(seed)
        K = int(rng.randint(16, 40))
        M = int(rng.randint(3, 8))
        T = int(rng.randint(4, 20))
        prob = float(rng.uniform(0.1, 0.3))
        bw = int(rng.randint(2, 7))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # NaN rows are intentional
            hmm, y = fvt.make_sparse_hmm(K=K, M=M, T=T, prob=prob, seed=seed)
        lh = hmm.log()
        got = sieve_bs_decode(jnp.asarray(lh.logA), jnp.asarray(lh.logB),
                              jnp.asarray(lh.logPi), np.asarray(y),
                              beam_width=bw)
        want = [tuple(int(v) for v in p)
                for p in mirror(hmm.A, hmm.B, hmm.Pi, y, beam_width=bw)]
        assert got == want, f"seed={seed} K={K} M={M} T={T} bw={bw}"

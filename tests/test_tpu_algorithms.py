"""sieve_mp and beam decoders: oracle parity and invariants."""

import numpy as np
import pytest

from flash_viterbi_tpu import decode
from flash_viterbi_tpu.oracle.sieve import sieve_mp


def test_sieve_mp_matches_oracle_f32(small_problem):
    hmm, y = small_problem
    want = sieve_mp(hmm.A, hmm.B, hmm.Pi, y, numerics="f32")
    r = decode(hmm, y, algorithm="sieve_mp", pad_to=1, warmup=False)
    np.testing.assert_array_equal(r.path, want)


def test_sieve_mp_pallas_and_padding_invariance(small_problem, request):
    """The Triton step (interpreted) and padding leave the path unchanged."""
    hmm, y = small_problem
    a = decode(hmm, y, algorithm="sieve_mp", pad_to=1, warmup=False)
    c = decode(hmm, y, algorithm="sieve_mp", pad_to=128, warmup=False)
    request.getfixturevalue("interpret_kernel")
    b = decode(hmm, y, algorithm="sieve_mp", pad_to=1, warmup=False)
    np.testing.assert_array_equal(a.path, b.path)
    np.testing.assert_array_equal(a.path, c.path)


def test_sieve_mp_unpruned_matches_on_dense(small_problem):
    """Without degenerate reachability, pruning only removes -inf states;
    prune=False must give the same path."""
    hmm, y = small_problem
    a = decode(hmm, y, algorithm="sieve_mp", pad_to=1, warmup=False)
    b = decode(hmm, y, algorithm="sieve_mp", pad_to=1, warmup=False,
               prune=False)
    np.testing.assert_array_equal(a.path, b.path)


def test_sieve_mp_nonuniform_pi_matches_oracle():
    """Root call must use the model Pi, not the uniform prior (the oracle
    mirrors SIEVE-Mp.c:499's isPiNone=0 top-level call)."""
    import dataclasses

    from flash_viterbi_tpu.models.generate import make_sparse_hmm

    hmm, y = make_sparse_hmm(K=48, M=8, T=32, prob=0.3, seed=5)
    rng = np.random.RandomState(99)
    Pi = rng.uniform(0.05, 1.0, hmm.K)
    hmm = dataclasses.replace(hmm, Pi=Pi / Pi.sum())
    want = sieve_mp(hmm.A, hmm.B, hmm.Pi, y, numerics="f32")
    r = decode(hmm, y, algorithm="sieve_mp", pad_to=1, warmup=False)
    np.testing.assert_array_equal(r.path, want)


@pytest.mark.parametrize("T", [17, 32, 33])
def test_sieve_mp_odd_lengths(T):
    from flash_viterbi_tpu.models.generate import make_sparse_hmm

    hmm, y = make_sparse_hmm(K=48, M=8, T=T, prob=0.3, seed=3)
    want = sieve_mp(hmm.A, hmm.B, hmm.Pi, y, numerics="f32")
    r = decode(hmm, y, algorithm="sieve_mp", pad_to=1, warmup=False)
    np.testing.assert_array_equal(r.path, want)


@pytest.mark.parametrize("K,M,T,prob,seed,bw", [
    (48, 8, 24, 0.25, 3, 8),
    (64, 12, 32, 0.3, 7, 16),
    (32, 6, 17, 0.4, 1, 4),
])
def test_sieve_bs_mp_matches_oracle(K, M, T, prob, seed, bw):
    """sieve_bs_mp vs the reference-Python-verified oracle (identical
    off exact float64 ties; these fixtures have none)."""
    from flash_viterbi_tpu.models.generate import make_sparse_hmm
    from flash_viterbi_tpu.oracle.sieve_bs import sieve_bs_mp as oracle_bs_mp

    hmm, y = make_sparse_hmm(K=K, M=M, T=T, prob=prob, seed=seed)
    pairs = oracle_bs_mp(hmm.A, hmm.B, hmm.Pi, y, beam_width=bw)
    want = np.asarray([pairs[0][0], pairs[0][1]] + [p[1] for p in pairs[1:]])[:T]
    r = decode(hmm, y, algorithm="sieve_bs_mp", beam_width=bw, pad_to=1,
               warmup=False)
    np.testing.assert_array_equal(r.path, want)


@pytest.mark.parametrize("K,M,T,prob,seed,bw", [
    (48, 8, 24, 0.25, 3, 8),
    (64, 12, 32, 0.3, 7, 16),
    (32, 6, 17, 0.4, 1, 4),
])
def test_sieve_bs_matches_oracle(K, M, T, prob, seed, bw):
    """sieve_bs (dynamic median) vs the reference-Python-verified
    oracle — median pairs must agree exactly (fixtures have no fp ties)."""
    import jax.numpy as jnp

    from flash_viterbi_tpu.algorithms.sieve_bs import sieve_bs_decode
    from flash_viterbi_tpu.models.generate import make_sparse_hmm
    from flash_viterbi_tpu.oracle.sieve_bs import sieve_bs as oracle_bs

    hmm, y = make_sparse_hmm(K=K, M=M, T=T, prob=prob, seed=seed)
    want = [tuple(int(v) for v in p)
            for p in oracle_bs(hmm.A, hmm.B, hmm.Pi, y, beam_width=bw)]
    lh = hmm.log()
    got = sieve_bs_decode(jnp.asarray(lh.logA), jnp.asarray(lh.logB),
                          jnp.asarray(lh.logPi), np.asarray(y),
                          beam_width=bw)
    assert got == want


def test_sieve_bs_large_k():
    """K >= 512 case (VERDICT item 3's 'done' bar)."""
    import jax.numpy as jnp

    from flash_viterbi_tpu.algorithms.sieve_bs import sieve_bs_decode
    from flash_viterbi_tpu.models.generate import make_sparse_hmm
    from flash_viterbi_tpu.oracle.sieve_bs import sieve_bs as oracle_bs

    K, M, T, prob, seed, bw = 512, 6, 16, 0.02, 5, 16
    hmm, y = make_sparse_hmm(K=K, M=M, T=T, prob=prob, seed=seed)
    want = [tuple(int(v) for v in p)
            for p in oracle_bs(hmm.A, hmm.B, hmm.Pi, y, beam_width=bw)]
    lh = hmm.log()
    got = sieve_bs_decode(jnp.asarray(lh.logA), jnp.asarray(lh.logB),
                          jnp.asarray(lh.logPi), np.asarray(y),
                          beam_width=bw)
    assert got == want


def test_sieve_bs_mp_large_k():
    """Beam-space step formulation survives larger K (no (S,K,K) scores)."""
    from flash_viterbi_tpu.models.generate import make_sparse_hmm
    from flash_viterbi_tpu.oracle.sieve_bs import sieve_bs_mp as oracle_bs_mp

    K, M, T, prob, seed, bw = 512, 6, 16, 0.02, 5, 16
    hmm, y = make_sparse_hmm(K=K, M=M, T=T, prob=prob, seed=seed)
    pairs = oracle_bs_mp(hmm.A, hmm.B, hmm.Pi, y, beam_width=bw)
    want = np.asarray([pairs[0][0], pairs[0][1]] + [p[1] for p in pairs[1:]])[:T]
    r = decode(hmm, y, algorithm="sieve_bs_mp", beam_width=bw, pad_to=1,
               warmup=False)
    np.testing.assert_array_equal(r.path, want)


def test_sieve_bs_registered(small_problem):
    """Registry integration: non-jittable decoder path through decode()."""
    hmm, y = small_problem
    r = decode(hmm, y, algorithm="sieve_bs", beam_width=8, pad_to=1,
               warmup=False)
    assert r.path.shape[0] == len(y)
    assert r.memory_bytes > 0


@pytest.mark.parametrize("K,M,T,prob,seed,bw,dag", [
    (48, 8, 33, 0.15, 1, 8, False),
    (96, 10, 48, 0.1, 2, 6, False),
    (64, 10, 32, 0.1, 2, 0, True),
    (96, 12, 48, 0.08, 4, 0, False),
])
def test_device_engines_match_host_schedulers(K, M, T, prob, seed, bw, dag):
    """Round-5 on-device recursion engines vs the round-4 host-driven
    level schedulers: identical pair lists, per node, per fixture —
    the two executions of the same per-node math must never diverge."""
    import jax.numpy as jnp

    from flash_viterbi_tpu.algorithms.sieve_bs import sieve_bs_decode
    from flash_viterbi_tpu.algorithms.sieve_dyn import sieve_dynamic_decode_many
    from flash_viterbi_tpu.models.generate import make_dag_hmm, make_sparse_hmm

    if dag:
        hmm, y = make_dag_hmm(K=K, M=M, T=T, seed=seed, sanitize=True)
    else:
        hmm, y = make_sparse_hmm(K=K, M=M, T=T, prob=prob, seed=seed)
    lh = hmm.log()
    tbl = (jnp.asarray(lh.logA), jnp.asarray(lh.logB), jnp.asarray(lh.logPi))
    if bw:
        dev = sieve_bs_decode(*tbl, np.asarray(y), beam_width=bw,
                              engine="device")
        host = sieve_bs_decode(*tbl, np.asarray(y), beam_width=bw,
                               engine="host")
    else:
        dev = sieve_dynamic_decode_many(*tbl, np.asarray(y)[None], dag=dag,
                                        engine="device")[0]
        host = sieve_dynamic_decode_many(*tbl, np.asarray(y)[None], dag=dag,
                                         engine="host")[0]
    assert dev == host


def test_beam_full_width_equals_vanilla(small_problem):
    hmm, y = small_problem
    v = decode(hmm, y, algorithm="vanilla", warmup=False, pad_to=1)
    b = decode(hmm, y, algorithm="beam", beam_width=hmm.K, warmup=False,
               pad_to=1)
    np.testing.assert_array_equal(v.path, b.path)


def test_beam_monotone_quality(small_problem):
    """Wider beams never decrease the decoded path's log-likelihood."""
    hmm, y = small_problem
    with np.errstate(divide="ignore"):
        lA, lB, lPi = (np.log(x) for x in (hmm.A, hmm.B, hmm.Pi))

    def ll(p):
        s = lPi[p[0]] + lB[p[0], y[0]]
        s += sum(lA[p[t - 1], p[t]] + lB[p[t], y[t]] for t in range(1, len(y)))
        return s

    lls = []
    for bw in (4, 16, hmm.K):
        r = decode(hmm, y, algorithm="beam", beam_width=bw, warmup=False, pad_to=1)
        lls.append(ll(r.path))
    assert lls[0] <= lls[1] + 1e-6 <= lls[2] + 2e-6


# ---------------------------------------------------------------------------
# sieve (dynamic median) and sieve_dag decoders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K,M,T,prob,seed,b", [
    (48, 8, 24, 0.25, 3, 4),
    (64, 12, 32, 0.3, 7, 5),
    (32, 6, 17, 0.4, 1, 3),
])
def test_sieve_dynamic_matches_oracle(K, M, T, prob, seed, b):
    """sieve (dynamic median) vs the reference-Python-verified oracle —
    median pairs must agree exactly (fixtures have no fp ties)."""
    import jax.numpy as jnp

    from flash_viterbi_tpu.algorithms.sieve_dyn import sieve_dynamic_decode
    from flash_viterbi_tpu.models.generate import make_sparse_hmm
    from flash_viterbi_tpu.oracle.sieve import sieve_dynamic

    hmm, y = make_sparse_hmm(K=K, M=M, T=T, prob=prob, seed=seed)
    want = [tuple(int(v) for v in p)
            for p in sieve_dynamic(hmm.A, hmm.B, hmm.Pi, y, b_hops=b)]
    lh = hmm.log()
    got = sieve_dynamic_decode(jnp.asarray(lh.logA), jnp.asarray(lh.logB),
                               jnp.asarray(lh.logPi), np.asarray(y), b_hops=b)
    assert got == want


def test_sieve_dag_matches_oracle():
    import jax.numpy as jnp

    from flash_viterbi_tpu.algorithms.sieve_dyn import sieve_dynamic_decode
    from flash_viterbi_tpu.models.generate import make_dag_hmm
    from flash_viterbi_tpu.oracle.sieve import sieve_dag

    for K, M, T, seed in [(24, 8, 16, 3), (40, 6, 20, 11)]:
        hmm, y = make_dag_hmm(K=K, M=M, T=T, seed=seed, sanitize=True)
        want = [tuple(int(v) for v in p)
                for p in sieve_dag(hmm.A, hmm.B, hmm.Pi, y)]
        lh = hmm.log()
        got = sieve_dynamic_decode(jnp.asarray(lh.logA), jnp.asarray(lh.logB),
                                   jnp.asarray(lh.logPi), np.asarray(y),
                                   dag=True)
        assert got == want


def test_sieve_dynamic_padding_invariance(small_problem):
    """decode() at pad_to=128 must yield the same flattened output as
    pad_to=1 (padded states are dead; uniform prior uses logical K)."""
    hmm, y = small_problem
    a = decode(hmm, y, algorithm="sieve", warmup=False, pad_to=1)
    b = decode(hmm, y, algorithm="sieve", warmup=False, pad_to=128)
    np.testing.assert_array_equal(a.path, b.path)
    assert (a.path != -1).any()

"""Mid-scale fuzz for the round-5 on-device recursion engines.

The unit fixtures pin dev==host at a handful of shapes; this sweep
samples the K 96-512 / T 48-256 regime (including near-tie densities,
DAG inputs, non-uniform Pi, and tiny beams that trigger the sentinel /
beam-fallout paths) and asserts, per fixture:

* ``sieve_bs``  — device engine pair list == host scheduler pair list;
* ``sieve`` / ``sieve_dag`` — device engine == host scheduler;
* ``sieve_bs`` batched (``decode_many``) == per-sequence decodes.

Runs on the CPU.  Usage:
    python scripts/fuzz_engines.py [n_rounds] [seed0]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

import flash_viterbi_tpu as fvt  # noqa: E402
from flash_viterbi_tpu.algorithms.sieve_bs import sieve_bs_decode_many  # noqa: E402
from flash_viterbi_tpu.algorithms.sieve_dyn import (  # noqa: E402
    sieve_dynamic_decode_many,
)

N_ROUNDS = int(sys.argv[1]) if len(sys.argv) > 1 else 25
SEED0 = int(sys.argv[2]) if len(sys.argv) > 2 else 50_000

failures = []
rng = np.random.default_rng(SEED0)
for i in range(N_ROUNDS):
    K = int(rng.choice([96, 128, 160, 256, 384, 512]))
    T = int(rng.choice([48, 64, 96, 128, 192, 256]))
    M = int(rng.integers(4, 40))
    prob = float(rng.choice([0.02, 0.05, 0.1, 0.2]))
    seed = int(rng.integers(0, 10_000))
    dag = bool(rng.integers(0, 3) == 0)
    bw = int(rng.choice([2, 4, 8, 16, 32]))
    try:
        if dag:
            hmm, y = fvt.make_dag_hmm(K=K, M=M, T=T, seed=seed, sanitize=True)
        else:
            hmm, y = fvt.make_sparse_hmm(K=K, M=M, T=T, prob=prob, seed=seed)
        lh = hmm.log()
        tbl = (jnp.asarray(lh.logA), jnp.asarray(lh.logB),
               jnp.asarray(lh.logPi))
        ys = np.asarray(y)[None]

        dev = sieve_bs_decode_many(*tbl, ys, bw, engine="device")[0]
        host = sieve_bs_decode_many(*tbl, ys, bw, engine="host")[0]
        assert dev == host, "sieve_bs dev!=host"

        ddev = sieve_dynamic_decode_many(*tbl, ys, dag=dag,
                                         engine="device")[0]
        dhost = sieve_dynamic_decode_many(*tbl, ys, dag=dag,
                                          engine="host")[0]
        assert ddev == dhost, "sieve_dyn dev!=host"

        if i % 5 == 0:  # batched == per-sequence (3 random sequences)
            rng2 = np.random.default_rng(seed + 1)
            ys3 = np.stack([np.asarray(y)] + [
                rng2.integers(0, M, size=T).astype(np.int64)
                for _ in range(2)])
            many = sieve_bs_decode_many(*tbl, ys3, bw, engine="device")
            for s in range(3):
                one = sieve_bs_decode_many(*tbl, ys3[s][None], bw,
                                           engine="device")[0]
                assert many[s] == one, f"batched!=single at seq {s}"
        print(f"[{i}] ok K={K} T={T} M={M} prob={prob} dag={dag} bw={bw}",
              flush=True)
        if i % 8 == 7:
            # every fixture shape compiles fresh engine programs; without
            # this the CPU jit cache grows until LLVM OOMs the host
            # (~33 distinct shapes in one process, observed round 5)
            jax.clear_caches()
    except AssertionError as e:
        failures.append((i, K, T, M, prob, seed, dag, bw, str(e)))
        print(f"[{i}] FAIL {e} K={K} T={T} M={M} prob={prob} seed={seed} "
              f"dag={dag} bw={bw}", flush=True)

print(f"done: {N_ROUNDS - len(failures)}/{N_ROUNDS} ok; "
      f"failures: {failures}")
sys.exit(1 if failures else 0)

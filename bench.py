"""Headline benchmark: FLASH full-state decode, K=3965, T=256 (paper config).

Prints ONE JSON line: trellis updates (K^2*T)/s on one card, compared to the
reference C SIEVE-Mp baseline at the same config (672.6 s == 5.98 M updates/s,
the reference README.md:79 — see BASELINE.md).  Exact path parity against
the framework's numpy oracle is asserted before reporting.

Timing: the median wall time of the jitted decode to completion
(``jax.block_until_ready``) over a few runs, after a warm-up run that
compiles it.  The device the figure was taken on is part of the output.

Without a GPU the script exits non-zero; ``--cpu`` runs it on the CPU
explicitly (``--smoke`` shrinks the problem).
"""

from __future__ import annotations

import json
import sys

K, M, T, PROB, SEED = 3965, 50, 256, 0.112, 1
BASELINE_UPDATES_PER_S = (3965.0**2 * 256.0) / 672.6  # C SIEVE-Mp, README.md:79


def main(argv=None) -> int:
    global K, M, T, PROB
    argv = sys.argv[1:] if argv is None else argv
    if "--smoke" in argv:
        K, M, T, PROB = 256, 10, 64, 0.2

    import jax

    if "--cpu" in argv:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from flash_viterbi_tpu import make_sparse_hmm
    from flash_viterbi_tpu.algorithms.flash import flash_decode
    from flash_viterbi_tpu.oracle import native as oracle
    from flash_viterbi_tpu.utils.cache import enable_compile_cache
    from flash_viterbi_tpu.utils.profiling import wall_time

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu" and "--cpu" not in argv:
        print(f"bench.py: no GPU (found {dev.platform}); pass --cpu to run "
              "on the CPU", file=sys.stderr)
        return 2

    hmm, y = make_sparse_hmm(K=K, M=M, T=T, prob=PROB, seed=SEED)
    lh = hmm.log().padded(128)
    args = (jnp.asarray(lh.logA), jnp.asarray(lh.logB), jnp.asarray(lh.logPi),
            jnp.asarray(y, jnp.int32))
    fn = jax.jit(lambda a, b, p, yy: flash_decode(a, b, p, yy, num_segments=16))
    wall = wall_time(fn, *args, reps=5)
    path = np.asarray(fn(*args))

    want = oracle.vanilla(hmm.A, hmm.B, hmm.Pi, y)
    parity = bool((path[:T] == want).all())
    if not parity:
        print(f"# PARITY FAILURE: {int((path[:T] != want).sum())}/{T} mismatches",
              file=sys.stderr)

    updates_per_s = (K * K * T) / wall
    print(json.dumps({
        "metric": "trellis_updates_per_s",
        "value": updates_per_s,
        "unit": "updates/s",
        "vs_baseline": updates_per_s / BASELINE_UPDATES_PER_S,
        "wall_s": wall,
        "config": f"K={K},T={T},prob={PROB},flash N=16",
        "exact_path_parity": parity,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    return 0 if parity else 1


if __name__ == "__main__":
    raise SystemExit(main())

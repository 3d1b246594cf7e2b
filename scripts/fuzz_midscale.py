"""Mid-scale fuzz: the fp32 tie-flip regime (K 128-512, T 128-1024).

The committed fuzz tests and scripts/fuzz_hunt.py sample K<140, T<80 —
small enough that exact-tie flips essentially never fire, so the
tie-flip arbitration (oracle.validate) and the flash-family behavior at
scale were only pinned by hand-picked shapes.  This sweep samples the
regime where flips actually occur:

* dense family (vanilla/checkpoint/fused) must stay bit-equal to the
  native C vanilla oracle;
* flash (pointer + lean) must either match vanilla or pass tie-flip
  arbitration against the f32 FLASH mirror;
* the sharded pipelined path must stay bit-equal to same-segment flash
  on a random virtual mesh.

Usage:  python scripts/fuzz_midscale.py [n_rounds] [seed0]
"""

import os
import sys
import warnings

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

import flash_viterbi_tpu as fvt  # noqa: E402
from flash_viterbi_tpu.oracle import native  # noqa: E402
from flash_viterbi_tpu.oracle.validate import (  # noqa: E402
    arbitrate_flash_tie_flip,
    effective_flash_segments,
)

N_ROUNDS = int(sys.argv[1]) if len(sys.argv) > 1 else 40
SEED0 = int(sys.argv[2]) if len(sys.argv) > 2 else 90_000

failures = []
flips_seen = 0


def check(name, cond, ctx):
    if not cond:
        failures.append((name, ctx))
        print(f"FAIL {name}: {ctx}", flush=True)


def one_round(seed):
    global flips_seen
    rng = np.random.RandomState(seed)
    K = int(rng.randint(128, 513))
    M = int(rng.randint(8, 51))
    T = int(rng.choice([128, 256, 512, 1024]))
    prob = float(rng.uniform(0.05, 0.3))
    segs = int(rng.choice([4, 6, 8]))
    ctx = f"seed={seed} K={K} M={M} T={T} prob={prob:.3f} segs={segs}"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        hmm, y = fvt.make_sparse_hmm(K=K, M=M, T=T, prob=prob, seed=seed)

    want = native.vanilla(hmm.A, hmm.B, hmm.Pi, y)

    for alg in ("vanilla", "checkpoint", "fused"):
        r = fvt.decode(hmm, y, algorithm=alg, warmup=False)
        check(f"exact:{alg}", (np.asarray(r.path) == want).all(), ctx)

    # every flash variant resolves exact ties its own way (pointer-table
    # backtrack vs the C's midpoint restarts) — each mode independently
    # passes the tiered invariant: ==vanilla, or mirror-exact, or
    # tie-equivalent (see oracle.validate.arbitrate_flash_tie_flip)
    for mode in ("pointer", "lean"):
        r = fvt.decode(hmm, y, algorithm="flash", num_segments=segs,
                       mode=mode, warmup=False)
        path = np.asarray(r.path)
        if (path == want).all():
            continue
        flips_seen += 1
        verdict = arbitrate_flash_tie_flip(hmm.A, hmm.B, hmm.Pi, y,
                                           path, segs)
        check(f"flash:{mode}:arbitration",
              verdict in ("mirror-exact", "tie-equivalent") or
              (verdict is None and effective_flash_segments(T, segs) <= 2),
              f"{ctx} mode={mode} verdict={verdict}")
    flash_paths = {"pointer": np.asarray(
        fvt.decode(hmm, y, algorithm="flash", num_segments=segs,
                   warmup=False).path)}

    # beam family at midscale K: decoder == its fp32 mirror bit-exactly
    if seed % 4 == 0:
        from flash_viterbi_tpu.oracle import framework as ofw
        bw = int(rng.choice([16, 32, 64]))
        r = fvt.decode(hmm, y, algorithm="flash_bs", beam_width=bw,
                       num_segments=segs, warmup=False)
        m = ofw.flash_bs(hmm.A, hmm.B, hmm.Pi, y, beam_width=bw,
                         num_segments=segs)
        check("flash_bs-mirror",
              (np.asarray(r.path) == np.asarray(m)[:T]).all(),
              f"{ctx} bw={bw}")
        r = fvt.decode(hmm, y, algorithm="beam", beam_width=bw,
                       warmup=False)
        m = ofw.beam(hmm.A, hmm.B, hmm.Pi, y, beam_width=bw)
        check("beam-mirror",
              (np.asarray(r.path) == np.asarray(m)[:T]).all(),
              f"{ctx} bw={bw}")

    # sieve_mp at midscale K (T capped: the level tree grows with T)
    if seed % 5 == 0 and T <= 256:
        from flash_viterbi_tpu.oracle.sieve import sieve_mp
        r = fvt.decode(hmm, y, algorithm="sieve_mp", warmup=False)
        m = sieve_mp(hmm.A, hmm.B, hmm.Pi, y, numerics="f32")
        check("sieve_mp-oracle",
              (np.asarray(r.path) == np.asarray(m)[:T]).all(), ctx)

    # batched decode (one lane per sequence in the N-lane step) must be
    # bit-equal to per-sequence decodes — including on tie-flip fixtures
    if seed % 3 == 0:
        from flash_viterbi_tpu.parallel.batch import decode_batch
        rng2 = np.random.RandomState(seed + 1)
        y2 = rng2.randint(0, M, size=T).astype(np.int32)
        rb = decode_batch(hmm, np.stack([np.asarray(y, np.int32), y2]),
                          algorithm="fused", warmup=False)
        p1 = np.asarray(fvt.decode(hmm, y, algorithm="fused",
                                   warmup=False).path)
        p2 = np.asarray(fvt.decode(hmm, y2, algorithm="fused",
                                   warmup=False).path)
        check("batch==per-seq",
              (rb.path[0] == p1).all() and (rb.path[1] == p2).all(), ctx)

    # sharded pipelined vs same-segment single-card flash
    if seed % 2 == 0:
        from flash_viterbi_tpu.parallel.sharded import (
            flash_decode_sharded,
            make_mesh,
        )
        lh = hmm.log().padded(8)
        n_seq = int(rng.choice([1, 2, 4]))
        n_state = int(rng.choice([1, 2]))
        if T % n_seq == 0 and segs % n_seq == 0:
            pad = n_state * max(1, -(-lh.Kp // n_state))
            lh2 = lh.padded(pad) if lh.Kp % n_state else lh
            mesh = make_mesh(1, n_seq, n_state)
            out = flash_decode_sharded(
                mesh, jnp.asarray(lh2.logA), jnp.asarray(lh2.logB),
                jnp.asarray(lh2.logPi),
                jnp.asarray(np.asarray(y, np.int32))[None],
                num_segments=segs, pipeline="auto")
            check("sharded==flash",
                  (np.asarray(out[0]) == flash_paths["pointer"]).all(),
                  f"{ctx} mesh=(1,{n_seq},{n_state})")


for i in range(N_ROUNDS):
    one_round(SEED0 + i)
    jax.clear_caches()  # fresh shapes every round: bound the JIT cache
    if (i + 1) % 5 == 0:
        print(f"# {i + 1}/{N_ROUNDS} rounds, {len(failures)} failures, "
              f"{flips_seen} tie-flip rounds", flush=True)

print(f"DONE: {N_ROUNDS} rounds, {len(failures)} failures, "
      f"{flips_seen} rounds with flash tie flips", flush=True)
sys.exit(1 if failures else 0)

"""Smoke run of the decode path on one GPU, through the public API.

    python chip_smoke.py               # one card: phases 1-5
    python chip_smoke.py --four-cards  # four cards: the sharded path only

Phases, one line each, in order:

1. device — the first JAX device must be a GPU (no CPU fallback); prints
   its kind, ``nvidia-smi`` name and power limit, and the compile cache.
2. headline — the reference's published configuration (K=3965, M=50,
   T=256, prob=0.112, seed 1; padded to K=3968): flash pointer and lean
   (16 segments), fused, checkpoint and vanilla, each bit-equal to the
   native C oracle (a flash tie flip is arbitrated against the f32 FLASH
   mirror); flash_bs with B=32 against its fp32 mirror; sieve_mp at
   K=1024 against its oracle (its frontier matmuls may run in TF32).
3. batch — ``decode_batch`` of 64 headline sequences: the fused lane batch
   row for row equal to single-sequence fused decodes, and the flash batch
   (``algorithm="flash"``) equal to single-sequence flash decodes.
4. large — K=16384, T=2048 (1 GiB of fp32 logA): flash pointer on the
   Triton step bit-equal to flash on the XLA step, checkpoint bit-equal to
   fused; flash may resolve exact fp32 ties differently from those global
   sweeps, so every path's f64 score must be within
   ``score_tolerance_f64`` of the fp32 DP optimum.
5. kernels — the Triton step against the plain XLA step at K=3968
   (N = 1, 16, 64) and K=16384 (N = 1): values and pointers bit-equal.

``--four-cards`` runs only the sharded decode (K=16384, T=4096, batch 8)
over the (data, seq, state) meshes (4,1,1), (2,1,2) and (1,2,2), each
path bit-equal to the same decode on a one-card mesh, which is compared
with the single-card ``flash_decode`` on card 0 (equal, or tie-equivalent
by f64 score where exact fp32 ties flipped).

Every failed check raises, so the script exits non-zero; the last line of
standard output is the result as one JSON object.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

HEADLINE = dict(K=3965, M=50, T=256, prob=0.112, seed=1)
SEGMENTS = 16
SIEVE_K = 1024
BATCH = 64
LARGE = dict(K=16384, T=2048)
KERNEL_SHAPES = [(3968, 1), (3968, 16), (3968, 64), (16384, 1)]
FOUR_CARDS = dict(K=16384, T=4096, batch=8)


class SmokeFailure(RuntimeError):
    pass


def check(ok, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def say(phase: str, msg: str, t0: float) -> None:
    print(f"[{phase}] {msg} ({time.perf_counter() - t0:.1f} s)", flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip()


def phase_device(jax) -> None:
    from flash_viterbi_tpu.utils.cache import enable_compile_cache

    t0 = time.perf_counter()
    dev = jax.devices()[0]
    check(dev.platform == "gpu", f"no GPU: the first device is {dev.platform}")
    cache = enable_compile_cache()
    print(card_line(), flush=True)  # name, power limit (one line per card)
    say("device", f"ok: {dev.platform} {dev.device_kind} x{len(jax.devices())}"
        f", compile cache {cache}", t0)


def same_path(got, want, what: str) -> None:
    got, want = np.asarray(got), np.asarray(want)
    check(got.shape == want.shape, f"{what}: shape {got.shape} != {want.shape}")
    bad = int((got != want).sum())
    check(bad == 0, f"{what}: {bad} positions differ")


def phase_headline(fvt) -> None:
    from flash_viterbi_tpu.oracle import framework as fw
    from flash_viterbi_tpu.oracle import native
    from flash_viterbi_tpu.oracle.sieve import sieve_mp
    from flash_viterbi_tpu.oracle.validate import arbitrate_flash_tie_flip

    t0 = time.perf_counter()
    hmm, y = fvt.make_sparse_hmm(**HEADLINE)
    want = native.vanilla(hmm.A, hmm.B, hmm.Pi, y)
    notes = []
    for alg, kw in [("flash", {"num_segments": SEGMENTS}),
                    ("flash", {"num_segments": SEGMENTS, "mode": "lean"}),
                    ("fused", {}), ("checkpoint", {}), ("vanilla", {})]:
        r = fvt.decode(hmm, y, algorithm=alg, **kw)
        check(r.extra["K_padded"] == -(-HEADLINE["K"] // 128) * 128,
              f"padded K {r.extra['K_padded']}")
        name = f"{alg}{'/' + kw['mode'] if 'mode' in kw else ''}"
        if (r.path == want).all():
            notes.append(f"{name} {r.time_s * 1e3:.2f} ms")
            continue
        check(alg == "flash", f"{name}: {(r.path != want).sum()} positions "
              "differ from the oracle")
        verdict = arbitrate_flash_tie_flip(hmm.A, hmm.B, hmm.Pi, y, r.path,
                                           SEGMENTS)
        check(verdict in ("mirror-exact", "tie-equivalent"),
              f"{name}: differs from vanilla and the mirror ({verdict})")
        notes.append(f"{name} {verdict}")
    r = fvt.decode(hmm, y, algorithm="flash_bs", beam_width=32,
                   num_segments=SEGMENTS)
    same_path(r.path, fw.flash_bs(hmm.A, hmm.B, hmm.Pi, y, beam_width=32,
                                  num_segments=SEGMENTS), "flash_bs B=32")
    notes.append(f"flash_bs {r.time_s * 1e3:.2f} ms")
    hs, ys = fvt.make_sparse_hmm(**{**HEADLINE, "K": SIEVE_K})
    r = fvt.decode(hs, ys, algorithm="sieve_mp")
    same_path(r.path, sieve_mp(hs.A, hs.B, hs.Pi, ys, numerics="f32"),
              f"sieve_mp K={SIEVE_K}")
    notes.append(f"sieve_mp K={SIEVE_K} {r.time_s * 1e3:.2f} ms")
    say("headline", "ok: " + ", ".join(notes), t0)


def phase_batch(fvt, jax) -> None:
    import jax.numpy as jnp

    t0 = time.perf_counter()
    hmm, y = fvt.make_sparse_hmm(**HEADLINE)
    rng = np.random.default_rng(HEADLINE["seed"])
    ys = np.concatenate([np.asarray(y, np.int32)[None],
                         rng.integers(0, HEADLINE["M"],
                                      (BATCH - 1, HEADLINE["T"]),
                                      dtype=np.int32)])
    fused = fvt.decode_batch(hmm, ys)
    flash = fvt.decode_batch(hmm, ys, algorithm="flash",
                             num_segments=SEGMENTS)
    lh = hmm.log().padded(128)
    tables = [jnp.asarray(x) for x in (lh.logA, lh.logB, lh.logPi)]
    one_fused = jax.jit(fvt.build("fused"))
    one_flash = jax.jit(fvt.build("flash", num_segments=SEGMENTS))
    for b in range(len(ys)):
        yb = jnp.asarray(ys[b])
        same_path(fused.path[b], one_fused(*tables, yb), f"fused row {b}")
        same_path(flash.path[b], one_flash(*tables, yb), f"flash row {b}")
    say("batch", f"ok: {BATCH} rows equal their single-sequence decodes; "
        f"fused lane batch {fused.time_s * 1e3:.1f} ms, flash vmap "
        f"{flash.time_s * 1e3:.1f} ms", t0)


def phase_large(fvt, jax) -> None:
    import jax.numpy as jnp

    from flash_viterbi_tpu.ops import maxplus as mp
    from flash_viterbi_tpu.oracle.validate import (path_score_f64,
                                                   score_tolerance_f64)

    t0 = time.perf_counter()
    K, T = LARGE["K"], LARGE["T"]
    hmm, y = fvt.make_sparse_hmm(**{**HEADLINE, **LARGE})
    lh = hmm.log()
    paths = {}
    for name, alg, kw in [
            ("flash", "flash", {"num_segments": SEGMENTS}),
            ("flash[xla step]", "flash", {"num_segments": SEGMENTS,
                                          "use_pallas": False}),
            ("checkpoint", "checkpoint", {}), ("fused", "fused", {})]:
        paths[name] = fvt.decode(lh, y, algorithm=alg, warmup=False,
                                 **kw).path
    same_path(paths["flash"], paths["flash[xla step]"],
              "flash on the Triton step vs flash on the XLA step")
    same_path(paths["checkpoint"], paths["fused"], "checkpoint vs fused")
    # flash restarts its DP at the segment anchors, so on exact fp32 ties
    # it may pick another optimal path than the global sweeps: compared by
    # f64 score below, as oracle.validate.arbitrate_flash_tie_flip does
    flips = int((paths["flash"] != paths["fused"]).sum())

    @jax.jit
    def best_score(logA, logB, logPi, yd):
        emits = logB[:, yd].T
        dfin, _ = mp.forward_scan(logPi + emits[0], logA, emits[1:])
        return jnp.max(dfin)

    ref = float(best_score(jnp.asarray(lh.logA), jnp.asarray(lh.logB),
                           jnp.asarray(lh.logPi), jnp.asarray(y, jnp.int32)))
    tol = score_tolerance_f64(T, ref)
    scores = {}
    for name in ("flash", "fused"):
        got = path_score_f64(hmm.A, hmm.B, hmm.Pi, y, paths[name])
        check(np.isfinite(got) and abs(got - ref) <= tol,
              f"{name}: f64 path score {got} vs fp32 optimum {ref} "
              f"(tolerance {tol})")
        scores[name] = got
    say("large", f"ok: K={K} T={T}: flash on the Triton step == flash on "
        f"the XLA step, checkpoint == fused, flash differs from them at "
        f"{flips} positions (exact-tie resolution); f64 scores flash {scores['flash']:.4f}, "
        f"fused {scores['fused']:.4f}, fp32 optimum {ref:.4f} (tolerance "
        f"{tol:.3f}); the numpy oracle is too slow at this size and was "
        "not run", t0)


def phase_kernels(jax) -> None:
    import jax.numpy as jnp

    from flash_viterbi_tpu.ops.maxplus import maxplus_lanes_xla
    from flash_viterbi_tpu.ops.maxplus_triton import maxplus_lanes_triton

    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    ref = jax.jit(maxplus_lanes_xla)
    for K, N in KERNEL_SHAPES:
        logA = rng.standard_normal((K, K), np.float32)
        logA[5] = logA[9]  # duplicate source rows: exact ties everywhere
        logA[:, 7] = -np.inf
        delta = rng.standard_normal((N, K), np.float32)
        delta[:, 9] = delta[:, 5]
        a, d = jnp.asarray(logA), jnp.asarray(delta)
        v1, p1 = maxplus_lanes_triton(d, a)
        v2, p2 = ref(d, a)
        same_path(v1, v2, f"step values K={K} N={N}")
        same_path(p1, p2, f"step pointers K={K} N={N}")
    say("kernels", "ok: Triton step == XLA step at (K, N) = "
        + ", ".join(map(str, KERNEL_SHAPES)), t0)


def phase_four_cards(fvt, jax) -> None:
    import jax.numpy as jnp

    from flash_viterbi_tpu.algorithms.flash import flash_decode
    from flash_viterbi_tpu.oracle.validate import (path_score_f64,
                                                   score_tolerance_f64)
    from flash_viterbi_tpu.parallel.sharded import make_mesh

    t0 = time.perf_counter()
    devs = jax.devices()
    check(len(devs) == 4, f"--four-cards needs 4 cards, found {len(devs)}")
    K, T, B = FOUR_CARDS["K"], FOUR_CARDS["T"], FOUR_CARDS["batch"]
    hmm, y = fvt.make_sparse_hmm(**{**HEADLINE, "K": K, "T": T})
    lh = hmm.log().padded(128)
    rng = np.random.default_rng(1)
    ys = np.concatenate([np.asarray(y, np.int32)[None],
                         rng.integers(0, HEADLINE["M"], (B - 1, T),
                                      dtype=np.int32)])
    single = jax.jit(lambda a, b, p, yy: flash_decode(
        a, b, p, yy, num_segments=SEGMENTS))
    tables = [jax.device_put(x, devs[0]) for x in (lh.logA, lh.logB, lh.logPi)]
    want = np.stack([np.asarray(single(*tables, jax.device_put(
        jnp.asarray(ys[b]), devs[0]))) for b in range(B)])
    del tables
    # the sharded decode cuts T into equal segments; flash_decode places
    # its anchors one step apart from them, so on exact fp32 ties the two
    # may pick different optimal paths.  The same sharded program on a
    # one-card mesh is the bit-exact witness; flash_decode is checked by
    # path equality or, where ties flipped, by f64 score.
    base = fvt.decode_batch(lh, ys, mesh=make_mesh(1, 1, 1, devices=devs[:1]),
                            num_segments=SEGMENTS, warmup=False).path
    flips = int((base != want).sum())
    for b in range(B):
        if (base[b] != want[b]).any():
            s_got = path_score_f64(hmm.A, hmm.B, hmm.Pi, ys[b], base[b])
            s_ref = path_score_f64(hmm.A, hmm.B, hmm.Pi, ys[b], want[b])
            check(np.isfinite(s_got) and abs(s_got - s_ref)
                  <= score_tolerance_f64(T, s_ref),
                  f"row {b}: sharded f64 score {s_got} vs flash {s_ref}")
    notes = []
    for shape in [(4, 1, 1), (2, 1, 2), (1, 2, 2)]:
        mesh = make_mesh(*shape)
        ids = sorted(d.id for d in mesh.devices.ravel())
        check(len(set(ids)) == 4, f"mesh {shape} uses cards {ids}")
        r = fvt.decode_batch(lh, ys, mesh=mesh, num_segments=SEGMENTS,
                             warmup=False)
        same_path(r.path, base, f"mesh {shape} vs the one-card mesh")
        notes.append(f"{shape} {r.time_s:.2f} s")
    say("four-cards", f"ok: K={K} T={T} batch {B}: every mesh == the "
        f"one-card mesh on card 0 ({', '.join(notes)}); single-card "
        f"flash_decode differs at {flips} positions (each differing row "
        "tie-equivalent by f64 score)", t0)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    import jax

    import flash_viterbi_tpu as fvt

    phase_device(jax)
    if "--four-cards" in argv:
        phase_four_cards(fvt, jax)
    else:
        phase_headline(fvt)
        phase_batch(fvt, jax)
        phase_large(fvt, jax)
        phase_kernels(jax)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Time the N-lane max-plus step on the GPU: the Triton kernel against XLA.

Each measurement is a jitted ``lax.scan`` of ``--steps`` dependent trellis
steps (the carry feeds the next step, as in a decode), timed with the host
clock around ``jax.block_until_ready`` after a warm-up call; the printed
figure is the median over ``--reps`` runs divided by the step count.  Every
kernel result is compared bit for bit with the XLA step first.

    python scripts/step_bench.py                       # default sweep
    python scripts/step_bench.py --shapes 3968x16 --tiles 128,16,8,4,4,3
    python scripts/step_bench.py --decode              # end to end

``--decode`` times whole decodes at the headline configuration (K=3965
padded to 3968, T=256) with the Triton step on and off, and the parts of
the decode that always run in XLA (the pointer walks, the beam decoder).
``--trace DIR`` records a ``jax.profiler`` trace of three headline
``flash`` and ``fused`` decodes each and prints the device time per
operation name (the kernel is named ``maxplus_lanes``).

Prints one JSON line per (shape, implementation).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--shapes", default="3968x1,3968x4,3968x16,3968x64,"
                                        "16384x1,16384x8")
    ap.add_argument("--tiles", action="append", default=[],
                    help="cols,rows,lanes,splits,warps,stages "
                         "(repeatable); "
                         "default: the kernel's own choice")
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--decode", action="store_true",
                    help="time whole decodes instead of the step")
    ap.add_argument("--trace", help="trace headline decodes into this dir")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from flash_viterbi_tpu.ops.maxplus_triton import (StepTiles,
                                                      default_tiles,
                                                      maxplus_lanes_triton)
    from flash_viterbi_tpu.ops.maxplus import maxplus_lanes_xla
    from flash_viterbi_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU: {dev.platform}", file=sys.stderr)
        return 2
    print(f"# card: {_card()}  device_kind: {dev.device_kind}")
    if args.decode:
        return decode_rows(args.reps)
    if args.trace:
        return trace_rows(args.trace)

    variants = [None] + [StepTiles(*(int(x) for x in t.split(",")))
                         for t in args.tiles]
    rng = np.random.default_rng(0)
    for spec in args.shapes.split(","):
        K, N = (int(x) for x in spec.split("x"))
        logA = jnp.asarray(rng.standard_normal((K, K), np.float32))
        d0 = jnp.asarray(rng.standard_normal((N, K), np.float32))
        emits = jnp.asarray(rng.standard_normal((args.steps, N, K),
                                                np.float32) * 0.01)

        def scan_of(step):
            @jax.jit
            def run(logA, d0, emits):
                def body(d, e):
                    v, a = step(d, logA)
                    return v + e, a[:, :8]
                return jax.lax.scan(body, d0, emits)
            return run

        impls = {"xla": scan_of(maxplus_lanes_xla)}
        for t in variants:
            tt = t or default_tiles(N)
            name = (f"triton[{tt.cols},{tt.rows},{tt.lanes},{tt.splits},"
                    f"{tt.num_warps},{tt.num_stages}]")
            impls[name] = scan_of(
                lambda d, a, tt=tt: maxplus_lanes_triton(d, a, tiles=tt))

        ref_v, ref_a = jax.jit(maxplus_lanes_xla)(d0, logA)
        for name, fn in impls.items():
            row = {"K": K, "N": N, "impl": name, "card": _card()}
            try:
                if name != "xla":
                    t = variants[list(impls).index(name) - 1]
                    v, a = maxplus_lanes_triton(d0, logA, tiles=t)
                    row["bit_equal"] = bool(
                        (np.asarray(v) == np.asarray(ref_v)).all()
                        and (np.asarray(a) == np.asarray(ref_a)).all())
                t0 = time.perf_counter()
                jax.block_until_ready(fn(logA, d0, emits))
                row["first_call_s"] = time.perf_counter() - t0
                ts = []
                for _ in range(args.reps):
                    t0 = time.perf_counter()
                    jax.block_until_ready(fn(logA, d0, emits))
                    ts.append(time.perf_counter() - t0)
                row["us_per_step"] = float(np.median(ts)) / args.steps * 1e6
                row["us_per_step_min"] = min(ts) / args.steps * 1e6
                row["GB_per_s_one_stream"] = (K * K * 4 / 1e9) / (
                    row["us_per_step"] * 1e-6)
            except Exception as e:  # noqa: BLE001 — report and go on
                row["error"] = f"{type(e).__name__}: {str(e)[:400]}"
            print(json.dumps(row), flush=True)
    return 0


def decode_rows(reps: int) -> int:
    """Headline decodes with the Triton step on and off, and the XLA parts."""
    import jax
    import jax.numpy as jnp

    from flash_viterbi_tpu import make_sparse_hmm
    from flash_viterbi_tpu.algorithms import flash as F
    from flash_viterbi_tpu.algorithms.base import build
    from flash_viterbi_tpu.algorithms.fused import fused_decode_batch
    from flash_viterbi_tpu.ops import maxplus as mp
    from flash_viterbi_tpu.utils.profiling import wall_time

    hmm, y = make_sparse_hmm(K=3965, M=50, T=256, prob=0.112, seed=1)
    lh = hmm.log().padded(128)
    tables = tuple(jnp.asarray(x) for x in (lh.logA, lh.logB, lh.logPi))
    yd = jnp.asarray(y, jnp.int32)
    rng = np.random.default_rng(1)
    ys = jnp.asarray(rng.integers(0, 50, (64, 256), dtype=np.int32))
    card = _card()

    def row(name, fn, *a):
        ms = wall_time(jax.jit(fn), *a, reps=reps) * 1e3
        print(json.dumps({"cell": name, "ms": ms, "card": card}), flush=True)

    for up in (True, False):
        tag = "triton" if up else "xla"
        for alg, kw in [("flash", {"num_segments": 16}),
                        ("flash", {"num_segments": 16, "mode": "lean"}),
                        ("fused", {})]:
            dec = build(alg, use_pallas=up, **kw)
            name = f"{alg}{'/lean' if kw.get('mode') else ''}[{tag}]"
            row(name, dec, *tables, yd)
        row(f"decode_batch64/fused[{tag}]",
            lambda a, b, p, yy, up=up: fused_decode_batch(a, b, p, yy,
                                                          use_pallas=up),
            *tables, ys)
        mids = F.flash_midpoints(0, 255, 16)
        row(f"flash/phase1[{tag}]",
            lambda a, b, p, yy, up=up: F.phase1_anchors(a, p, b[:, yy].T,
                                                        mids, up),
            *tables, yd)
    for alg, kw in [("checkpoint", {}), ("vanilla", {}),
                    ("flash_bs", {"beam_width": 32, "num_segments": 16})]:
        row(alg, build(alg, **kw), *tables, yd)
    K = tables[0].shape[0]
    ptrs = jnp.asarray(rng.integers(0, K, (255, K), dtype=np.int32))
    row("backtrack/T=256", mp.backtrack, ptrs, jnp.int32(3))
    seg = jnp.asarray(rng.integers(0, K, (15, 16, K), dtype=np.int32))
    row("backtrack/16 segments x 16",
        jax.vmap(mp.backtrack, in_axes=(1, 0)), seg,
        jnp.zeros((16,), jnp.int32))
    return 0


def device_op_times(xplane_path: str) -> dict:
    """{op name: (total device ns, count)} over the GPU planes' stream
    lines of one trace, plus "_window_ns" (first start to last end) and
    "_busy_ns" (union of the op intervals)."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(xplane_path)
    out: dict = {}
    spans = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        lines = [ln for ln in plane.lines if "Stream" in ln.name]
        print(f"# {plane.name}: lines "
              f"{[ln.name for ln in plane.lines]}", flush=True)
        for line in lines or list(plane.lines):
            for ev in line.events:
                tot, n = out.get(ev.name, (0.0, 0))
                out[ev.name] = (tot + ev.duration_ns, n + 1)
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    spans.sort()
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    out["_window_ns"] = (spans[-1][1] - spans[0][0]) if spans else 0.0
    out["_busy_ns"] = busy
    return out


def trace_rows(trace_dir: str) -> int:
    """Trace 3 headline decodes per decoder; print device time per op."""
    import glob

    import jax
    import jax.numpy as jnp

    from flash_viterbi_tpu import build, make_sparse_hmm

    hmm, y = make_sparse_hmm(K=3965, M=50, T=256, prob=0.112, seed=1)
    lh = hmm.log().padded(128)
    args = tuple(jnp.asarray(x) for x in (lh.logA, lh.logB, lh.logPi)) + (
        jnp.asarray(y, jnp.int32),)
    card = _card()
    for alg, kw in [("flash", {"num_segments": 16}), ("fused", {})]:
        fn = jax.jit(build(alg, **kw))
        jax.block_until_ready(fn(*args))
        d = os.path.join(trace_dir, alg)
        jax.profiler.start_trace(d)
        for _ in range(3):
            jax.block_until_ready(fn(*args))
        jax.profiler.stop_trace()
        path = sorted(glob.glob(os.path.join(d, "plugins", "profile", "*",
                                             "*.xplane.pb")))[-1]
        ops = device_op_times(path)
        window, busy = ops.pop("_window_ns"), ops.pop("_busy_ns")
        top = sorted(ops.items(), key=lambda kv: -kv[1][0])[:15]
        print(json.dumps({
            "decoder": alg, "card": card, "runs": 3,
            "device_busy_ms_per_decode": busy / 3e6,
            "device_window_ms_per_decode": window / 3e6,
            "top_ops_ms_per_decode": {k: [v[0] / 3e6, v[1] // 3]
                                      for k, v in top}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

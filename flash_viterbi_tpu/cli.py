"""Command-line interface.

Subcommands mirror the reference's workflows:

* ``generate`` — seeded fixture generation, same files/filenames as
  ``generate_data/data_script.py`` / ``data_script_dag.py``.
* ``decode``   — one decode, printing the reference stdout protocol
  (``time:`` / ``path: [...]`` / ``memory:``,
  ``src/FLASH_Viterbi_multithread.c:117-124,378``).
* ``bench``    — parameter sweep to per-algorithm CSVs (run.py parity,
  ``src/run.py:80-107``; see ``bench.harness`` for the schema).

Examples::

    python -m flash_viterbi_tpu generate -K 512 -M 50 -T 256 -p 0.112 -o data/
    python -m flash_viterbi_tpu decode -a fused -K 512 -M 50 -T 256 -p 0.112
    python -m flash_viterbi_tpu bench -a fused,flash -K 1024,3965 -T 256 --csv-dir out/
"""

from __future__ import annotations

import argparse
import sys


def _add_problem_args(p: argparse.ArgumentParser, listy: bool = False):
    # bench accepts comma-separated sweeps for K/T/prob
    kt = str if listy else int
    pt = str if listy else float
    p.add_argument("-K", type=kt, default=256, help="number of hidden states")
    p.add_argument("-M", "--t-state", type=int, default=50, dest="M",
                   help="observation alphabet size (reference: T_STATE)")
    p.add_argument("-T", "--obser-len", type=kt, default=256, dest="T",
                   help="observation sequence length (reference: obserRouteLEN)")
    p.add_argument("-p", "--prob", type=pt, default=0.112,
                   help="edge probability of the sparse graph")
    p.add_argument("-s", "--seed", type=int, default=1)
    p.add_argument("--dag", action="store_true", help="DAG-structured HMM")


def cmd_generate(args) -> int:
    from .models.generate import make_dag_hmm, make_sparse_hmm
    from .utils.io import save_dataset

    if args.dag:
        hmm, y = make_dag_hmm(K=args.K, M=args.M, T=args.T, seed=args.seed,
                              sanitize=args.sanitize)
    else:
        hmm, y = make_sparse_hmm(K=args.K, M=args.M, T=args.T, prob=args.prob,
                                 seed=args.seed, sanitize=args.sanitize)
    paths = save_dataset(args.out, hmm, y, prob=args.prob, dag=args.dag)
    for name, path in paths.items():
        print(f"{name}: {path}")
    return 0


def cmd_decode(args) -> int:
    from . import decode
    from .models.generate import make_dag_hmm, make_sparse_hmm
    from .utils.io import load_dataset

    if args.data:
        hmm, y = load_dataset(args.data, args.K, args.T, args.M,
                              prob=args.prob, dag=args.dag)
    elif args.dag:
        hmm, y = make_dag_hmm(K=args.K, M=args.M, T=args.T, seed=args.seed,
                              sanitize=True)
    else:
        hmm, y = make_sparse_hmm(K=args.K, M=args.M, T=args.T, prob=args.prob,
                                 seed=args.seed)
    static = {}
    if args.algorithm in ("flash", "flash_bs"):
        static["num_segments"] = args.segments
    if args.algorithm == "flash_bs":
        static["beam_width"] = args.beam or min(64, args.K)
    r = decode(hmm, y, algorithm=args.algorithm, **static)
    sys.stdout.write(r.reference_stdout())
    return 0


def cmd_compare(args) -> int:
    """Baseline.py-equivalent harness: run every algorithm on one problem,
    write times/memory/paths to ``ANS_K{K}_T{T}_prob{p}_beam_width{b}.txt``
    (the reference's summary format, Baseline.py:67-68,91-105)."""
    import time as _time

    from . import decode
    from .models.generate import make_sparse_hmm
    from .oracle.sieve import sieve_mp
    from .oracle.sieve_bs import sieve_bs, sieve_bs_mp

    K, M, T, prob, seed = args.K, args.M, args.T, args.prob, args.seed
    beam = args.beam or min(64, K)
    hmm, y = make_sparse_hmm(K=K, M=M, T=T, prob=prob, seed=seed)

    out_path = f"ANS_K{K}_T{T}_prob{prob}_beam_width{beam}.txt"
    lines = []
    for alg, kw in [("vanilla", {}), ("checkpoint", {}), ("fused", {}),
                    ("flash", {"num_segments": args.segments}),
                    ("flash_bs", {"num_segments": args.segments,
                                  "beam_width": beam}),
                    ("sieve_mp", {}),
                    ("beam", {"beam_width": beam})]:
        r = decode(hmm, y, algorithm=alg, **kw)
        lines.append(f"{alg} Time: {r.time_s:.5f}s")
        lines.append(f"Mem: {r.memory_bytes}")
        lines.append(f"path: {list(map(int, r.path))}")
        print(f"{alg:12s} {r.time_s*1e3:9.2f} ms  mem={r.memory_bytes}")

    # oracle baselines (CPU reference semantics, like Baseline.py's originals).
    # The SIEVE-BS oracles keep the reference's build_adjacency, which
    # materializes the full M x K^2 acoustic cross-product as dicts — at
    # the headline K=3965 that is ~1e9 entries, infeasible exactly like
    # Baseline.py itself would be.  Guard rather than hang; device rows
    # above are still parity-checked via the fp32 mirrors (bench --parity).
    adj_entries = M * K * K
    if adj_entries > args.oracle_limit:
        msg = (f"# SIEVE oracles skipped: M*K^2 = {adj_entries:.2e} dict "
               f"entries exceeds --oracle-limit={args.oracle_limit:.0e} "
               "(reference Baseline.py is equally infeasible at this size)")
        lines.append(msg)
        print(msg)
    else:
        for name, fn in [("SIEVE-Mp(oracle)", lambda: sieve_mp(hmm.A, hmm.B, hmm.Pi, y)),
                         ("SIEVE-BS(oracle)", lambda: sieve_bs(hmm.A, hmm.B, hmm.Pi, y, beam)),
                         ("SIEVE-BS-Mp(oracle)", lambda: sieve_bs_mp(hmm.A, hmm.B, hmm.Pi, y, beam))]:
            t0 = _time.time()
            out = fn()
            dt = _time.time() - t0
            lines.append(f"{name} Time: {dt:.5f}s")
            lines.append(f"path: {out if isinstance(out, list) else list(map(int, out))}")
            print(f"{name:20s} {dt*1e3:9.2f} ms")

    with open(out_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {out_path}")
    return 0


def cmd_scaling(args) -> int:
    """Scaling report: the analytic model of the sharded decode at the
    target config (parallel.scaling), at a per-card update rate that is
    given (``--rate``) or measured on this device (``--measure``)."""
    import json

    from .parallel.scaling import analyze, measure_update_rate

    if args.measure:
        rate = measure_update_rate()
    elif args.rate:
        rate = args.rate
    else:
        print("scaling: give --rate or --measure", file=sys.stderr)
        return 2
    for spec in args.mesh.split(";"):
        shape = tuple(int(x) for x in spec.split(","))
        r = analyze(shape, K=args.K, T=args.T, batch=args.batch,
                    card_updates_per_s=rate, link_bytes_per_s=args.link)
        print(json.dumps(r.as_dict()))
    return 0


def cmd_bench(args) -> int:
    from .bench.harness import RunConfig, sweep

    algos = args.algorithm.split(",")
    Ks = [int(x) for x in str(args.K).split(",")]
    Ts = [int(x) for x in str(args.T).split(",")]
    probs = [float(x) for x in str(args.prob).split(",")]
    cfgs = [
        RunConfig(algorithm=a, K=K, M=args.M, T=T, prob=p, seed=args.seed,
                  num_segments=args.segments, beam_width=args.beam,
                  dag=args.dag, data_path=args.data,
                  check_parity=not args.no_parity)
        for a in algos for K in Ks for T in Ts for p in probs
    ]
    sweep(cfgs, csv_dir=args.csv_dir)
    return 0


def main(argv=None) -> int:
    from .utils.cache import enable_compile_cache

    enable_compile_cache()
    ap = argparse.ArgumentParser(prog="flash_viterbi_tpu", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("generate", help="write seeded fixtures (reference format)")
    _add_problem_args(g)
    g.add_argument("-o", "--out", default="data", help="output directory")
    g.add_argument("--sanitize", action="store_true",
                   help="zero out NaN rows the reference generator can produce")
    g.set_defaults(fn=cmd_generate)

    d = sub.add_parser("decode", help="decode one sequence, reference stdout protocol")
    _add_problem_args(d)
    d.add_argument("-a", "--algorithm", default="fused")
    d.add_argument("--data", help="fixture directory (instead of generating)")
    d.add_argument("--segments", type=int, default=8,
                   help="FLASH segment count (reference: MAX_THREADS)")
    d.add_argument("--beam", type=int, help="beam width (flash_bs)")
    d.set_defaults(fn=cmd_decode)

    c = sub.add_parser("compare",
                       help="run every algorithm on one problem (Baseline.py-style summary)")
    _add_problem_args(c)
    c.add_argument("--segments", type=int, default=8)
    c.add_argument("--beam", type=int)
    c.add_argument("--oracle-limit", type=float, default=5e7,
                   dest="oracle_limit",
                   help="skip the dict-based SIEVE oracles when M*K^2 "
                        "exceeds this (they materialize the full adjacency "
                        "cross-product, like the reference Baseline.py)")
    c.set_defaults(fn=cmd_compare)

    sc = sub.add_parser("scaling", help="scaling model of the sharded decode")
    sc.add_argument("-K", type=int, default=16384)
    sc.add_argument("-T", type=int, default=65536)
    sc.add_argument("--batch", type=int, default=256)
    sc.add_argument("--mesh", default="1,1,2;1,2,2;2,2,2;1,1,8",
                    help="semicolon-separated data,seq,state shapes")
    sc.add_argument("--rate", type=float,
                    help="trellis updates per second of one card")
    sc.add_argument("--link", type=float, required=True,
                    help="card-to-card bandwidth, bytes per second each way")
    sc.add_argument("--measure", action="store_true",
                    help="measure the update rate on this device")
    sc.set_defaults(fn=cmd_scaling)

    b = sub.add_parser("bench", help="sweep configs to per-algorithm CSVs")
    _add_problem_args(b, listy=True)
    b.add_argument("-a", "--algorithm", default="fused",
                   help="comma-separated algorithm list")
    b.add_argument("--segments", type=int, default=8)
    b.add_argument("--beam", type=int)
    b.add_argument("--data", help="fixture directory")
    b.add_argument("--csv-dir", help="append per-algorithm CSVs here")
    b.add_argument("--no-parity", action="store_true")
    b.set_defaults(fn=cmd_bench)

    # K/T/prob accept comma lists for bench
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())

"""Benchmark harness — capability parity with the reference's ``src/run.py``.

The reference configures by regex-patching ``#define``s into the C source,
recompiling, running, and scraping stdout into per-algorithm CSVs
(``src/run.py:26-107``).  Here a sweep is a list of :class:`RunConfig`;
each run generates (or loads) the seeded fixture, decodes on-device, and
appends a CSV row with the reference schema

    [timestamp, K_STATE, T_STATE, obserRouteLEN, prob, MAX_THREADS,
     BeamSearchWidth, time, memory]                     (src/run.py:105)

extended with [algorithm, device, updates_per_s, parity] columns.

Timing: the median wall time of the jitted decode to completion
(``utils.profiling.wall_time``), after a warm-up call that compiles it.
"""

from __future__ import annotations

import csv
import dataclasses
import os
from datetime import datetime
from typing import Sequence

import numpy as np

CSV_FIELDS = [
    "timestamp", "K_STATE", "T_STATE", "obserRouteLEN", "prob",
    "MAX_THREADS", "BeamSearchWidth", "time", "memory",
    "algorithm", "device", "updates_per_s", "parity",
]


@dataclasses.dataclass
class RunConfig:
    algorithm: str = "fused"
    K: int = 256
    M: int = 50  # T_STATE in reference vocabulary (observation alphabet)
    T: int = 256  # obserRouteLEN
    prob: float = 0.112
    seed: int = 1
    num_segments: int = 8  # plays MAX_THREADS' role (src/run.py:34-35)
    beam_width: int | None = None
    dag: bool = False
    data_path: str | None = None  # load fixture instead of generating
    check_parity: bool = True
    extra: dict = dataclasses.field(default_factory=dict)


# Above these state counts the numpy/dict mirrors are too slow for a bench
# loop; rows then fall back to a kernel-vs-XLA self-check (labelled so the
# CSV never has an empty parity cell).
_MIRROR_MAX_K = {"sieve_mp": 1024, "sieve_bs": 512, "sieve_bs_mp": 512,
                 "sieve": 512, "sieve_dag": 256}
# Trellis-cell bound for the exact-path numpy oracle (vanilla family):
# ~4e9 cells (headline K=3965/T=256) takes seconds; K=16384/T=256 (6.9e10)
# takes minutes — those rows use the cross-pipeline self-witness instead.
_ORACLE_MAX_CELLS = 2e10


def _parity(cfg, hmm, y, path, dec, tables):
    """Check the decoded path against the algorithm's mirror.

    Returns True/False for a mirror comparison, or "self:True"/"self:False"
    for the large-K fallback: the same decoder with the Triton step off.
    """
    import jax

    from ..oracle import framework as fw
    from ..oracle import native as oracle

    alg = cfg.algorithm
    bw = cfg.beam_width or 64
    if alg == "auto" and cfg.beam_width is not None:
        alg = "flash_bs"  # auto routes beamed problems to the beam family
    if (alg in ("vanilla", "checkpoint", "flash", "fused", "auto")
            and cfg.K * cfg.K * cfg.T > _ORACLE_MAX_CELLS):
        # the numpy mirror is infeasible (minutes of host time) — fall
        # through to the generic cross-pipeline witness below (same
        # algorithm, Triton step vs pure XLA, labelled "self:") so no
        # measured row ever ships with an empty parity cell
        pass
    elif alg in ("vanilla", "checkpoint", "flash", "fused", "auto"):
        want = oracle.vanilla(hmm.A, hmm.B, hmm.Pi, y)
        if bool((path == want).all()):
            return True
        # flash-family rows may legitimately tie-flip vs vanilla
        # (docs/DESIGN.md §1) — arbitrate against the f32 FLASH mirror.
        # Re-derive auto's routing the way the decoder actually routed:
        # padded state count, with the decoder's own static overrides
        # (incl. memory_budget_bytes) — see the matching derivation in
        # run_one's memory accounting.
        routed = alg
        if alg == "auto":
            from ..algorithms.auto import choose
            Kp = tables[0].shape[0]
            st = {k: v for k, v in dec.static.items()
                  if k not in ("memory_budget_bytes", "beam_width")}
            routed, _ = choose(Kp, cfg.T,
                               memory_budget_bytes=dec.static.get(
                                   "memory_budget_bytes"),
                               beam_width=cfg.beam_width, static=st)
        if routed != "flash":
            return False
        from ..oracle.validate import arbitrate_flash_tie_flip
        ok = arbitrate_flash_tie_flip(hmm.A, hmm.B, hmm.Pi, y, path,
                                      cfg.num_segments)
        if ok is None:  # mirror too costly / unfaithful at this shape
            return "tie-flip-unarbitrated"
        if ok is False:
            return False
        return ok  # "mirror-exact" / "tie-equivalent" (both legitimate)
    if alg == "flash_bs":
        want = fw.flash_bs(hmm.A, hmm.B, hmm.Pi, y, beam_width=bw,
                           num_segments=cfg.num_segments)
        return bool((path == np.asarray(want)[: cfg.T]).all())
    if alg == "beam":
        want = fw.beam(hmm.A, hmm.B, hmm.Pi, y, beam_width=bw)
        return bool((path == np.asarray(want)[: cfg.T]).all())
    if alg in _MIRROR_MAX_K and cfg.K <= _MIRROR_MAX_K[alg]:
        if alg == "sieve_mp":
            from ..oracle.sieve import sieve_mp
            want = sieve_mp(hmm.A, hmm.B, hmm.Pi, y, numerics="f32")
            return bool((path == np.asarray(want)[: cfg.T]).all())
        if alg in ("sieve", "sieve_dag"):
            from ..oracle.sieve import sieve_dag, sieve_dynamic
            if alg == "sieve":
                b = max(1, int(np.floor(np.log2(max(2, cfg.K)))))
                pairs = sieve_dynamic(hmm.A, hmm.B, hmm.Pi, y, b_hops=b)
            else:
                pairs = sieve_dag(hmm.A, hmm.B, hmm.Pi, y)
        elif alg == "sieve_bs_mp":
            # fp32 framework mirror: bit-exact with the decoder even on
            # permuted-path ties where the f64 oracle legitimately differs
            want = fw.sieve_bs_mp(hmm.A, hmm.B, hmm.Pi, y, beam_width=bw)
            return bool((path == np.asarray(want)[: cfg.T]).all())
        else:  # sieve_bs: same fp32-mirror yardstick
            pairs = fw.sieve_bs(hmm.A, hmm.B, hmm.Pi, y, beam_width=bw)
        if not pairs:
            return bool((path == -1).all())
        flat = np.asarray([pairs[0][0], pairs[0][1]] + [p[1] for p in pairs[1:]])
        n = min(len(flat), cfg.T)
        return bool((path[:n] == flat[:n]).all())
    if not dec.jittable:
        # host-driven decoders have no alternate compute path to diff
        # against at large K; check the mirror-free invariants (valid
        # edges + finite quirk-scored f64) so no row ever says "unchecked"
        # — the one-time bit witness vs the compiled reference C at the
        # headline config lives in scripts/sieve_bs_witness.py
        from ..oracle.validate import beam_path_invariants
        return beam_path_invariants(hmm.A, hmm.B, hmm.Pi, y, path)
    # large-K fallback: the same algorithm on the pure-XLA path must agree
    from .. import build
    if "use_pallas" not in dec.static:
        # no kernel path: the "alternate" build would be the identical
        # computation and the comparison vacuously True — label the row
        # honestly instead of overstating the check
        return "self:identical-path"
    alt = build(alg, use_pallas=False,
                **{k: v for k, v in dec.static.items() if k != "use_pallas"})
    runner = jax.jit(alt) if alt.jittable else alt
    alt_path = np.asarray(runner(*tables))[: cfg.T]
    return f"self:{bool((path == alt_path).all())}"


def run_one(cfg: RunConfig) -> dict:
    """Measure one configuration and check its path."""
    import jax
    import jax.numpy as jnp

    from .. import build
    from ..models.generate import make_dag_hmm, make_sparse_hmm
    from ..utils.io import load_dataset
    from ..utils.profiling import wall_time

    if cfg.data_path:
        hmm, y = load_dataset(cfg.data_path, cfg.K, cfg.T, cfg.M,
                              prob=cfg.prob, dag=cfg.dag)
    elif cfg.dag:
        hmm, y = make_dag_hmm(K=cfg.K, M=cfg.M, T=cfg.T, seed=cfg.seed,
                              sanitize=True)
    else:
        hmm, y = make_sparse_hmm(K=cfg.K, M=cfg.M, T=cfg.T, prob=cfg.prob,
                                 seed=cfg.seed)

    static = dict(cfg.extra)
    if cfg.algorithm in ("flash", "flash_bs", "auto"):
        # for "auto" this flows through as a static override, so a routed
        # flash/flash_bs runs with the same segment count its parity
        # mirror below is checked with
        static.setdefault("num_segments", cfg.num_segments)
    if cfg.beam_width is not None:
        static.setdefault("beam_width", cfg.beam_width)
    dec = build(cfg.algorithm, **static)

    lh = hmm.log().padded(128)
    logA = jnp.asarray(lh.logA)
    logB = jnp.asarray(lh.logB)
    logPi0 = jnp.asarray(lh.logPi)
    yd = jnp.asarray(y, jnp.int32)

    tables = (logA, logB, logPi0, yd)
    runner = jax.jit(dec) if dec.jittable else dec
    wall = wall_time(runner, *tables)
    path = np.asarray(runner(*tables))[: cfg.T]

    if cfg.check_parity:
        parity = _parity(cfg, hmm, y, path, dec, tables)
    else:
        # never an empty cell: a row without a witness must say so
        parity = "skipped"

    return {
        "timestamp": datetime.now().strftime("%Y%m%d_%H%M%S"),
        "K_STATE": cfg.K,
        "T_STATE": cfg.M,
        "obserRouteLEN": cfg.T,
        "prob": cfg.prob,
        "MAX_THREADS": cfg.num_segments,
        "BeamSearchWidth": cfg.beam_width or "",
        "time": wall,
        # logical K, not the padded lh.Kp: the figure must match the C
        # binaries' reference-exact accounting (e.g. K=3965, not 4096);
        # K_padded lets shape-adaptive decoders (auto) re-derive the
        # configuration that actually ran (selection sees the padded K)
        "memory": dec.analytic_memory(K=cfg.K, T=cfg.T, K_padded=lh.Kp),
        "algorithm": cfg.algorithm,
        "device": str(jax.devices()[0]),
        "updates_per_s": cfg.K * cfg.K * cfg.T / wall,
        "parity": parity,
    }


def append_csv(row: dict, csv_dir: str, algorithm: str) -> str:
    """Per-algorithm CSV accumulation, like run.py's run_result (:80-107)."""
    os.makedirs(csv_dir, exist_ok=True)
    path = os.path.join(csv_dir, f"{algorithm}.csv")
    fresh = not os.path.exists(path)
    with open(path, "a", newline="") as f:
        w = csv.DictWriter(f, fieldnames=CSV_FIELDS)
        if fresh:
            w.writeheader()
        w.writerow(row)
    return path


def sweep(configs: Sequence[RunConfig], csv_dir: str | None = None,
          verbose: bool = True) -> list[dict]:
    rows = []
    for cfg in configs:
        row = run_one(cfg)
        rows.append(row)
        if csv_dir:
            append_csv(row, csv_dir, cfg.algorithm)
        if verbose:
            print(f"{cfg.algorithm:10s} K={cfg.K:<6d} T={cfg.T:<6d} "
                  f"time={row['time']*1e3:9.2f} ms  "
                  f"{row['updates_per_s']/1e9:8.2f} G upd/s  parity={row['parity']}")
    return rows

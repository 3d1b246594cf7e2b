"""Observability: phase timers, device traces, memory reports.

The reference's only instrumentation is one wall-clock bracket around
``calc()`` plus the analytic ``memory:`` figure every algorithm computes
for itself (SURVEY.md §5).  Here:

* :func:`wall_time` — host wall time around ``jax.block_until_ready``,
  after a warm-up call (compilation is never inside the timed window).
* :class:`PhaseTimer` — named phase brackets (phase-1 pass, segment
  rounds, backtrack...) with a structured dict/JSON export; the derived
  ``trellis updates/s`` north-star metric included.
* :func:`device_trace` — ``jax.profiler`` trace context for perfetto/
  tensorboard inspection.
* :func:`memory_report` — analytic working set (static block shapes) next
  to the live device allocation stats, the device-side analog of the
  reference's per-algorithm accounting (``src/FLASH_Viterbi_multithread.c:341-367``).
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass, field

import numpy as np


def wall_time(fn, *args, reps: int = 3) -> float:
    """Median seconds of ``fn(*args)`` to completion, after one warm-up
    call; each run ends in ``jax.block_until_ready``."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


@dataclass
class PhaseTimer:
    """Named wall-clock phases with structured export."""

    phases: dict = field(default_factory=dict)
    _order: list = field(default_factory=list)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.phases[name] = self.phases.get(name, 0.0) + dt
            if name not in self._order:
                self._order.append(name)

    def report(self, K: int | None = None, T: int | None = None) -> dict:
        total = sum(self.phases.values())
        out = {"total_s": total,
               "phases": {n: self.phases[n] for n in self._order}}
        if K and T and total > 0:
            out["trellis_updates_per_s"] = K * K * T / total
        return out

    def json(self, **kw) -> str:
        return json.dumps(self.report(**kw))


def profile_flash(hmm, y, num_segments: int = 8, pad_to: int = 128,
                  reps: int = 3) -> dict:
    """Per-phase wall times for a FLASH decode (SURVEY.md §5: phase-1
    pass, segment decode and backtrack), each a jitted program timed by
    :func:`wall_time`.

    Phase 1 is re-run as a standalone program; the full decode overlaps
    the phases, so phase 2 is reported as the difference.
    """
    import jax
    import jax.numpy as jnp

    from ..algorithms import flash as F
    from ..models.hmm import LogHMM

    lh = hmm if isinstance(hmm, LogHMM) else hmm.log()
    K_logical = lh.K
    lh = lh.padded(pad_to)
    T = int(len(y))
    args = (jnp.asarray(lh.logA), jnp.asarray(lh.logB), jnp.asarray(lh.logPi),
            jnp.asarray(np.asarray(y), jnp.int32))
    N = max(1, min(int(num_segments), T // 2))
    mids = F.flash_midpoints(0, T - 1, N) if N > 1 else []

    @jax.jit
    def phase1(logA, logB, logPi, yd):
        return F.phase1_anchors(logA, logPi, logB[:, yd].T, mids)

    @jax.jit
    def full(logA, logB, logPi, yd):
        return F.flash_decode(logA, logB, logPi, yd, num_segments=num_segments)

    t_phase1 = wall_time(phase1, *args, reps=reps)
    t_full = wall_time(full, *args, reps=reps)
    return {
        "phase1_s": t_phase1,
        "phase2_and_backtrack_s": max(t_full - t_phase1, 0.0),
        "total_s": t_full,
        "trellis_updates_per_s": K_logical * K_logical * T / t_full
        if t_full > 0 else float("inf"),
        "num_segments": num_segments,
    }


@contextlib.contextmanager
def device_trace(log_dir: str):
    """jax.profiler trace bracket (view in tensorboard/perfetto)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def memory_report(decoder=None, K: int | None = None, T: int | None = None) -> dict:
    """Analytic + live device memory figures."""
    import jax

    out: dict = {}
    if decoder is not None and K and T:
        out["analytic_bytes"] = decoder.analytic_memory(K=K, T=T)
    try:
        stats = jax.local_devices()[0].memory_stats()
        if stats:
            out["device_bytes_in_use"] = stats.get("bytes_in_use")
            out["device_peak_bytes_in_use"] = stats.get("peak_bytes_in_use")
            out["device_bytes_limit"] = stats.get("bytes_limit")
    except Exception:
        pass
    out["live_array_bytes"] = int(sum(
        int(np.prod(a.shape)) * a.dtype.itemsize for a in jax.live_arrays()))
    return out

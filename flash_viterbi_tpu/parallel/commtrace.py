"""Jaxpr-level collective tracer: validate the scaling model against the
program that actually runs.

The analytic model's pipeline-bubble and gather-bytes terms
(``parallel.scaling.analyze``) are checked against a virtual-mesh trace
here.  This module walks the closed jaxpr of the sharded
decode (recursing through scan/cond/pjit/shard_map, multiplying by static
scan trip counts) and accumulates, per collective kind, the total bytes a
single device RECEIVES:

* ``all_gather`` over axis of size n: operand_bytes * (n - 1)  (each
  device already holds its own shard);
* ``ppermute``: operand_bytes (one buffer in per hop);
* ``psum`` (all_reduce): operand_bytes * ceil(log2 n) — the halving-
  doubling convention ``scaling.analyze`` models for the path psum.

Inside ``shard_map`` the avals are per-shard block shapes, so operand
sizes are already per-device.  Scan trip counts are static in this
program (the pipeline's tick count IS the bubble term), so the trace
also returns per-collective *issue counts* — ``tests/test_scaling.py``
pins both against ``analyze``'s formulas.
"""

from __future__ import annotations

import math
from collections import defaultdict

import jax
from jax.extend import core as jcore


def _axis_size(mesh, axis_names) -> int:
    if isinstance(axis_names, (tuple, list)):
        n = 1
        for a in axis_names:
            n *= dict(zip(mesh.axis_names, mesh.devices.shape))[a]
        return n
    return dict(zip(mesh.axis_names, mesh.devices.shape))[axis_names]


def _subjaxprs(eqn):
    """(jaxpr, trip_multiplier) children of one equation."""
    out = []
    prim = eqn.primitive.name
    for k, v in eqn.params.items():
        vals = v if isinstance(v, (tuple, list)) else [v]
        for item in vals:
            j = None
            if isinstance(item, jcore.ClosedJaxpr):
                j = item.jaxpr
            elif isinstance(item, jcore.Jaxpr):
                j = item
            if j is not None:
                mult = eqn.params.get("length", 1) if prim == "scan" else 1
                out.append((j, mult))
    return out


def trace_collectives(fn, *args, mesh) -> dict:
    """Total per-device received bytes + issue counts per collective.

    Returns {kind: {"bytes": float, "count": int}} where count is the
    number of executions (scan trips multiplied through).
    """
    closed = jax.make_jaxpr(fn)(*args)
    stats: dict = defaultdict(lambda: {"bytes": 0.0, "count": 0})

    def op_bytes(eqn):
        return sum(v.aval.size * v.aval.dtype.itemsize for v in eqn.invars
                   if hasattr(v, "aval") and hasattr(v.aval, "size"))

    def walk(jaxpr, mult):
        for eqn in jaxpr.eqns:
            prim = eqn.primitive.name
            if prim == "all_gather":
                n = _axis_size(mesh, eqn.params["axis_name"])
                b = op_bytes(eqn) * (n - 1)
                stats["all_gather"]["bytes"] += mult * b
                stats["all_gather"]["count"] += mult
            elif prim == "ppermute":
                stats["ppermute"]["bytes"] += mult * op_bytes(eqn)
                stats["ppermute"]["count"] += mult
            elif prim == "psum" or prim == "psum_invariant":
                names = eqn.params.get("axes", eqn.params.get("axis_name"))
                n = _axis_size(mesh, tuple(names) if not isinstance(
                    names, str) else names)
                if n > 1:
                    b = op_bytes(eqn) * math.ceil(math.log2(n))
                    stats["psum"]["bytes"] += mult * b
                    stats["psum"]["count"] += mult
            for sub, m in _subjaxprs(eqn):
                walk(sub, mult * m)

    walk(closed.jaxpr, 1)
    return {k: dict(v) for k, v in stats.items()}


def trace_sharded_decode(mesh, K: int, T: int, batch: int,
                         num_segments: int, microbatch: int = 1,
                         M: int = 8, seed: int = 7) -> dict:
    """Trace one pipelined sharded decode's collectives on a (virtual)
    mesh; returns the per-device stats dict."""
    import jax.numpy as jnp
    import numpy as np

    from ..models.generate import make_sparse_hmm
    from .sharded import flash_decode_sharded

    hmm, y = make_sparse_hmm(K=K, M=M, T=T, prob=0.3, seed=seed)
    lh = hmm.log()
    logA = jnp.asarray(lh.logA)
    logB = jnp.asarray(lh.logB)
    logPi = jnp.asarray(lh.logPi)
    ys = jnp.stack([jnp.asarray(np.asarray(y), jnp.int32)] * batch)

    def run(logA, logB, logPi, ys):
        return flash_decode_sharded(mesh, logA, logB, logPi, ys,
                                    num_segments=num_segments,
                                    microbatch=microbatch, pipeline=True)

    return trace_collectives(run, logA, logB, logPi, ys, mesh=mesh)

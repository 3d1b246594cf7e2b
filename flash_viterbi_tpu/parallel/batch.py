"""Batched decoding: many sequences at once (dp axis).

The reference decodes one sequence per process (SURVEY.md §2.6 row 3 —
batch parallelism absent).  On a device this is the cheapest axis: the
sequences become the lanes of one step (``fused``) or a ``vmap`` on one
card, or the ``(data, seq, state)`` mesh path (``parallel.sharded``)
across cards.
"""

from __future__ import annotations

from typing import Any

import numpy as np

import jax
import jax.numpy as jnp

from ..algorithms.base import DecodeResult, build
from ..models.hmm import HMM, LogHMM


def decode_batch(
    hmm: HMM | LogHMM,
    ys: np.ndarray,
    algorithm: str = "fused",
    pad_to: int = 128,
    mesh=None,
    num_segments: int | None = None,
    warmup: bool = True,
    **static: Any,
) -> DecodeResult:
    """Decode a batch of observation sequences.

    Args:
      ys: (BATCH, T) int observations.
      mesh: optional ``parallel.sharded.make_mesh`` mesh — routes to the
        multi-card FLASH path (dp + sp + tp); otherwise one device.

    Returns a DecodeResult whose ``path`` is (BATCH, T).
    """
    import time

    lh = hmm if isinstance(hmm, LogHMM) else hmm.log()
    K = lh.K
    lh = lh.padded(pad_to)
    ys = np.asarray(ys, dtype=np.int32)
    Bs, T = ys.shape

    logA = jnp.asarray(lh.logA)
    logB = jnp.asarray(lh.logB)
    logPi = jnp.asarray(lh.logPi)
    yd = jnp.asarray(ys)

    if mesh is not None:
        from .sharded import flash_decode_sharded

        def run():
            return flash_decode_sharded(mesh, logA, logB, logPi, yd,
                                        num_segments=num_segments)

        mem_algorithm = "flash"
        dec = build("flash", num_segments=num_segments or 8, **static)
    elif algorithm == "fused":
        # one lane per sequence: the Triton step streams logA once per
        # step for the whole batch
        from ..algorithms.fused import fused_decode_batch

        dec = build("fused", **static)
        fn = jax.jit(lambda a, b, p, yy: fused_decode_batch(a, b, p, yy,
                                                            **dec.static))

        def run():
            return fn(logA, logB, logPi, yd)

        mem_algorithm = "fused"
    else:
        if num_segments is not None:
            static.setdefault("num_segments", num_segments)
        dec = build(algorithm, **static)
        if dec.jittable:
            fn = jax.jit(jax.vmap(dec, in_axes=(None, None, None, 0)))

            def run():
                return fn(logA, logB, logPi, yd)
        elif dec.batch_fn is not None:
            # host-driven decoders with a native batch path: one shared
            # lane scheduler across the whole batch (nodes from every
            # sequence's recursion tree fill the vmapped dispatch lanes)
            def run():
                return dec.batch_fn(logA, logB, logPi, yd)
        else:
            # host-driven decoders read split points back per node; vmap
            # can't trace them — loop sequences eagerly
            def run():
                return jnp.stack([dec(logA, logB, logPi, yd[b])
                                  for b in range(Bs)])

        mem_algorithm = algorithm

    if warmup:
        jax.block_until_ready(run())
    t0 = time.perf_counter()
    out = np.asarray(jax.block_until_ready(run()))[:, :T]
    t1 = time.perf_counter()
    return DecodeResult(
        path=out,
        time_s=t1 - t0,
        memory_bytes=Bs * dec.analytic_memory(K=K, T=T),  # logical K (reference-exact)
        algorithm=f"batched:{mem_algorithm}",
        extra={"batch": Bs, "K": K, "K_padded": lh.Kp, "T": T,
               "mesh": None if mesh is None else dict(zip(mesh.axis_names,
                                                          mesh.devices.shape))},
    )

"""Algorithm registry, decode entry point, timing/memory reporting.

Replaces the reference's L4 runner layer (``main()`` + stdout protocol,
``src/FLASH_Viterbi_multithread.c:370-382``) with a functional API:
``decode()`` builds/jits the requested decoder, times the on-device decode
(excluding host data load, like the reference's ``clock_gettime`` bracket
around ``calc()``), and reports the reference-compatible analytic memory
figure next to measured device memory.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np

from ..models.hmm import HMM, LogHMM

_REGISTRY: dict[str, Callable[..., "Decoder"]] = {}


def register(name: str):
    def deco(factory):
        _REGISTRY[name] = factory
        return factory

    return deco


def available_algorithms() -> list[str]:
    return sorted(_REGISTRY)


@dataclasses.dataclass
class DecodeResult:
    path: np.ndarray  # (T,) int32 hidden state path
    time_s: float  # decode wall time, excluding data load & compile
    memory_bytes: int  # analytic peak working set (reference-style accounting)
    algorithm: str
    extra: dict = dataclasses.field(default_factory=dict)

    def reference_stdout(self) -> str:
        """The reference output protocol (``FLASH_Viterbi_multithread.c:117-124,378``)."""
        body = " ".join(str(int(s)) for s in self.path)
        return f"time: {self.time_s:.6f} \npath: [{body} ]\nmemory: {self.memory_bytes}\n"


class Decoder:
    """A configured, jit-compiled decoder for fixed static shapes.

    ``jittable=False`` marks decoders whose control flow is data-dependent
    on the host (e.g. SIEVE-BS's dynamic-median recursion reads split
    points back); ``decode()`` then calls them eagerly — their inner
    forward passes are still jitted per segment length.
    """

    def __init__(self, name: str, fn: Callable, static: dict, memory_fn: Callable,
                 jittable: bool = True, batch_fn: Callable | None = None):
        self.name = name
        self._fn = fn
        self.static = static
        self._memory_fn = memory_fn
        self.jittable = jittable
        # optional native batch decode (logA, logB, logPi, ys) -> (Bs, T):
        # host-driven decoders set this to share one lane scheduler across
        # the whole batch instead of decoding sequences one at a time
        self.batch_fn = batch_fn

    def __call__(self, logA, logB, logPi, y) -> jax.Array:
        return self._fn(logA, logB, logPi, y)

    def analytic_memory(self, K: int, T: int, K_padded: int | None = None) -> int:
        """Reference-style analytic working set at logical shape (K, T).

        ``K_padded`` (the device arrays' true state count) lets
        shape-adaptive decoders (``auto``) re-derive the configuration
        that actually ran — selection happens at the padded K — while
        still reporting the figure at the logical K.  Plain decoders
        ignore it.
        """
        kw = {} if K_padded is None else {"K_padded": int(K_padded)}
        return int(self._memory_fn(K=K, T=T, **kw, **self.static))


def build(algorithm: str, **static) -> Decoder:
    if algorithm not in _REGISTRY:
        raise KeyError(f"unknown algorithm {algorithm!r}; have {available_algorithms()}")
    return _REGISTRY[algorithm](**static)


def decode(
    hmm: HMM | LogHMM,
    y: np.ndarray,
    algorithm: str = "flash",
    pad_to: int = 128,
    warmup: bool = True,
    device=None,
    retries: int = 0,
    **static: Any,
) -> DecodeResult:
    """End-to-end decode of one observation sequence.

    Precomputes log tables (the reference recomputes ``log()`` per trellis
    access — ``src/FLASH_Viterbi_multithread.c:170``; we pay it once),
    pads K to a lane multiple, jits, and times the decode.

    ``retries > 0`` re-dispatches on transient device failures (decodes
    are pure/idempotent — ``utils.failsafe``); default fail-fast.
    """
    lh = hmm if isinstance(hmm, LogHMM) else hmm.log()
    K = lh.K
    lh = lh.padded(pad_to)
    T = int(len(y))

    dec = build(algorithm, **static)
    put = lambda x: jax.device_put(x, device) if device is not None else jnp.asarray(x)
    logA, logB, logPi = put(lh.logA), put(lh.logB), put(lh.logPi)
    yd = put(np.asarray(y, dtype=np.int32))

    fn = jax.jit(dec) if dec.jittable else dec

    def issue():
        return jax.block_until_ready(fn(logA, logB, logPi, yd))

    if retries > 0:
        from ..utils.failsafe import with_redispatch

        run = lambda: with_redispatch(issue, retries=retries)
    else:
        run = issue
    if warmup:
        run()
    t0 = time.perf_counter()
    path = run()
    t1 = time.perf_counter()
    return DecodeResult(
        path=np.asarray(path)[:T],
        time_s=t1 - t0,
        memory_bytes=dec.analytic_memory(K=K, T=T, K_padded=lh.Kp),
        algorithm=algorithm,
        extra={"K": K, "K_padded": lh.Kp, "T": T, **dec.static},
    )

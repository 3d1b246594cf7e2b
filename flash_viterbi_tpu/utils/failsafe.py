"""Failure detection / re-dispatch (SURVEY.md §5 aux subsystem).

The reference has no recovery at all (``perror`` without exit on fopen/
malloc failure, ``FLASH_Viterbi_multithread.c:67-99``).  The device
analog of its "blocks are idempotent" property: every decode in this
framework is a pure function of host-resident inputs, so a failed dispatch
(preempted device, transient XLA UNAVAILABLE) can simply be re-issued —
there is no partial state to repair.  :func:`with_redispatch` is that
policy; ``decode(..., retries=n)`` applies it to the public entry point.

Deliberately minimal: fail-fast remains the default (retries=0), matching
the reference's behavior; re-dispatch is opt-in for long unattended
sweeps where a transient backend hiccup shouldn't kill hours of work.
"""

from __future__ import annotations

import time
from typing import Callable, TypeVar

T = TypeVar("T")

# Transient-looking failure types: XLA runtime errors (device unavailable,
# preemption surface as RuntimeError/JaxRuntimeError).
def _transient_types():
    import jax

    errs: tuple = (RuntimeError,)
    je = getattr(jax, "errors", None)
    if je is not None and hasattr(je, "JaxRuntimeError"):
        errs = (RuntimeError, je.JaxRuntimeError)
    return errs


def with_redispatch(fn: Callable[[], T], retries: int = 1,
                    backoff_s: float = 1.0, on: tuple | None = None) -> T:
    """Run ``fn`` and re-dispatch on transient device failures.

    Args:
      fn: zero-arg callable issuing the (idempotent) device work.
      retries: additional attempts after the first failure.
      backoff_s: sleep between attempts (doubles each retry).
      on: exception types counted as transient (default: XLA runtime errs).

    Raises the last exception when attempts are exhausted.
    """
    errs = _transient_types() if on is None else on
    delay = backoff_s
    for attempt in range(retries + 1):
        try:
            return fn()
        except errs:
            if attempt == retries:
                raise
            time.sleep(delay)
            delay *= 2
    raise AssertionError("unreachable")

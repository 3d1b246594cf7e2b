"""Dense HMM model container, log-domain precomputation, and padding.

The reference (``/root/reference/src/FLASH_Viterbi_multithread.c:25-34``) keeps
raw probabilities ``A (K,K)``, ``B (K,M)``, ``Pi (K,)`` in a C struct and calls
``log()`` lazily per trellis access (``:170``) — 2*K^2 libm calls per step.

Redesign: precompute ``log A``, ``log B``, ``log Pi`` exactly once
(float64 ``log`` truncated to float32 — the same value the C code's
per-access ``log()`` produces after its assignment-truncation), keep them
resident in device memory, and pad the state dimension to a multiple of
128 so every step sees static, aligned shapes.

Padding contract: padded states are "dead" — their ``log Pi``/incoming
``log A`` columns and outgoing rows are ``-inf`` so they can never win an
argmax, and their emission rows are ``-inf``.  ``jnp.argmax`` picks the lowest
index on ties, matching the reference's strict-``>`` scan (SURVEY.md §3.6).
"""

from __future__ import annotations

import dataclasses
import numpy as np

NEG = np.float32(-3.4028235e38)  # -FLT_MAX, the reference's ElementTypeNegMin


def _log32(p: np.ndarray) -> np.ndarray:
    """float64 log truncated to float32; log(0) -> -inf, matching C log().

    NaN probabilities map to -inf (absent edge).  The reference generator
    emits 0/0 = NaN rows for zero-out-degree states (data_script.py:30-32,
    SURVEY.md §2.4) and the reference C's strict-'>' comparisons silently
    skip NaN candidates (``ktmp > tmax`` is false) — identical to a -inf
    edge.  jnp.max would instead PROPAGATE NaN and corrupt every later
    delta, so the skip semantics must be encoded in the table (verified
    bit-equal to the C-comparison mirror ``oracle.reference`` on NaN
    fixtures in tests/test_fuzz.py)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.log(np.asarray(p, dtype=np.float64)).astype(np.float32)
    out[np.isnan(out)] = np.float32("-inf")
    return out


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class HMM:
    """Dense HMM in probability space (host side, numpy)."""

    A: np.ndarray  # (K, K) transition probabilities, rows sum to 1
    B: np.ndarray  # (K, M) emission probabilities, rows sum to 1
    Pi: np.ndarray  # (K,) initial probabilities

    @property
    def K(self) -> int:
        return int(self.A.shape[0])

    @property
    def M(self) -> int:
        return int(self.B.shape[1])

    def __post_init__(self):
        assert self.A.ndim == 2 and self.A.shape[0] == self.A.shape[1]
        assert self.B.ndim == 2 and self.B.shape[0] == self.A.shape[0]
        assert self.Pi.ndim == 1 and self.Pi.shape[0] == self.A.shape[0]

    def log(self) -> "LogHMM":
        return LogHMM(
            logA=_log32(self.A),
            logB=_log32(self.B),
            logPi=_log32(self.Pi),
            K=self.K,
        )


@dataclasses.dataclass(frozen=True)
class LogHMM:
    """Log-domain HMM, optionally padded to a lane multiple.

    ``K`` is the *logical* state count; arrays may be padded to ``Kp >= K``.
    """

    logA: np.ndarray  # (Kp, Kp) float32
    logB: np.ndarray  # (Kp, M) float32
    logPi: np.ndarray  # (Kp,) float32
    K: int

    @property
    def Kp(self) -> int:
        return int(self.logA.shape[0])

    @property
    def M(self) -> int:
        return int(self.logB.shape[1])

    def padded(self, multiple: int = 128) -> "LogHMM":
        """Pad the state dimension to ``multiple``; padded states are dead."""
        Kp = round_up(self.Kp, multiple)
        if Kp == self.Kp:
            return self
        k0 = self.Kp
        logA = np.full((Kp, Kp), -np.inf, dtype=np.float32)
        logA[:k0, :k0] = self.logA
        logB = np.full((Kp, self.M), -np.inf, dtype=np.float32)
        logB[:k0] = self.logB
        logPi = np.full((Kp,), -np.inf, dtype=np.float32)
        logPi[:k0] = self.logPi
        return LogHMM(logA=logA, logB=logB, logPi=logPi, K=self.K)

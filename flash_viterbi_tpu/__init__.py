"""flash_viterbi_tpu — FLASH Viterbi decoding framework in JAX.

A ground-up JAX/XLA/Pallas re-design with the capabilities of the reference
FLASH-Viterbi repository (ICDE 2026, arXiv:2510.19301): fast, memory-lean,
parallel Viterbi decoding for HMMs, plus all reference baselines, data
generators, benchmark harness, and a bit-exact CPU oracle.

Quick start::

    from flash_viterbi_tpu import decode, make_sparse_hmm
    hmm, y = make_sparse_hmm(K=512, M=50, T=256, prob=0.25, seed=1)
    result = decode(hmm, y, algorithm="flash", num_segments=8)
    print(result.path, result.time_s, result.memory_bytes)
"""

from .algorithms import auto as _auto  # noqa: F401
from .algorithms import base as _base  # noqa: F401
from .algorithms import beam as _beam  # noqa: F401
from .algorithms import checkpoint as _checkpoint  # noqa: F401
from .algorithms import flash as _flash  # noqa: F401
from .algorithms import flash_bs as _flash_bs  # noqa: F401
from .algorithms import fused as _fused  # noqa: F401
from .algorithms import sieve as _sieve  # noqa: F401
from .algorithms import sieve_bs as _sieve_bs  # noqa: F401
from .algorithms import sieve_dyn as _sieve_dyn  # noqa: F401
from .algorithms import vanilla as _vanilla  # noqa: F401
from .algorithms.base import DecodeResult, available_algorithms, build, decode
from .models.generate import make_dag_hmm, make_sparse_hmm
from .parallel.batch import decode_batch
from .models.hmm import HMM, LogHMM

__version__ = "0.1.0"

__all__ = [
    "DecodeResult",
    "HMM",
    "LogHMM",
    "available_algorithms",
    "build",
    "decode",
    "decode_batch",
    "make_dag_hmm",
    "make_sparse_hmm",
]

"""Preprocessing cache — the reference's pickle cache, framework-style.

``Baseline.py:134-170`` pickles the preprocessed adjacency/acoustic
structures keyed by (K, T, prob, beam_width) and reloads them on rerun.
Here the expensive precomputations are the log tables (float64 ``log`` over
K² probabilities) and the SIEVE adjacency structures; both cache to
``.npz``/pickle files keyed the same way.  Compiled executables go to
JAX's persistent compilation cache (:func:`enable_compile_cache`).
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from ..models.hmm import HMM, LogHMM

DEFAULT_DIR = os.environ.get("FLASH_VITERBI_CACHE", ".fv_cache")

#: the checkout holding this package; the compile cache defaults under it
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def compile_cache_dir() -> str:
    """``JAX_COMPILATION_CACHE_DIR`` when set, else ``<checkout>/.jax_cache``.

    The default is a fixed path (the path is part of the cache key, so a
    directory named after a PID, a time or a temporary name never hits)."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(_CHECKOUT, ".jax_cache"))


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    With ``JAX_COMPILATION_CACHE_DIR`` set JAX already reads it, and no
    other directory is set here."""
    import jax

    path = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def _key(prefix: str, **params) -> str:
    parts = "_".join(f"{k}{v}" for k, v in sorted(params.items()))
    return f"{prefix}_{parts}"


def cached_log_tables(hmm: HMM, cache_dir: str = DEFAULT_DIR,
                      **params) -> LogHMM:
    """Log-domain tables, loaded from cache when the key matches
    (analog of the reference's preprocessed_data_*.pkl)."""
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, _key("logtables", K=hmm.K, M=hmm.M,
                                        **params) + ".npz")
    if os.path.exists(path):
        z = np.load(path)
        return LogHMM(logA=z["logA"], logB=z["logB"], logPi=z["logPi"],
                      K=int(z["K"]))
    lh = hmm.log()
    np.savez(path, logA=lh.logA, logB=lh.logB, logPi=lh.logPi, K=lh.K)
    return lh


def cached_adjacency(A: np.ndarray, B: np.ndarray, cache_dir: str = DEFAULT_DIR,
                     **params):
    """SIEVE adjacency structures (edge lists + acoustic dicts), pickled
    exactly like ``Baseline.py:164-170``."""
    from ..oracle.sieve_bs import build_adjacency

    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, _key("adjacency", K=A.shape[0],
                                        M=B.shape[1], **params) + ".pkl")
    if os.path.exists(path):
        with open(path, "rb") as f:
            return pickle.load(f)
    data = build_adjacency(A, B)
    with open(path, "wb") as f:
        pickle.dump(data, f)
    return data

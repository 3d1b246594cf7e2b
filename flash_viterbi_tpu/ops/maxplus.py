"""Tropical (max-plus) trellis primitives — the framework's core math.

One Viterbi trellis step is a max-plus matvec with an argmax witness::

    delta'[i] = max_k ( delta[k] + logA[k, i] ) + logB[i, y_t]
    ptr[i]    = argmin-index k attaining the max (lowest k on ties)

The fp32 evaluation order — inner sum ``delta + logA``, emission added
*after* the max — is the framework's numerics contract (matches
``oracle.reference`` ``numerics="f32"``).  The emission term is constant
over the source index k, so the argmax is unchanged in exact arithmetic vs
the reference C's in-loop 3-term sum (``src/FLASH_Viterbi_multithread.c:170``,
which computes in double and truncates once — both orders are equally close
to it); hoisting it out of the K² inner loop removes a full K×K add per
trellis step and is the layout the Triton step wants.
``jnp.argmax`` returns the first occurrence, matching the reference's
strict-``>`` scans (SURVEY.md §3.6).

These are the pure-XLA definitions.  :func:`maxplus_lanes` is the one
N-lane step every decoder calls; on the GPU it may run the Triton kernel
of ``ops.maxplus_triton``, which has identical semantics.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def maxplus_lanes_xla(delta: jax.Array, logA: jax.Array):
    """(N, K) lanes x (K, Kd) block -> ((N, Kd) max, (N, Kd) int32 argmax),
    without the emission term; the plain reference of the Triton step."""
    scores = delta[:, :, None] + logA[None, :, :]
    return (jnp.max(scores, axis=1),
            jnp.argmax(scores, axis=1).astype(jnp.int32))


def use_kernel_for(use_kernel: bool | str = "auto",
                   platform: str | None = None) -> bool:
    """Whether :func:`maxplus_lanes` runs the Triton step.

    "auto": on a GPU, where it measured faster than XLA at every lane
    count tried (PERF.md); XLA elsewhere.  True asks for the kernel and is
    an error off the GPU (it has no compiled form there); False is XLA."""
    platform = platform or jax.default_backend()
    if use_kernel == "auto":
        return platform == "gpu"
    if use_kernel and platform != "gpu":
        raise ValueError(f"the Triton step needs a GPU, not {platform!r}")
    return bool(use_kernel)


def maxplus_lanes(delta: jax.Array, logA: jax.Array,
                  use_kernel: bool | str = "auto"):
    """N-lane step without the emission term: the Triton kernel or XLA, as
    :func:`use_kernel_for` decides (both return bit-identical results)."""
    if use_kernel_for(use_kernel):
        from .maxplus_triton import maxplus_lanes_triton

        return maxplus_lanes_triton(delta, logA)
    return maxplus_lanes_xla(delta, logA)


def maxplus_step(delta: jax.Array, logA: jax.Array, emit: jax.Array):
    """One trellis step.

    Args:
      delta: (K,) fp32 scores at time t-1.
      logA:  (K, K) fp32 log transition matrix (source k rows, dest i cols).
      emit:  (K,) fp32 log emission column ``logB[:, y_t]``.

    Returns:
      (delta', ptr): (K,) fp32 new scores and (K,) int32 argmax witnesses.
    """
    scores = delta[:, None] + logA  # (k_src, i_dst)
    return jnp.max(scores, axis=0) + emit, jnp.argmax(scores, axis=0).astype(jnp.int32)


def maxplus_step_noptr(delta: jax.Array, logA: jax.Array, emit: jax.Array):
    """Pointer-free step (for score-only passes, e.g. checkpoint forward)."""
    scores = delta[:, None] + logA
    return jnp.max(scores, axis=0) + emit


def forward_scan(delta0: jax.Array, logA: jax.Array, emits: jax.Array):
    """Forward pass over a whole (sub)sequence, materializing pointers.

    Args:
      delta0: (K,) initial scores (time of ``emits`` row -1).
      emits:  (T', K) log emission rows for times 1..T'.

    Returns:
      (delta_final (K,), ptrs (T', K) int32).
    """

    def step(delta, emit):
        d, p = maxplus_step(delta, logA, emit)
        return d, p

    return jax.lax.scan(step, delta0, emits)


def backtrack(ptrs: jax.Array, last_state: jax.Array) -> jax.Array:
    """Reverse pointer walk.

    Args:
      ptrs: (T', K) int32, row t holds predecessors for the step into time t+1.
      last_state: scalar int32 state at the final time.

    Returns:
      (T'+1,) int32 full path including ``last_state``.
    """

    def step(state, ptr_row):
        prev = ptr_row[state]
        return prev, prev

    _, path = jax.lax.scan(step, last_state, ptrs, reverse=True)
    return jnp.concatenate([path, last_state[None]])


def argmax_final(delta: jax.Array) -> jax.Array:
    """Lowest-index argmax of the final scores (reference :186-196)."""
    return jnp.argmax(delta).astype(jnp.int32)

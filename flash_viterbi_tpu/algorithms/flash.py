"""FLASH Viterbi: anchored two-phase segmented decode.

The reference (``src/FLASH_Viterbi_multithread.c``) runs one sequential
multi-midpoint forward pass that anchors N-1 interior states (phase 1,
``nvviterNdivide`` :126-202), then a pthread work queue binary-splits
segments until every position is resolved (phase 2, ``worker``/``nvviter``
:204-308).

Redesign (SURVEY.md §7): the dynamic work queue disappears.

* **Phase 1** is a ``lax.scan`` carrying ``(delta, anchor-pointer planes)``;
  plane propagation schedules are static booleans precomputed from (T, N).
* **Phase 2 "pointer" mode** (default, fastest): every segment is decoded
  *in one round* by a lane-batched forced-boundary forward pass that
  materializes its own pointer table and backtracks locally.  Memory
  O(T*K/N) per segment — sharded away under ``shard_map`` (see
  ``parallel.sharded``).
* **Phase 2 "lean" mode**: the reference's binary splitting, batched — the
  splitting tree is static, so each level is ONE lane-batched
  single-midpoint pass over all intervals of that level (carrying only
  (delta, t2) — O(K) per interval, the reference's memory profile) with no
  scheduler at all.

Every trellis step goes through ``ops.maxplus.maxplus_lanes``, so the
segments (or intervals) of a round share one ``logA`` stream when the
Triton step runs.  Both modes produce the identical path (same argmax
contract).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..ops import maxplus as mp
from .base import Decoder, register

# hybrid lean: split intervals down to this length, then decode the leaves
# in lane groups of LEAF_LANES (bounds the live pointer tables); shared
# with the working-set model in ``algorithms.auto``
LEAN_LEAF = 64
LEAF_LANES = 32


def flash_midpoints(L: int, R: int, N: int) -> list[int]:
    """Balanced interior midpoints (reference :129-136)."""
    gap, extra = divmod(R - L, N)
    mids: list[int] = []
    m = L + gap
    if extra:
        extra -= 1
        m += 1
    mids.append(m)
    for _ in range(1, N - 1):
        m = mids[-1] + gap
        if extra:
            extra -= 1
            m += 1
        mids.append(m)
    return mids


def segment_layout(mids: list[int], T: int) -> tuple[list[int], list[int], int]:
    """(starts, lens, Lmax) of the N anchored segments bounded by ``mids``.

    The single source of the segment geometry shared by flash, flash_bs
    and the sharded legacy path (segment s covers [starts[s],
    starts[s] + lens[s] - 1]; the last ends at T-1)."""
    starts = [0] + [m + 1 for m in mids]
    ends = list(mids) + [T - 1]
    lens = [e - s + 1 for s, e in zip(starts, ends)]
    return starts, lens, max(lens)


def prop_schedule(mids: list[int], T: int) -> np.ndarray:
    """(T-1, P) bool: True where pointer plane p PROPAGATES (j > mid+1)
    rather than records, for trellis steps j in [1, T) (reference
    :163,176-179,242).  Vectorized — the naive per-(j, plane) list
    comprehension is O(T*P) Python work at trace time."""
    mids_a = np.asarray(mids, dtype=np.int64).reshape(1, -1)
    return np.arange(1, T, dtype=np.int64)[:, None] > mids_a + 1


def split_tree(segments: list[tuple[int, int]]) -> list[list[tuple[int, int, int]]]:
    """Static binary splitting tree: rounds of (L, R, mid) intervals.

    Mirrors the work generated by the reference's queue (``worker``
    :298-303) — every interval with R > L+1 spawns (L,mid) and, when
    R > mid+1, (mid+1,R).  All intervals of one round are independent.
    """
    rounds, _ = split_tree_leaves(segments, min_leaf=0)
    return rounds


def split_tree_leaves(segments: list[tuple[int, int]], min_leaf: int = 0):
    """Binary splitting rounds, stopping at ``min_leaf``-length leaves.

    Returns (rounds, leaves): intervals of length <= min_leaf are not
    split further — their interiors decode in one forced-boundary pointer
    pass each (both endpoints' states are resolved by then).  min_leaf=0
    reproduces the reference's full splitting (every position resolved as
    some interval's midpoint).
    """
    rounds: list[list[tuple[int, int, int]]] = []
    leaves: list[tuple[int, int]] = []
    work = []
    for L, R in segments:
        if R <= L:
            continue
        if R - L + 1 <= min_leaf:
            leaves.append((L, R))
        else:
            work.append((L, R))
    while work:
        rounds.append([(L, R, (L + R) >> 1) for (L, R) in work])
        nxt = []
        for L, R in work:
            mid = (L + R) >> 1
            for (l2, r2) in ((L, mid), (mid + 1, R)):
                if r2 <= l2:
                    continue
                if r2 - l2 + 1 <= min_leaf:
                    leaves.append((l2, r2))
                else:
                    nxt.append((l2, r2))
        work = nxt
    return rounds, leaves


# ---------------------------------------------------------------------------
# Phase 1: multi-anchor forward pass
# ---------------------------------------------------------------------------

def phase1_anchors(logA, logPi, emits, mids: list[int],
                   use_kernel: bool | str = "auto"):
    """One forward pass resolving the final state and all anchor states.

    Returns (last_state, anchors (N-1,) int32).  Equivalent to
    ``nvviterNdivide(0, T-1, ...)`` (reference :126-201).
    """
    T, K = emits.shape
    P = len(mids)
    delta0 = logPi + emits[0]
    planes0 = jnp.zeros((P, K), dtype=jnp.int32)
    # propagate plane n at step j iff j > mids[n]+1 (reference :163,176-179)
    prop = prop_schedule(mids, T)

    def step(carry, x):
        delta, planes = carry
        emit, pr = x
        val, arg = mp.maxplus_lanes(delta[None], logA, use_kernel)
        delta_new, arg = val[0] + emit, arg[0]
        if P:
            moved = jnp.take_along_axis(planes, arg[None, :], axis=1)
            planes = jnp.where(pr[:, None], moved, arg[None, :])
        return (delta_new, planes), None

    (delta, planes), _ = jax.lax.scan(step, (delta0, planes0), (emits[1:], jnp.asarray(prop)))
    last = mp.argmax_final(delta)
    anchors = planes[:, last] if P else jnp.zeros((0,), jnp.int32)
    return last, anchors


# ---------------------------------------------------------------------------
# Phase 2, pointer mode: vmapped per-segment decode
# ---------------------------------------------------------------------------

def decode_segments_pointer(logA, logPi, emits, starts, lens, init_states,
                            end_states, Lmax: int, T: int,
                            use_kernel: bool | str = "auto"):
    """Decode N forced-boundary segments as N lanes; returns (N, Lmax) paths.

    ``init_states[s]`` is the resolved state at ``starts[s]-1`` (ignored for
    segment 0, which starts from ``logPi``); ``end_states[s]`` the resolved
    state at ``starts[s]+lens[s]-1``.  Steps beyond a segment's true length
    keep its carry and record identity pointer rows, so one uniform
    backtrack serves every lane.
    """
    N = starts.shape[0]
    K = logA.shape[0]
    idx = jnp.minimum(starts[:, None] + jnp.arange(Lmax)[None, :], T - 1)
    seg_emits = emits[idx]  # (N, Lmax, K)

    first = jnp.arange(N) == 0
    d0 = jnp.where(first[:, None], logPi[None, :], logA[init_states]) + seg_emits[:, 0]
    emitsN = jnp.transpose(seg_emits[:, 1:, :], (1, 0, 2))  # (Lmax-1, N, K)
    valid = jnp.arange(1, Lmax)[:, None] <= (lens - 1)[None, :]  # (Lmax-1, N)
    iota = jnp.arange(K, dtype=jnp.int32)

    def step(delta, x):
        emit, v = x
        val, arg = mp.maxplus_lanes(delta, logA, use_kernel)
        return (jnp.where(v[:, None], val + emit, delta),
                jnp.where(v[:, None], arg, iota[None, :]))

    _, ptrs = jax.lax.scan(step, d0, (emitsN, valid))  # (Lmax-1, N, K)
    return jax.vmap(mp.backtrack, in_axes=(1, 0))(ptrs, end_states)


# ---------------------------------------------------------------------------
# Phase 2, lean mode: batched binary splitting (O(K) per interval)
# ---------------------------------------------------------------------------

def _lean_round(logA, logPi, emits, ans, intervals: list[tuple[int, int, int]],
                T: int, use_kernel: bool | str = "auto"):
    """One splitting round: every interval of the round is one lane of a
    single-midpoint forward pass.

    Equivalent to running ``nvviter(L, R, mid)`` (reference :204-262) for
    every interval of the round, resolving ``ans[mid]``.
    """
    S = len(intervals)
    K = emits.shape[1]
    Ls = np.asarray([iv[0] for iv in intervals])
    Rs = np.asarray([iv[1] for iv in intervals])
    mids = np.asarray([iv[2] for iv in intervals])
    Lmax = int((Rs - Ls).max()) + 1

    idx = np.minimum(Ls[:, None] + np.arange(Lmax)[None, :], T - 1)
    valid = np.arange(1, Lmax)[:, None] <= (Rs - Ls)[None, :]  # (Lmax-1, S)
    # t2 propagates (rather than records) once j > mid+1 (reference :242)
    prop = (Ls[None, :] + np.arange(1, Lmax)[:, None]) > (mids[None, :] + 1)

    seg_emits = emits[jnp.asarray(idx)]  # (S, Lmax, K)
    is_head = jnp.asarray(Ls == 0)
    prev_state = ans[jnp.asarray(np.maximum(Ls - 1, 0))]
    d0 = jnp.where(is_head[:, None], logPi[None, :], logA[prev_state]) + seg_emits[:, 0]
    t2_0 = jnp.where(
        is_head[:, None],
        jnp.zeros((S, K), jnp.int32),
        jnp.broadcast_to(prev_state[:, None].astype(jnp.int32), (S, K)),
    )

    def step(carry, x):
        delta, t2 = carry
        emit, v, pr = x
        val, arg = mp.maxplus_lanes(delta, logA, use_kernel)
        t2_new = jnp.where(pr[:, None], jnp.take_along_axis(t2, arg, axis=1), arg)
        return (jnp.where(v[:, None], val + emit, delta),
                jnp.where(v[:, None], t2_new, t2)), None

    xs = (jnp.transpose(seg_emits[:, 1:, :], (1, 0, 2)), jnp.asarray(valid),
          jnp.asarray(prop))
    (_, t2), _ = jax.lax.scan(step, (d0, t2_0), xs)
    end_states = ans[jnp.asarray(Rs)]
    resolved = jnp.take_along_axis(t2, end_states[:, None].astype(jnp.int32), axis=1)[:, 0]
    return ans.at[jnp.asarray(mids)].set(resolved)


def _decode_leaves(logA, logPi, emits, ans, leaves, T: int,
                   use_kernel: bool | str = "auto",
                   group_lanes: int = LEAF_LANES):
    """Forced-boundary pointer decode of the splitting tree's leaves.

    Both endpoints of every leaf are resolved once the rounds complete, so
    each leaf's interior is one pointer pass + backtrack.  Lanes are capped
    at ``group_lanes`` per pass, bounding live pointer memory to
    O(leaf_len * group_lanes * K) — the hybrid that closes lean mode's
    recompute gap (binary splitting costs a full re-scan per level; leaves
    cost one).
    """
    out = ans
    for length in sorted({r - l + 1 for l, r in leaves}):
        group = [iv for iv in leaves if iv[1] - iv[0] + 1 == length]
        for g0 in range(0, len(group), group_lanes):
            sub = group[g0:g0 + group_lanes]
            Ls = np.asarray([l for l, r in sub])
            Rs = np.asarray([r for l, r in sub])
            is_head = jnp.asarray(Ls == 0)
            prev_state = ans[jnp.asarray(np.maximum(Ls - 1, 0))]
            e0 = emits[jnp.asarray(Ls)]  # (S, K)
            d0 = jnp.where(is_head[:, None], logPi[None, :],
                           logA[prev_state]) + e0
            idx = jnp.asarray(Ls[None, :] + np.arange(1, length)[:, None])
            emitsN = emits[idx]  # (length-1, S, K)
            ends = ans[jnp.asarray(Rs)]

            def stepf(d, e):
                val, arg = mp.maxplus_lanes(d, logA, use_kernel)
                return val + e, arg

            _, ptrs = jax.lax.scan(stepf, d0, emitsN)
            paths = jax.vmap(mp.backtrack, in_axes=(1, 0))(ptrs, ends)
            pos = jnp.asarray(Ls)[:, None] + jnp.arange(length)[None, :]
            out = out.at[pos.reshape(-1)].set(paths.reshape(-1))
    return out


# ---------------------------------------------------------------------------
# Full decoders
# ---------------------------------------------------------------------------

def flash_decode(logA, logB, logPi, y, num_segments: int = 8, mode: str = "pointer",
                 use_pallas: bool | str = "auto", precision: str = "fp32",
                 lean_leaf: int = LEAN_LEAF):
    """FLASH decode of one sequence.  ``use_pallas`` chooses the Triton
    step for every lane-batched trellis step (``ops.maxplus.use_kernel_for``:
    "auto", True or False)."""
    if precision == "bf16":  # approximate fast mode (see algorithms.fused)
        logA = logA.astype(jnp.bfloat16)
    T = y.shape[0]
    N = int(num_segments)
    if N < 1 or T < 2 * N:
        N = max(1, min(N, T // 2)) or 1
    emits = logB[:, y].T  # (T, K)

    mids = flash_midpoints(0, T - 1, N) if N > 1 else []
    last, anchors = phase1_anchors(logA, logPi, emits, mids, use_pallas)

    starts_l, lens_l, Lmax = segment_layout(mids, T)
    if mode == "pointer":
        starts = jnp.asarray(starts_l, dtype=jnp.int32)
        lens = jnp.asarray(lens_l, jnp.int32)
        init_states = jnp.concatenate([jnp.zeros((1,), jnp.int32), anchors])
        end_states = jnp.concatenate([anchors, last[None]])
        paths = decode_segments_pointer(
            logA, logPi, emits, starts, lens, init_states, end_states, Lmax,
            T, use_pallas)
        pos = starts[:, None] + jnp.arange(Lmax)[None, :]
        pos = jnp.where(jnp.arange(Lmax)[None, :] < lens[:, None], pos, T)
        out = jnp.zeros((T,), jnp.int32).at[pos.reshape(-1)].set(
            paths.reshape(-1), mode="drop"
        )
        return out

    if mode == "lean":
        ans = jnp.zeros((T,), jnp.int32)
        ans = ans.at[T - 1].set(last)
        if mids:
            ans = ans.at[jnp.asarray(mids)].set(anchors)
        segments = [(s, s + ln - 1) for s, ln in zip(starts_l, lens_l)]
        rounds, leaves = split_tree_leaves(segments, min_leaf=max(0, lean_leaf))
        for rnd in rounds:
            ans = _lean_round(logA, logPi, emits, ans, rnd, T, use_pallas)
        if leaves:
            ans = _decode_leaves(logA, logPi, emits, ans, leaves, T, use_pallas)
        return ans

    raise ValueError(f"unknown flash mode {mode!r}")


def _threadpool_sizeof(N: int) -> int:
    # glibc x86-64: pthread_mutex_t 40 + pthread_cond_t 48 + pthread_t[N]
    # + 3 ints, padded to 8 (FLASH_Viterbi_multithread.c:36-46)
    return (40 + 48 + 8 * N + 12 + 7) // 8 * 8


def _memory(K: int, T: int, num_segments: int = 8, mode: str = "pointer", **_) -> int:
    """Reference-exact (FLASH_Viterbi_multithread.c:341-367), with
    num_segments in MAX_THREADS' role: max(phase-1 tables, per-thread
    double buffers) + sizeof(ThreadPool) + 8 — the final +8 reproduces the
    sizeof(obserRouteLEN*sizeof(INTERVAL)) sizeof-of-expression bug (:367),
    which evaluates to sizeof(unsigned long)."""
    N = max(1, num_segments)
    phase1 = 0
    if N > 2 and T >= 2 * N:
        phase1 = (N - 1) * 4 + 2 * K * 4 + 2 * (N - 1) * K * 4
    tmp = N * (2 * K * 4 + 2 * K * 4)
    return max(phase1, tmp) + _threadpool_sizeof(N) + 8


@register("flash")
def _build(num_segments: int = 8, mode: str = "pointer",
           use_pallas: bool | str = "auto", precision: str = "fp32",
           lean_leaf: int = LEAN_LEAF, **static) -> Decoder:
    def fn(logA, logB, logPi, y):
        return flash_decode(logA, logB, logPi, y, num_segments=num_segments,
                            mode=mode, use_pallas=use_pallas,
                            precision=precision, lean_leaf=lean_leaf)

    return Decoder("flash", fn,
                   {"num_segments": num_segments, "mode": mode,
                    "use_pallas": use_pallas, "precision": precision,
                    "lean_leaf": lean_leaf,
                    **static}, _memory)

"""Multi-card FLASH decode: ``shard_map`` over a ``(data, seq, state)`` mesh.

The reference's only parallel runtime is a pthread work queue over time
intervals (``src/FLASH_Viterbi_multithread.c:264-335``).  The replacement
(SURVEY.md §2.6/§2.7) has no scheduler at all — three static mesh axes
carry all the parallelism, with XLA collectives between the cards:

* ``data``  — batch of independent sequences (the reference decodes one
  sequence per process).
* ``seq``   — FLASH's sequence parallelism.  Unlike the reference (whose
  phase 1, ``nvviterNdivide`` :126-202, is single-threaded), BOTH phases
  split over the ``seq`` axis here:

  - **phase 1 is a software pipeline over equal time blocks**: seq device
    r owns block r = times ``[r*L, (r+1)*L)`` (and that block's share of
    the forward work and of the emission stream); microbatches of
    sequences flow through the blocks GPipe-style, the (mb, K) δ-carry
    hopping devices via ``ppermute`` once per block — O(K) bytes per hop
    against L*K²/n_state compute.  With a batch of n_mb microbatches the
    pipeline is busy n_mb/(n_mb + n_seq - 1) of the time; phase-1 work
    per device is T*K²/(n_seq*n_state) — every axis divides all the work.
  - **anchors resolve hierarchically**: each block keeps its own
    boundary plane (state at its entry time, per block-end state) and
    spd-1 interior segment planes — plane propagation is pointer
    composition, which is associative, so evaluating block planes at the
    chain of block-end states reproduces the serial multi-anchor pass
    bit-exactly.  The backward chain over blocks is n_seq tiny gathers.
  - phase 2 decodes each block's segments locally (forced-boundary
    pointer decode, the same contract as ``algorithms.flash``).

* ``state`` — tensor parallelism over the state dimension, needed once
  ``log A`` outgrows one card (K=16384 → 1 GiB fp32): each device holds a
  column block ``logA[:, shard]`` and computes its slice of every max-plus
  step with the same lane step as one card (``ops.maxplus.maxplus_lanes``,
  on the rectangular block); the K-carries are rebuilt with a tiled
  ``all_gather`` — O(K) bytes per trellis step, negligible against the
  K²/s compute.

The mesh follows the algorithm alone: every card reaches every other at
the same rate, so no device topology enters the layout.

Pipeline/expert parallelism have no analog here (no layered model, no
experts — SURVEY.md §2.6 rows 4-5).

Paths are bit-identical to ``algorithms.flash``/``algorithms.vanilla``
(same strict-'>' lowest-index argmax contract everywhere).  A legacy
non-pipelined path (`pipeline=False`, also the automatic fallback when T
does not divide evenly) keeps the original replicated-phase-1 scheme for
arbitrary shapes.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..algorithms.flash import flash_midpoints, prop_schedule, segment_layout
from ..ops import maxplus as mp
AXES = ("data", "seq", "state")


def make_mesh(n_data: int = 1, n_seq: int = 1, n_state: int = 1, devices=None) -> Mesh:
    """Build a (data, seq, state) mesh from the first n_data*n_seq*n_state devices."""
    need = n_data * n_seq * n_state
    devices = list(jax.devices() if devices is None else devices)[:need]
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    return Mesh(np.asarray(devices).reshape(n_data, n_seq, n_state), AXES)


def mesh_shape_for(n_devices: int) -> tuple[int, int, int]:
    """Factor a device count into a (data, seq, state) mesh shape.

    Prime factors are dealt round-robin to (state, seq, data) so every axis
    is exercised when the count allows (8 → 2×2×2, 4 → 1×2×2, 2 → 1×1×2).
    """
    dims = [1, 1, 1]  # data, seq, state
    n = n_devices
    order = [2, 1, 0]  # state first, then seq, then data
    i = 0
    f = 2
    while n > 1:
        while n % f:
            f += 1
        dims[order[i % 3]] *= f
        n //= f
        i += 1
    return tuple(dims)


# ===========================================================================
# Pipelined path: equal time blocks, GPipe-style microbatch flow
# ===========================================================================

def _pipeline_plan(T: int, n_seq: int, num_segments: int | None):
    """(L, spd, Lseg) for the pipelined path, or None if the shape doesn't
    divide evenly (the legacy path handles those)."""
    if T % n_seq:
        return None
    L = T // n_seq
    if num_segments is None:
        for spd in (4, 2, 1):
            if L % spd == 0 and L // spd >= 2:
                return L, spd, L // spd
        return None
    N = int(num_segments)
    if N % n_seq:
        return None
    spd = N // n_seq
    if spd < 1 or L % spd or L // spd < 2:
        return None
    return L, spd, L // spd


def _flash_decode_pipelined(mesh, logA, logBT, logPi, ys, L: int, spd: int,
                            Lseg: int, mb: int, use_kernel: bool | str):
    n_data, n_seq, n_state = (mesh.shape[a] for a in AXES)
    Bs, T = ys.shape
    K = logA.shape[0]
    Bd = Bs // n_data
    if Bd % mb:
        raise ValueError(
            f"microbatch {mb} must divide the per-data-shard batch {Bd}")
    n_mb = Bd // mb
    ticks = n_mb + n_seq - 1

    # plane record schedule for block steps i = 1..L-1 (ptr row i-1):
    # plane 0 (β, block-entry boundary) is recorded at the boundary step and
    # only propagates here; plane m (interior segment boundary m) is
    # recorded at i == m*Lseg — the reference's record-at-j==mid+1 /
    # propagate-after contract (FLASH_Viterbi_multithread.c:163,176-179)
    rec_np = np.zeros((L - 1, spd), dtype=bool)
    for m_ in range(1, spd):
        rec_np[m_ * Lseg - 1, m_] = True
    rec_sched = jnp.asarray(rec_np)

    def local_fn(logA_l, logBT_l, logPi_f, ys_l):
        r = jax.lax.axis_index("seq")

        def ag(x):
            if n_state == 1:
                return x
            return jax.lax.all_gather(x, "state", axis=x.ndim - 1, tiled=True)

        def local_matvec(delta):
            """(NL, K) carry -> local (NL, Kd) scores + global argmax."""
            return mp.maxplus_lanes(delta, logA_l, use_kernel)

        def step_local(delta, sym):
            """Full trellis step: returns (delta' (NL,K), ptr (NL,K))."""
            val_l, ptr_l = local_matvec(delta)
            d_l = val_l + logBT_l[sym]
            return ag(d_l), ag(ptr_l)

        def fold_one(planes, ptr, rec):
            """Plane recurrence for one ptr row; rec (nP,) bool selects
            record-vs-propagate per plane."""
            idx = jnp.broadcast_to(ptr[:, None, :], planes.shape)
            moved = jnp.take_along_axis(planes, idx, axis=2)
            return jnp.where(rec[None, :, None], idx, moved)

        # ---- phase 1: pipelined block forward passes ----------------------
        def block_pass(carry_delta, ys_blk):
            sym0 = ys_blk[:, 0]
            emit0_l = logBT_l[sym0]  # (mb, Kd)
            bval_l, bptr_l = local_matvec(carry_delta)  # boundary step
            d = (jnp.where(r == 0, jnp.broadcast_to(logPi_f, (mb, K)), ag(bval_l))
                 + ag(emit0_l))
            planes = jnp.concatenate(
                [ag(bptr_l)[:, None, :],
                 jnp.zeros((mb, spd - 1, K), jnp.int32)], axis=1)

            def stepf(carry, x):
                dd, pl_ = carry
                sym, rec = x
                dn, ptr = step_local(dd, sym)
                return (dn, fold_one(pl_, ptr, rec)), None

            (d, planes), _ = jax.lax.scan(
                stepf, (d, planes),
                (jnp.transpose(ys_blk[:, 1:]), rec_sched))
            return d, planes

        def tick(carry_delta, c):
            m_idx = jnp.clip(c - r, 0, n_mb - 1)
            ys_mb = jax.lax.dynamic_slice(ys_l, (m_idx * mb, 0), (mb, T))
            ys_blk = jax.lax.dynamic_slice(ys_mb, (0, r * L), (mb, L))
            d, planes = block_pass(carry_delta, ys_blk)
            if n_seq > 1:
                nxt = jax.lax.ppermute(
                    d, "seq", [(i, (i + 1) % n_seq) for i in range(n_seq)])
            else:
                nxt = d
            return nxt, (planes, d)

        init = jnp.zeros((mb, K), jnp.float32)
        _, (planes_t, finals_t) = jax.lax.scan(tick, init, jnp.arange(ticks))

        # microbatch m was processed here at tick m + r; it finished at the
        # last block at tick m + n_seq - 1
        my_planes = jnp.take(planes_t, jnp.arange(n_mb) + r, axis=0)
        my_finals = finals_t[n_seq - 1:]  # (n_mb, mb, K)

        # ---- anchor resolution: backward chain over blocks ----------------
        # argmax locally BEFORE gathering: only the last seq device's final
        # argmax is consumed, so ship (n_mb, mb) int32 between cards instead of
        # the full (n_mb, mb, K) fp32 score tensor (K x less traffic)
        j_local = jnp.argmax(my_finals, axis=-1).astype(jnp.int32)
        if n_seq > 1:
            beta_all = jax.lax.all_gather(my_planes[:, :, 0, :], "seq")
            j_all = jax.lax.all_gather(j_local, "seq")
        else:
            beta_all = my_planes[None, :, :, 0, :]
            j_all = j_local[None]
        j = j_all[n_seq - 1]
        ends = [None] * n_seq
        ends[n_seq - 1] = j
        for rr in range(n_seq - 1, 0, -1):
            ends[rr - 1] = jnp.take_along_axis(
                beta_all[rr], ends[rr][..., None], axis=-1)[..., 0]
        ends = jnp.stack(ends)  # (n_seq, n_mb, mb)
        jr = jnp.take(ends, r, axis=0)  # my block-end states
        jprev = jnp.where(r == 0, 0,
                          jnp.take(ends, jnp.maximum(r - 1, 0), axis=0))

        # ---- phase 2: forced-boundary pointer decode of my segments -------
        NL = mb * spd

        def decode_mb(_, x):
            planes_m, jr_m, jp_m, ys_g = x
            # interior anchors: plane m evaluated at the block-end state
            inter = jnp.take_along_axis(
                planes_m[:, 1:, :],
                jnp.broadcast_to(jr_m[:, None, None], (mb, max(spd - 1, 0), 1)),
                axis=2)[..., 0]  # (mb, spd-1)
            entries = jnp.concatenate([jp_m[:, None], inter], axis=1).reshape(NL)
            exits = jnp.concatenate([inter, jr_m[:, None]], axis=1).reshape(NL)
            ys_blk = jax.lax.dynamic_slice(ys_g, (0, r * L), (mb, L))
            seg_sym = ys_blk.reshape(mb, spd, Lseg)
            sym0 = seg_sym[:, :, 0].reshape(NL)
            first = (r == 0) & (jnp.arange(NL) % spd == 0)

            d0 = (jnp.where(first[:, None],
                            jnp.broadcast_to(logPi_f, (NL, K)),
                            ag(logA_l[entries]))
                  + ag(logBT_l[sym0]))
            syms = jnp.transpose(seg_sym[:, :, 1:].reshape(NL, Lseg - 1))
            _, ptrs = jax.lax.scan(
                lambda dd, sym: step_local(dd, sym), d0, syms)
            paths = jax.vmap(mp.backtrack, in_axes=(1, 0))(ptrs, exits)
            vals = paths.reshape(mb, L)
            out = jax.lax.dynamic_update_slice(
                jnp.zeros((mb, T), jnp.int32), vals, (0, r * L))
            return None, out

        _, outs = jax.lax.scan(
            decode_mb, None,
            (my_planes, jr, jprev, ys_l.reshape(n_mb, mb, T)))
        out = outs.reshape(Bd, T)
        return jax.lax.psum(out, "seq") if n_seq > 1 else out

    fn = jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(P(None, "state"), P(None, "state"), P(None), P("data", None)),
        out_specs=P("data", None),
        # all_gather'd carries are value-replicated over 'state' but JAX's
        # varying-manual-axes analysis can't prove it; skip the check.
        check_vma=False,
    )
    return jax.jit(fn)(logA, logBT, logPi, ys)


# ===========================================================================
# Legacy path: replicated phase 1, flash_midpoints segment layout
# (kept for shapes the pipelined path's even-division constraints reject;
#  bit-identical to algorithms.flash pointer mode with the same segments)
# ===========================================================================

def _ag(x):
    """Rebuild a full K-vector from per-device state shards (tiled gather)."""
    return jax.lax.all_gather(x, "state", tiled=True)


def _sharded_step(delta_full, logA_l, emit_l):
    """One max-plus trellis step with logA column-sharded over 'state'.

    delta_full: (K,) replicated; logA_l: (K, K/s); emit_l: (K/s,).
    Returns replicated (delta' (K,), ptr (K,) int32 global source indices).
    """
    scores = delta_full[:, None] + logA_l  # (K, K/s)
    d_l = jnp.max(scores, axis=0) + emit_l
    p_l = jnp.argmax(scores, axis=0).astype(jnp.int32)
    return _ag(d_l), _ag(p_l)


def _phase1_sharded(logA_l, logPi_l, emits_l, mids: list[int], T: int):
    """Multi-anchor forward pass, state-sharded (cf. algorithms.flash.phase1_anchors)."""
    nP = len(mids)
    delta0 = _ag(logPi_l + emits_l[0])
    K = delta0.shape[0]
    planes0 = jnp.zeros((nP, K), dtype=jnp.int32)
    prop = jnp.asarray(prop_schedule(mids, T))

    def step(carry, x):
        delta, planes = carry
        emit_l, pr = x
        d, arg = _sharded_step(delta, logA_l, emit_l)
        if nP:
            moved = jnp.take_along_axis(planes, arg[None, :], axis=1)
            planes = jnp.where(pr[:, None], moved, arg[None, :])
        return (d, planes), None

    (delta, planes), _ = jax.lax.scan(step, (delta0, planes0), (emits_l[1:], prop))
    last = jnp.argmax(delta).astype(jnp.int32)
    anchors = planes[:, last] if nP else jnp.zeros((0,), jnp.int32)
    return last, anchors


def _segment_path(logA_l, logPi_l, emits_l, start, nsteps, init_state, end_state,
                  is_first, Lmax: int, T: int):
    """Forced-boundary pointer decode of one segment, state-sharded."""
    K = logA_l.shape[0]
    idx = jnp.minimum(start + jnp.arange(Lmax), T - 1)
    seg_emits_l = emits_l[idx]  # (Lmax, K/s)
    d0 = _ag(jnp.where(is_first, logPi_l, logA_l[init_state]) + seg_emits_l[0])
    iota = jnp.arange(K, dtype=jnp.int32)

    def step(delta, x):
        emit_l, valid = x
        d, p = _sharded_step(delta, logA_l, emit_l)
        d = jnp.where(valid, d, delta)
        p = jnp.where(valid, p, iota)
        return d, p

    valid = jnp.arange(1, Lmax) <= nsteps
    _, ptrs = jax.lax.scan(step, d0, (seg_emits_l[1:], valid))  # (Lmax-1, K)
    return mp.backtrack(ptrs, end_state)  # (Lmax,)


def _decode_one_local(logA_l, logB_l, logPi_l, y, starts, lens, mids: list[int],
                      spd: int, Lmax: int, T: int):
    """Decode one sequence: phase 1 (replicated over 'seq'), then this seq
    device's ``spd`` segments, scatter + psum over 'seq'."""
    emits_l = logB_l[:, y].T  # (T, K/s)
    last, anchors = _phase1_sharded(logA_l, logPi_l, emits_l, mids, T)
    init_states = jnp.concatenate([jnp.zeros((1,), jnp.int32), anchors])
    end_states = jnp.concatenate([anchors, last[None]])

    rank = jax.lax.axis_index("seq")
    s0 = rank * spd
    st_loc = jax.lax.dynamic_slice(starts, (s0,), (spd,))
    ln_loc = jax.lax.dynamic_slice(lens, (s0,), (spd,))
    in_loc = jax.lax.dynamic_slice(init_states, (s0,), (spd,))
    en_loc = jax.lax.dynamic_slice(end_states, (s0,), (spd,))
    first = (s0 + jnp.arange(spd, dtype=jnp.int32)) == 0

    seg = partial(_segment_path, logA_l, logPi_l, emits_l, Lmax=Lmax, T=T)
    paths = jax.vmap(lambda a, b, c, d, e: seg(a, b, c, d, e))(
        st_loc, ln_loc - 1, in_loc, en_loc, first
    )  # (spd, Lmax)

    pos = st_loc[:, None] + jnp.arange(Lmax)[None, :]
    pos = jnp.where(jnp.arange(Lmax)[None, :] < ln_loc[:, None], pos, T)
    out = jnp.zeros((T,), jnp.int32).at[pos.reshape(-1)].set(
        paths.reshape(-1), mode="drop"
    )
    return jax.lax.psum(out, "seq")


def _flash_decode_legacy(mesh, logA, logB, logPi, ys, num_segments):
    n_seq = mesh.shape["seq"]
    Bs, T = ys.shape

    N = num_segments if num_segments is not None else n_seq * max(1, min(4, T // (2 * n_seq)))
    if N % n_seq:
        raise ValueError(f"num_segments={N} must be a multiple of seq axis {n_seq}")
    if T < 2 * N:
        raise ValueError(f"T={T} too short for {N} segments")
    spd = N // n_seq

    mids = flash_midpoints(0, T - 1, N) if N > 1 else []
    starts_l, lens_l, Lmax = segment_layout(mids, T)
    starts = jnp.asarray(starts_l, jnp.int32)
    lens = jnp.asarray(lens_l, jnp.int32)

    def local_fn(logA_l, logB_l, logPi_l, ys_l):
        return jax.vmap(
            lambda y: _decode_one_local(
                logA_l, logB_l, logPi_l, y, starts, lens, mids, spd, Lmax, T
            )
        )(ys_l)

    fn = jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(P(None, "state"), P("state", None), P("state"), P("data", None)),
        out_specs=P("data", None),
        check_vma=False,
    )
    return jax.jit(fn)(logA, logB, logPi, ys)


# ---------------------------------------------------------------------------
# Public entry
# ---------------------------------------------------------------------------

def flash_decode_sharded(mesh: Mesh, logA, logB, logPi, ys,
                         num_segments: int | None = None,
                         microbatch: int = 1,
                         pipeline: bool | str = "auto",
                         use_kernel: bool | str = "auto"):
    """Batched multi-card FLASH decode.

    Args:
      mesh: a (data, seq, state) mesh from :func:`make_mesh`.
      logA/logB/logPi: log tables (padded so K divides mesh 'state' size).
      ys: (Bs, T) int32 observation batch (Bs divides mesh 'data' size).
      num_segments: total phase-2 segments; must be a multiple of the 'seq'
        axis size.
      microbatch: sequences per pipeline microbatch (pipelined path only);
        larger values amortize the kernel's logA stream over more lanes,
        smaller values fill the pipeline faster.
      pipeline: "auto" uses the pipelined seq-parallel path whenever the
        shape divides evenly (T % n_seq == 0, equal segments); False forces
        the legacy replicated-phase-1 path; True errors if unsupported.
      use_kernel: the Triton step for every local step
        (``ops.maxplus.use_kernel_for``: "auto", True or False).

    Returns:
      (Bs, T) int32 decoded paths — bit-identical to ``algorithms.flash``
      (and therefore ``algorithms.vanilla``) on every mesh shape.
    """
    n_data, n_seq, n_state = (mesh.shape[a] for a in AXES)
    Bs, T = ys.shape
    K = logA.shape[0]
    if K % n_state:
        raise ValueError(f"state axis {n_state} must divide padded K={K}")
    if Bs % n_data:
        raise ValueError(f"data axis {n_data} must divide batch {Bs}")
    if T < 2 * n_seq:
        raise ValueError(f"T={T} too short for seq axis {n_seq} "
                         f"(each seq device needs a >=2-step segment)")
    if num_segments is not None:
        # clamp like the single-card decoder (flash_decode: N <= T//2),
        # rounded down to the required multiple of the seq axis
        N = min(int(num_segments), max(1, T // 2))
        num_segments = max(n_seq, (N // n_seq) * n_seq)

    plan = _pipeline_plan(T, n_seq, num_segments)
    if pipeline is True and plan is None:
        raise ValueError(
            f"pipelined path needs T divisible into equal segments per seq "
            f"device (T={T}, n_seq={n_seq}, num_segments={num_segments})")
    if pipeline is False or plan is None:
        return _flash_decode_legacy(mesh, logA, logB, logPi, ys, num_segments)

    L, spd, Lseg = plan
    logBT = jnp.transpose(logB)  # (M, K), column-sharded over 'state'
    return _flash_decode_pipelined(mesh, logA, logBT, logPi, ys, L, spd, Lseg,
                                   int(microbatch), use_kernel)

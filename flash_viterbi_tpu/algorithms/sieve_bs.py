"""SIEVE-BS (dynamic median): the last reference algorithm.

The reference (``Base_line/C implementations/SIEVE-BS.c:360-549`` /
``sieve_beam_search.py:65-261``) recurses over a *data-dependent* split
point: during each beam-pruned forward pass it tracks, per end state, the
transition minimizing ``max(#b-hop-ancestors(x_a), #b-hop-descendants(x_b))``
with a ``|j - T/2|`` closeness tie-break, then splits the segment there.

Redesign: the split sizes are runtime data, so — unlike ``sieve_mp``'s
static tree — the recursion cannot be a fixed level-batched program.
The decomposition (``engine="device"``, the default):

* **The ENTIRE recursion tree runs on device in one dispatch**
  (:func:`_device_recursion`): an explicit node stack in a
  ``lax.while_loop``, per-node beam forward passes at exact segment
  lengths, BFS prunes as early-exit frontier-matvec ``while_loop``s,
  and one readback of the node table at the end — the host only
  flattens the tree in-order.  (The host-driven level scheduler,
  kept under ``engine="host"`` for differential testing, pays one host
  sync per tree level.)
* **The reference's sequential candidate semantics** (beam-ordered
  source iteration with strictly-greater improvement, the stale-median
  no-write quirk, median inheritance from the source's path) collapse
  to dense vector ops via the record-point argument — see
  :func:`_vec_step`; the j=1 all-sources step further reduces to a
  plain first-occurrence argmax (fresh carry: every record writes).
* **b-hop neighborhood counts** (the preprocessing of ``calc`` :656-672)
  are K simultaneous BFS frontier advances as dense matmuls on device.
* Per-dest *active token sets* (the beam snapshot attached to a median,
  :465-484) collapse to one invariant: the set attached to state h is
  always the beam recorded after step ``med_n[h]`` — so a (T, K) beam
  log replaces the reference's per-state set copies.

Documented deltas (identical off exact fp ties, same policy as
``sieve_bs_mp``): score ties resolve by lowest state index (the reference
resolves by dict-insertion order); scores are fp32 (reference float64).

Prior semantics — the two reference implementations differ off their own
fixtures: the C binary re-inits every recursion node from the **model Pi**
(``SIEVE-BS.c:367``: ``log(vit->Pi[i]) + log B``), while the Python chain
threads the root-call Pi, which ``Baseline.py:160`` always passes as
uniform ``log(1/K)``.  They coincide on every reference fixture (the
generator's Pi *is* uniform).  This decoder follows the **C binary**
(model Pi at every node) — the artifact the repo verifies bit-exact —
pinned by a non-uniform-Pi C-parity test; ``oracle.sieve_bs`` keeps the
Baseline.py convention and is therefore a valid yardstick only for
uniform model Pi.

Reference quirks kept: emission misses contribute 0 (dict fallthrough
:119-123); left children force ``last=x_a`` while right children inherit
the parent's resolved ``last`` (:207/:259); left recursions thread the
parent's token set, right recursions get the median-step beam (:218-219).

Totality extension: when beam pruning eliminates every median candidate
of a subproblem the reference *crashes* (KeyError at
``sieve_beam_search.py:88`` — the -1 sentinel enters the child's index
set; ``oracle.sieve_bs`` raises ``ReferenceUndefined`` there).  This
decoder instead emits the SIEVE-Mp-style ``(-1, -1)`` sentinel pair for
that node, skips the impossible recursion, and decodes the rest — the
only defined-everywhere behavior consistent with the family's sentinel
convention (``SIEVE-Mp.c:412-420``).
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from .base import Decoder, register
from .sieve import NEG, _bfs_masks

_SENT_TOUCHED = np.float32(-2.0e38)   # touched but still -inf (dict key present)
_SENT_UNTOUCHED = np.float32(-3.0e38)


def _beam_vals(T1, touched):
    """Order states as heapq.nlargest over the touched dict: finite scores
    first, then touched -inf entries, then absent states."""
    return jnp.where(touched, jnp.where(jnp.isneginf(T1), _SENT_TOUCHED, T1),
                     _SENT_UNTOUCHED)


@partial(jax.jit, static_argnames=("hops",))
def _bhop_counts(A_posF, hops: int):
    """(#<=hops-edge ancestors, #descendants) per state — the reference's
    per-state BFS preprocessing (SIEVE-BS.c:656-672) as K simultaneous
    frontier advances; source excluded unless re-reached (cycle)."""
    K = A_posF.shape[0]
    eye = jnp.eye(K, dtype=jnp.float32)
    ones = jnp.ones((K, K), jnp.float32)
    desc = _bfs_masks(A_posF, eye, ones, hops).sum(axis=1)
    anc = _bfs_masks(jnp.transpose(A_posF), eye, ones, hops).sum(axis=1)
    return anc.astype(jnp.float32), desc.astype(jnp.float32)


def _vec_step(T1src, srcs, src_valid, logA_rows, emit_row, mask,
              anc_src, desc_cnt, mx_src, my_src, mn_src, mval_src,
              j, Thalf, iota):
    """One beam trellis step, vectorized over S sources × K destinations.

    Collapses the reference's *sequential* source iteration
    (``sieve_beam_search.py:151-219``; round 4 ran it as a ``lax.scan``
    over beam slots) into dense ops: per destination, the slots that
    "win" (strictly improve the running score) are exactly the strict
    record points of the candidate sequence in source order, and each
    winning slot either OVERWRITES the median carry (writing its own
    median when the (pair, closeness) criterion prefers it, else
    inheriting the source's median if it has one) or — the reference's
    stale-median quirk — leaves the carry untouched.  Hence the final
    score is the global max over eligible candidates and the final
    median state comes from the LAST record point whose write predicate
    holds; destinations with no writing record point end at the per-step
    reset state (-1, -1, 0, +inf).

    All median inputs (``anc_src``, ``mx/my/mn/mval_src``) are the
    PREVIOUS step's values gathered at the sources — the sequential loop
    reads only those, never the in-step running state, which is what
    makes the collapse exact.
    """
    S, K = logA_rows.shape
    cand = T1src[:, None] + logA_rows + emit_row[None, :]
    edge = ((logA_rows > NEG) & (mask > 0)[None, :] & src_valid[:, None])
    candE = jnp.where(edge, cand, NEG)
    run = jax.lax.associative_scan(jnp.maximum, candE, axis=0)
    prev = jnp.concatenate(
        [jnp.full((1, K), NEG, candE.dtype), run[:-1]], axis=0)
    rec = candE > prev  # strict record points == the winning slots
    pair = jnp.maximum(anc_src[:, None], desc_cnt[None, :])
    pv = mval_src[:, None]
    closer = (jnp.abs(j.astype(jnp.float32) - Thalf)
              < jnp.abs(mn_src.astype(jnp.float32) - Thalf))[:, None]
    take_new = (pair < pv) | ((pair == pv) & closer)
    writes = rec & (take_new | (mx_src != -1)[:, None])
    cidx = jnp.arange(S, dtype=jnp.int32)[:, None]
    ws = jnp.max(jnp.where(writes, cidx, -1), axis=0)  # last writing slot
    has = ws >= 0
    w = jnp.maximum(ws, 0)
    tn = jnp.take_along_axis(take_new, w[None, :], axis=0)[0]
    node_w = srcs[w]
    nT1 = jnp.max(candE, axis=0)
    nmx = jnp.where(has, jnp.where(tn, node_w, mx_src[w]), -1).astype(jnp.int32)
    nmy = jnp.where(has, jnp.where(tn, iota, my_src[w]), -1).astype(jnp.int32)
    nmn = jnp.where(has, jnp.where(tn, j, mn_src[w]), 0).astype(jnp.int32)
    nmval = jnp.where(has, jnp.where(tn, jnp.maximum(anc_src[w], desc_cnt),
                                     mval_src[w]), jnp.inf)
    return nT1, nmx, nmy, nmn, nmval


def _node_forward_impl(logA, emitQ, A_posF, anc_cnt, desc_cnt, logPi,
                       y_seg, n_valid, mask, tokens0, last_forced, B: int):
    """One recursion node's beam forward pass with dynamic-median tracking.

    ``y_seg`` may be padded past the true segment length ``n_valid`` (the
    host buckets lengths to powers of two so the recursion compiles
    O(log T) programs, not one per distinct length); padded steps pass the
    carry through unchanged.

    Returns (x_a, x_b, n_left, tokens_right (K,) f32, last) — the split
    decision of ``viterbi_space_efficient``'s main loop (:151-219).
    """
    L = y_seg.shape[0]
    K = logA.shape[0]
    Thalf = n_valid.astype(jnp.float32) / 2.0
    iota = jnp.arange(K, dtype=jnp.int32)

    emit0 = emitQ[:, y_seg[0]]
    # model Pi at every node (SIEVE-BS.c:367), not Baseline.py's uniform
    T1_0 = jnp.where(mask > 0, logPi + emit0, NEG)

    # --- step j=1: all K token states are sources (no beam yet).  The
    # median carry is fresh (mval=+inf) so EVERY record point writes and
    # the last writing record is simply the first-occurrence argmax —
    # the dense form costs ~4 passes over the (K, K) candidates where the
    # general record-point machinery costs ~30 incl. a log-depth cummax
    # (this j=1 step dominated the on-device headline before round 5's
    # specialization: ~10 ms x 253 nodes) -------------------------------
    emit1 = emitQ[:, y_seg[1]]
    src = jnp.where(tokens0 > 0, T1_0, NEG)
    cand = jnp.where(A_posF > 0, src[:, None] + logA, NEG) + emit1[None, :]
    cand = jnp.where(mask[None, :] > 0, cand, NEG)
    t1 = jnp.max(cand, axis=0)
    winner = jnp.argmax(cand, axis=0).astype(jnp.int32)
    touched = jnp.logical_and((tokens0 @ A_posF) > 0, mask > 0)
    won = jnp.logical_and(touched, t1 > NEG)
    mx = jnp.where(won, winner, -1).astype(jnp.int32)
    my = jnp.where(won, iota, -1).astype(jnp.int32)
    mn = jnp.where(won, 1, 0).astype(jnp.int32)
    mval = jnp.where(won, jnp.maximum(anc_cnt[winner], desc_cnt), jnp.inf)
    T1 = jnp.where(touched, t1, NEG)

    bvals = _beam_vals(T1, touched)
    _, bidx = jax.lax.top_k(bvals, B)
    eff = jnp.minimum(B, jnp.sum(touched))
    slot_ok = jnp.arange(B) < eff
    tokm = jnp.zeros((K,), jnp.float32).at[bidx].max(slot_ok.astype(jnp.float32))
    beams = jnp.zeros((L, K), jnp.float32).at[1].set(tokm)

    # --- steps j=2..L-1: the same vectorized step over the B beam slots,
    # in beam order (top_k order == the reference's candidate order) -----
    def outer(carry, x):
        T1, mx, my, mn, mval, bidx, eff, touched, beams = carry
        j, emit_row = x

        src_valid = jnp.arange(B) < eff
        rows = logA[bidx]
        nT1, nmx, nmy, nmn, nmval = _vec_step(
            T1[bidx], bidx, src_valid, rows, emit_row,
            mask, anc_cnt[bidx], desc_cnt, mx[bidx], my[bidx], mn[bidx],
            mval[bidx], j, Thalf, iota)

        # touched == reachable-from-beam: OR of the already-gathered beam
        # rows' edge masks — replaces a K x K matvec per step
        ntouched = jnp.logical_and(
            jnp.any((rows > NEG) & src_valid[:, None], axis=0), mask > 0)
        nbvals = _beam_vals(nT1, ntouched)
        _, nbidx = jax.lax.top_k(nbvals, B)
        neff = jnp.minimum(B, jnp.sum(ntouched))
        ntok = tokm_of(nbidx, neff)
        nbeams = beams.at[j].set(ntok)
        nT1 = jnp.where(ntouched, nT1, NEG)
        valid = j < n_valid  # padded step: pass the carry through
        new = (nT1, nmx, nmy, nmn, nmval, nbidx, neff, ntouched, nbeams)
        old = (T1, mx, my, mn, mval, bidx, eff, touched, beams)
        return tuple(jnp.where(valid, n_, o_) for n_, o_ in zip(new, old)), None

    def tokm_of(bidx, eff):
        ok = (jnp.arange(B) < eff).astype(jnp.float32)
        return jnp.zeros((K,), jnp.float32).at[bidx].max(ok)

    if L > 2:
        (T1, mx, my, mn, mval, bidx, eff, touched, beams), _ = jax.lax.scan(
            outer, (T1, mx, my, mn, mval, bidx, eff, touched, beams),
            (jnp.arange(2, L), emitQ[:, y_seg[2:]].T))

    last = jnp.where(last_forced >= 0, last_forced,
                     jnp.argmax(_beam_vals(T1, touched)).astype(jnp.int32))
    x_a = mx[last]
    x_b = my[last]
    n_left = mn[last]
    tokens_right = jnp.where(x_a != -1, beams[n_left], jnp.zeros((K,)))
    return x_a, x_b, n_left, tokens_right, last


_node_forward = partial(jax.jit, static_argnames=("B",))(_node_forward_impl)

# Fixed lane width for level-batched node forwards: all ready nodes of one
# length bucket run as ceil(n/_LANES) vmapped dispatches (padded by
# replaying lane 0) instead of one dispatch per node: every synced
# dispatch costs a host round trip, and at T=256 there are hundreds of
# nodes.  A FIXED width keeps the compile count at one program per
# length bucket (a data-dependent width would recompile per group size —
# compiles cost far more than the padded lanes' wasted FLOPs).
_LANES = 8


@partial(jax.jit, static_argnames=("B",))
def _node_forward_batch(logA, emitQ, A_posF, anc_cnt, desc_cnt, logPi,
                        y_segs, n_valids, masks, tokens0s, last_forceds,
                        B: int):
    """vmap of :func:`_node_forward_impl` over a lane of recursion nodes."""
    return jax.vmap(
        lambda ys, nv, mk, tk, lf: _node_forward_impl(
            logA, emitQ, A_posF, anc_cnt, desc_cnt, logPi,
            ys, nv, mk, tk, lf, B=B)
    )(y_segs, n_valids, masks, tokens0s, last_forceds)


@partial(jax.jit, static_argnames=("B",))
def _device_recursion(logA, emitQ, A_posF, A_posT, anc_cnt, desc_cnt,
                      logPi, y, root_mask, B: int):
    """The ENTIRE SIEVE-BS recursion tree in one device dispatch.

    The host-driven scheduler pays one dispatch sync per recursion LEVEL
    (trees here run dozens of levels deep).  This engine moves
    the *whole* tree on device: an explicit node stack in a
    ``lax.while_loop``, each node running its beam forward pass (a
    nested ``while_loop`` of :func:`_vec_step` + ``top_k``, exact
    lengths — no power-of-two padding) and its children's BFS prunes
    (frontier-matvec ``while_loop``s with early exit, matching
    ``_host_bfs``), then pushing the children.  One readback at the end
    returns the node table; the host only flattens the tree in-order.

    Node capacity: a segment of length L yields at most L-1 nodes
    (children require length ≥ 2), so C = T slots always suffice.

    Per-node math is :func:`_node_forward_impl`'s exactly — same
    ``_vec_step``, same beam ordering, same split rules — so results are
    bit-identical to the host scheduler path (pinned by tests that run
    both).  Mirrors ``SIEVE-BS.c:360-549`` semantics throughout.
    """
    K = logA.shape[0]
    T = y.shape[0]
    C = max(int(T), 1)
    iota = jnp.arange(K, dtype=jnp.int32)
    iotaB = jnp.arange(B, dtype=jnp.int32)
    NEGj = jnp.float32(NEG)

    def bfs(adjF, src, hops):
        """Visited-gated BFS from ``src``, <= ``hops`` edge hops
        (== ``_host_bfs``: source excluded unless re-reached)."""
        def cond(c):
            h, vis, fr, alive = c
            return alive & (h < hops)

        def body(c):
            h, vis, fr, alive = c
            nxt = ((fr.astype(jnp.float32) @ adjF) > 0) & (~vis)
            return (h + 1, vis | nxt, nxt, jnp.any(nxt))

        _, vis, _, _ = jax.lax.while_loop(
            cond, body, (jnp.int32(0), jnp.zeros((K,), jnp.bool_),
                         iota == src, jnp.bool_(True)))
        return vis

    def process(state):
        (stack, sp, count, masks, tokens, lo_a, ln_a, lastf, kind,
         pa, pb, nl_a, lch, rch, beams) = state
        nid = stack[sp - 1]
        sp = sp - jnp.int32(1)
        mask = masks[nid]
        lo = lo_a[nid]
        L = ln_a[nid]
        msum = jnp.sum(mask)
        knd = jnp.where(msum <= 1, 3, jnp.where(L == 1, 2, 1))
        kind = kind.at[nid].set(knd)

        def fwd(op):
            (stack, sp, count, masks, tokens, lo_a, ln_a, lastf,
             pa, pb, nl_a, lch, rch, beams) = op
            Thalf = L.astype(jnp.float32) / 2.0
            tok0 = tokens[nid]
            T1_0 = jnp.where(mask, logPi + emitQ[:, y[lo]], NEGj)
            # j=1 dense step, first-argmax specialization (see
            # _node_forward_impl — the fresh carry makes it exact)
            emit1 = emitQ[:, y[lo + 1]]
            src = jnp.where(tok0 > 0, T1_0, NEGj)
            cand = (jnp.where(A_posF > 0, src[:, None] + logA, NEGj)
                    + emit1[None, :])
            cand = jnp.where(mask[None, :], cand, NEGj)
            t1 = jnp.max(cand, axis=0)
            winner = jnp.argmax(cand, axis=0).astype(jnp.int32)
            touched = ((tok0 @ A_posF) > 0) & mask
            won = touched & (t1 > NEGj)
            mx = jnp.where(won, winner, -1).astype(jnp.int32)
            my = jnp.where(won, iota, -1).astype(jnp.int32)
            mn = jnp.where(won, 1, 0).astype(jnp.int32)
            mval = jnp.where(won, jnp.maximum(anc_cnt[winner], desc_cnt),
                             jnp.inf)
            T1 = jnp.where(touched, t1, NEGj)
            _, bidx = jax.lax.top_k(_beam_vals(T1, touched), B)
            eff = jnp.minimum(B, jnp.sum(touched))
            tokm = jnp.zeros((K,), jnp.float32).at[bidx].max(
                (iotaB < eff).astype(jnp.float32))
            beams = beams.at[1].set(tokm)

            def tbody(c):
                j, T1, mx, my, mn, mval, bidx, eff, touched, beams = c
                src_valid = iotaB < eff
                rows = logA[bidx]
                nT1, nmx, nmy, nmn, nmval = _vec_step(
                    T1[bidx], bidx, src_valid, rows,
                    emitQ[:, y[lo + j]], mask, anc_cnt[bidx], desc_cnt,
                    mx[bidx], my[bidx], mn[bidx], mval[bidx], j, Thalf,
                    iota)
                # reachable-from-beam via the gathered rows' edge masks
                # (no K x K matvec per step)
                ntouched = jnp.any((rows > NEG) & src_valid[:, None],
                                   axis=0) & mask
                nT1 = jnp.where(ntouched, nT1, NEGj)
                _, nbidx = jax.lax.top_k(_beam_vals(nT1, ntouched), B)
                neff = jnp.minimum(B, jnp.sum(ntouched))
                ntokm = jnp.zeros((K,), jnp.float32).at[nbidx].max(
                    (iotaB < neff).astype(jnp.float32))
                return (j + 1, nT1, nmx, nmy, nmn, nmval, nbidx, neff,
                        ntouched, beams.at[j].set(ntokm))

            (_, T1, mx, my, mn, mval, bidx, eff, touched, beams) = \
                jax.lax.while_loop(
                    lambda c: c[0] < L, tbody,
                    (jnp.int32(2), T1, mx, my, mn, mval, bidx, eff,
                     touched, beams))

            lf = lastf[nid]
            last = jnp.where(
                lf >= 0, lf,
                jnp.argmax(_beam_vals(T1, touched)).astype(jnp.int32))
            x_a, x_b, n_left = mx[last], my[last], mn[last]
            tokens_right = jnp.where(x_a != -1, beams[n_left],
                                     jnp.zeros((K,), jnp.float32))
            pa = pa.at[nid].set(x_a)
            pb = pb.at[nid].set(x_b)
            nl_a = nl_a.at[nid].set(n_left)

            # left child: ancestors of x_a, parent's token set, last=x_a
            spawn_l = (n_left > 1) & (x_a >= 0)
            lmask = bfs(A_posT, x_a, n_left - 1) | (iota == x_a)
            cid = count
            masks = masks.at[cid].set(lmask)
            tokens = tokens.at[cid].set(tok0)
            lo_a = lo_a.at[cid].set(lo)
            ln_a = ln_a.at[cid].set(n_left)
            lastf = lastf.at[cid].set(x_a)
            stack = stack.at[sp].set(cid)
            dl = spawn_l.astype(jnp.int32)
            lch = lch.at[nid].set(jnp.where(spawn_l, cid, -1))
            sp2, count2 = sp + dl, count + dl

            # right child: descendants of x_b, median-step beam tokens,
            # last = this node's resolved last
            n_right = L - n_left
            spawn_r = (n_right > 1) & (x_b >= 0)
            rmask = bfs(A_posF, x_b, n_right - 1) | (iota == x_b)
            cid2 = count2
            masks = masks.at[cid2].set(rmask)
            tokens = tokens.at[cid2].set(tokens_right)
            lo_a = lo_a.at[cid2].set(lo + n_left)
            ln_a = ln_a.at[cid2].set(n_right)
            lastf = lastf.at[cid2].set(last)
            stack = stack.at[sp2].set(cid2)
            dr = spawn_r.astype(jnp.int32)
            rch = rch.at[nid].set(jnp.where(spawn_r, cid2, -1))
            return (stack, sp2 + dr, count2 + dr, masks, tokens, lo_a,
                    ln_a, lastf, pa, pb, nl_a, lch, rch, beams)

        op = (stack, sp, count, masks, tokens, lo_a, ln_a, lastf,
              pa, pb, nl_a, lch, rch, beams)
        (stack, sp, count, masks, tokens, lo_a, ln_a, lastf,
         pa, pb, nl_a, lch, rch, beams) = jax.lax.cond(
            knd == 1, fwd, lambda o: o, op)
        return (stack, sp, count, masks, tokens, lo_a, ln_a, lastf, kind,
                pa, pb, nl_a, lch, rch, beams)

    state = (jnp.zeros((C,), jnp.int32),          # stack ([0])
             jnp.int32(1), jnp.int32(1),          # sp, count
             jnp.zeros((C, K), jnp.bool_).at[0].set(root_mask > 0),
             jnp.zeros((C, K), jnp.float32).at[0].set(
                 (root_mask > 0).astype(jnp.float32)),
             jnp.zeros((C,), jnp.int32),          # lo
             jnp.zeros((C,), jnp.int32).at[0].set(T),
             jnp.full((C,), -1, jnp.int32),       # last forced
             jnp.zeros((C,), jnp.int32),          # kind
             jnp.full((C,), -1, jnp.int32),       # pair a
             jnp.full((C,), -1, jnp.int32),       # pair b
             jnp.zeros((C,), jnp.int32),          # n_left
             jnp.full((C,), -1, jnp.int32),       # left child
             jnp.full((C,), -1, jnp.int32),       # right child
             jnp.zeros((max(int(T), 2), K), jnp.float32))  # beam log
    out = jax.lax.while_loop(lambda s: s[1] > 0, process, state)
    return out[8], out[9], out[10], out[12], out[13]


def _flatten_device_tree(kind, pa, pb, lch, rch, root: int = 0
                         ) -> list[tuple[int, int]]:
    """In-order pair flatten of the engine's node table — identical to the
    host scheduler's tree walk (left subtree, own pair, right subtree;
    sentinel nodes emit (-1, -1), skip nodes nothing)."""
    path: list[tuple[int, int]] = []
    stack: list[tuple[int, bool]] = [(root, False)]
    while stack:
        nid, emit = stack.pop()
        k = int(kind[nid])
        if k == 3:
            continue
        if k == 2:
            path.append((-1, -1))
            continue
        if emit:
            path.append((int(pa[nid]), int(pb[nid])))
            continue
        if rch[nid] >= 0:
            stack.append((int(rch[nid]), False))
        stack.append((nid, True))
        if lch[nid] >= 0:
            stack.append((int(lch[nid]), False))
    return path


def _host_bfs(adj: np.ndarray, src: int, hops: int) -> np.ndarray:
    """Visited-gated level BFS (traversal direction rows -> cols),
    <= ``hops`` edge hops; source excluded unless re-reached.  One
    primitive serves both reach conventions: the reference's ``_reach``
    (sieve_beam_search.py:504-546, b-1 edges via :func:`_host_reach`)
    and the dynamic-median oracles' global-index BFS
    (``algorithms.sieve_dyn``, plain hop count)."""
    K = adj.shape[0]
    visited = np.zeros(K, bool)
    frontier = np.zeros(K, bool)
    frontier[src] = True
    for _ in range(max(hops, 0)):
        nxt = adj[frontier].any(axis=0) & ~visited
        if not nxt.any():
            break
        visited |= nxt
        frontier = nxt
    return visited


def _host_reach(A_pos: np.ndarray, src: int, b: int, out: bool) -> np.ndarray:
    """<= b-1 edge hops along out- (in-) edges, the reference's
    depth-from-1 counting."""
    return _host_bfs(A_pos if out else A_pos.T, src, b - 1)


def sieve_bs_decode(logA, logB_raw, logPi, y, beam_width: int,
                    b_hops: int | None = None,
                    engine: str = "device") -> list[tuple[int, int]]:
    """Full SIEVE-BS decode; returns the in-order median-pair list
    (bit-compatible with ``oracle.sieve_bs.sieve_bs`` off exact fp ties).

    ``engine="device"`` (default) runs the whole recursion tree in one
    dispatch (:func:`_device_recursion`); ``engine="host"`` keeps the
    round-4 host-driven level scheduler (same per-node math).
    """
    return sieve_bs_decode_many(logA, logB_raw, logPi,
                                np.asarray(y)[None], beam_width,
                                b_hops=b_hops, engine=engine)[0]


def sieve_bs_decode_many(logA, logB_raw, logPi, ys, beam_width: int,
                         b_hops: int | None = None,
                         engine: str = "device"
                         ) -> list[list[tuple[int, int]]]:
    """SIEVE-BS over a batch of sequences.

    ``engine="device"``: each sequence's recursion tree runs as ONE
    device dispatch; all S dispatches are issued before any readback, so
    the host sync is paid once per batch, not per tree level.

    ``engine="host"``: round 4's shared lane scheduler — every
    sequence's tree feeds one level queue and the 8-lane batched
    forwards fill with nodes from across the batch.  Per-node math and
    per-sequence results are identical between engines.
    """
    ys_np = np.asarray(ys)
    S, T = ys_np.shape
    K = int(logA.shape[0])
    B = min(int(beam_width), K)

    A_posF = (logA > NEG).astype(jnp.float32)
    A_pos_np = np.asarray(A_posF) > 0
    emitQ = jnp.where(logB_raw > NEG, logB_raw, 0.0)
    # logical (non-padding) states: padded states are all -inf everywhere
    # (same liveness rule as sieve_dyn); the model-Pi prior is already
    # -inf there, so padding cannot flip fp-tie outcomes
    real = (np.isfinite(np.asarray(logA)).any(axis=1)
            | np.isfinite(np.asarray(logB_raw)).any(axis=1)
            | np.isfinite(np.asarray(logPi)))
    b = T if b_hops is None else int(b_hops)
    # visited-gated BFS saturates after at most K productive hops (every
    # state, incl. a cycle-re-reached source, enters `visited` once), so
    # capping at K is bit-identical and avoids a T-long matmul scan at
    # long-sequence configs
    anc_cnt, desc_cnt = _bhop_counts(A_posF, hops=min(max(b - 1, 0), K))

    if engine == "device":
        A_posT = jnp.transpose(A_posF)
        real_f = jnp.asarray(real.astype(np.float32))
        outs = [_device_recursion(logA, emitQ, A_posF, A_posT, anc_cnt,
                                  desc_cnt, logPi, jnp.asarray(ys_np[s]),
                                  real_f, B=B)
                for s in range(S)]  # issue all, then read back once
        return [_flatten_device_tree(*map(np.asarray, o)) for o in outs]

    # Level-batched host recursion: the reference's control flow is
    # inherently sequential down a root-to-leaf chain, but SIBLING
    # subtrees are independent once their parent's split is known.  The
    # scheduler therefore runs breadth-first: all ready nodes of a level,
    # grouped by power-of-two length bucket, forward together in lanes of
    # ``_LANES`` — identical per-node math (the same _node_forward_impl
    # under vmap), only the dispatch schedule changes.  The in-order pair
    # list (the reference's self.path append order) is reconstructed from
    # the recursion tree afterwards.
    nodes: list[dict] = []

    def new_node(mask_np, y_seg, last, tokens_np):
        nodes.append({"mask": mask_np, "y": y_seg, "last": last,
                      "tokens": tokens_np, "kind": None, "pair": None,
                      "left": None, "right": None})
        return len(nodes) - 1

    roots = [new_node(np.asarray(real, bool), ys_np[s], None, None)
             for s in range(S)]
    level = list(roots)
    while level:
        ready = []
        for nid in level:
            nd = nodes[nid]
            L = len(nd["y"])
            if nd["mask"].sum() <= 1:
                nd["kind"] = "skip"
            elif L == 1:
                # single-frame node: the oracle's forward loop never runs,
                # no median is recorded — sentinel pair, no recursion
                nd["kind"] = "sentinel"
            else:
                nd["kind"] = "forward"
                ready.append(nid)

        # group by compiled length bucket (next power of two: O(log T)
        # distinct programs, not one per data-dependent split length)
        buckets: dict[int, list[int]] = {}
        for nid in ready:
            L = len(nodes[nid]["y"])
            Lp = 1 << max(1, (L - 1)).bit_length() if L > 2 else L
            buckets.setdefault(Lp, []).append(nid)

        nxt: list[int] = []
        # issue every lane-chunk of the level WITHOUT syncing: one
        # readback per LEVEL instead of per chunk
        pending = []
        for Lp, grp in sorted(buckets.items()):
            for g0 in range(0, len(grp), _LANES):
                chunk = grp[g0:g0 + _LANES]
                n = len(chunk)
                ys = np.zeros((_LANES, Lp), np.int32)
                ns = np.zeros((_LANES,), np.int32)
                ms = np.zeros((_LANES, K), np.float32)
                tk = np.zeros((_LANES, K), np.float32)
                lf = np.full((_LANES,), -1, np.int32)
                for i, nid in enumerate(chunk):
                    nd = nodes[nid]
                    L = len(nd["y"])
                    ys[i, :L] = nd["y"]
                    ns[i] = L
                    ms[i] = nd["mask"]
                    tk[i] = nd["mask"] if nd["tokens"] is None else nd["tokens"]
                    lf[i] = -1 if nd["last"] is None else nd["last"]
                for i in range(n, _LANES):  # pad: replay lane 0 (discarded)
                    ys[i], ns[i], ms[i], tk[i], lf[i] = (ys[0], ns[0], ms[0],
                                                         tk[0], lf[0])
                out = _node_forward_batch(
                    logA, emitQ, A_posF, anc_cnt, desc_cnt, logPi,
                    jnp.asarray(ys), jnp.asarray(ns), jnp.asarray(ms),
                    jnp.asarray(tk), jnp.asarray(lf), B=B)
                pending.append((chunk, out))
        for chunk, (xa, xb, nl, tr, lr) in pending:
            xa = np.asarray(xa); xb = np.asarray(xb)
            nl = np.asarray(nl); lr = np.asarray(lr)
            tr = np.asarray(tr) > 0
            for i, nid in enumerate(chunk):
                nd = nodes[nid]
                L = len(nd["y"])
                x_a, x_b = int(xa[i]), int(xb[i])
                n_left, last_r = int(nl[i]), int(lr[i])
                nd["pair"] = (x_a, x_b)
                if n_left > 1 and x_a >= 0:
                    lm = _host_reach(A_pos_np, x_a, n_left, out=False)
                    lm = lm.copy()
                    lm[x_a] = True
                    nd["left"] = new_node(lm, nd["y"][:n_left], x_a,
                                          nd["tokens"])
                    nxt.append(nd["left"])
                n_right = L - n_left
                if n_right > 1 and x_b >= 0:
                    rm = _host_reach(A_pos_np, x_b, n_right, out=True)
                    rm = rm.copy()
                    rm[x_b] = True
                    nd["right"] = new_node(rm, nd["y"][-n_right:],
                                           last_r, tr[i])
                    nxt.append(nd["right"])
        level = nxt

    # in-order flatten == the reference's append order (left subtree,
    # own pair, right subtree); iterative to dodge recursion limits
    def flatten(root: int) -> list[tuple[int, int]]:
        path: list[tuple[int, int]] = []
        stack: list[tuple[int, bool]] = [(root, False)]
        while stack:
            nid, emit = stack.pop()
            nd = nodes[nid]
            if nd["kind"] == "skip":
                continue
            if nd["kind"] == "sentinel":
                path.append((-1, -1))
                continue
            if emit:
                path.append(nd["pair"])
                continue
            if nd["right"] is not None:
                stack.append((nd["right"], False))
            stack.append((nid, True))
            if nd["left"] is not None:
                stack.append((nd["left"], False))
        return path

    return [flatten(r) for r in roots]


def _memory(K: int, T: int, beam_width: int = 64, **_) -> int:
    # device engine live buffers: node masks (T, K) bool + token sets
    # (T, K) f32 + the (T, K) beam-log scratch + forward carries (5
    # K-vectors) + b-hop counts + the int32 node table (~12 T-vectors)
    return T * K * (1 + 4 + 4) + 7 * K * 4 + 12 * T * 4


@register("sieve_bs")
def _build(beam_width: int = 64, b_hops: int | None = None, **static) -> Decoder:
    from .sieve_dyn import _flatten

    def fn(logA, logB, logPi, y):
        pairs = sieve_bs_decode(logA, logB, logPi, y, beam_width=beam_width,
                                b_hops=b_hops)
        # shared pretty_print_path flattening (all -1 when nothing resolved,
        # the family's unresolved-position convention)
        return jnp.asarray(_flatten(pairs, int(y.shape[0])))

    def batch_fn(logA, logB, logPi, ys):
        T = int(ys.shape[1])
        many = sieve_bs_decode_many(logA, logB, logPi, ys,
                                    beam_width=beam_width, b_hops=b_hops)
        return jnp.stack([jnp.asarray(_flatten(p, T)) for p in many])

    return Decoder("sieve_bs", fn,
                   {"beam_width": beam_width, "b_hops": b_hops, **static},
                   _memory, jittable=False, batch_fn=batch_fn)

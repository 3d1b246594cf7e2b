"""SIEVE-Mp: level-batched masked divide-and-conquer.

The reference (``Base_line/C implementations/SIEVE-Mp.c:286-509``) recurses
over the time midpoint, BFS-prunes the state set of each half, and runs a
pruned K'xK' forward pass per node — data-dependent shapes everywhere.

Redesign (SURVEY.md §3.4/§7): the recursion *tree over time* is static
(floor(T/2) splits), so

* nodes are processed **level by level**; all segments of one level with
  equal length decode as the lanes of ONE scan (2 scans/level max,
  lengths within a level differ by at most one);
* state-set pruning becomes a **mask**: banned states get -inf emissions,
  which kills them as destinations and (via -inf scores) as sources — the
  masked full-K argmax equals the reference's subset argmax, including
  lowest-index tie-breaking (subset order is ascending);
* the BFS itself is h hops of a boolean frontier advance, computed as an
  matmul against the 0/1 adjacency matrix, batched over segments;
* median pairs come from a cheap post-scan over the scan's pointer rows
  (record at j == mid, then gather-propagate — reference :338-346);
* the in-order pair flattening (``change_mp_path`` :466-489) has a fully
  static structure (the -1-sentinel condition depends only on tree shape),
  so it reduces to one gather from the stacked pair values.

Reference quirks kept: right children re-pick their end state by argmax
(last=-1, :452), left children force it to x_a; unforced segments use a
subset-uniform prior log(1/K_sub) (:303-307).

``prune=False`` skips the BFS masking: on inputs where pruning only
removes unreachable (-inf) states — every non-degenerate case — the
decoded path is identical, and decode cost drops to the two forward
sweeps.
"""

from __future__ import annotations

import dataclasses

import numpy as np

import jax
import jax.numpy as jnp

from ..ops import maxplus as mp
from .base import Decoder, register

NEG = np.float32(-np.inf)  # numpy scalar: no backend init at import


@dataclasses.dataclass
class _Node:
    idx: int
    start: int
    length: int
    parent: int  # -1 for root
    side: str  # "root" | "left" | "right"
    depth: int
    inorder: int = -1
    left: int = -1
    right: int = -1
    sentinel: bool = False


def build_tree(T: int) -> list[_Node]:
    """Static recursion tree, in-order numbering and sentinel flags
    (mirrors sieve_middlepath's call structure + mp_path appends)."""
    nodes: list[_Node] = []

    def rec(start: int, length: int, parent: int, side: str, depth: int) -> int:
        me = len(nodes)
        nodes.append(_Node(me, start, length, parent, side, depth))
        n_left = length // 2
        n_right = length - n_left
        if n_left > 1:
            nodes[me].left = rec(start, n_left, me, "left", depth + 1)
        if n_right > 1:
            nodes[me].right = rec(start + n_left, n_right, me, "right", depth + 1)
        return me

    rec(0, T, -1, "root", 0)

    # in-order append positions + static sentinel decisions (C :412-428)
    count = 0

    def inord(i: int):
        nonlocal count
        nd = nodes[i]
        if nd.left >= 0:
            inord(nd.left)
        n_left = nd.length // 2
        n_right = nd.length - n_left
        nd.sentinel = (n_right <= 1 and n_left <= 1 and count < T - 2
                       and count != 0)
        nd.inorder = count
        count += 1
        if nd.right >= 0:
            inord(nd.right)

    inord(0)
    return nodes


def flatten_positions(nodes: list[_Node], T: int):
    """Static simulation of change_mp_path: for each output position,
    (inorder pair index, 0 for .x / 1 for .y)."""
    pairs = sorted(nodes, key=lambda n: n.inorder)
    mp_path = [("S" if n.sentinel else n.inorder) for n in pairs]
    out: list[tuple[int, int]] = []
    out.append((mp_path[0], 0))
    out.append((mp_path[0], 1))
    i = 1
    while len(out) <= len(mp_path):
        if mp_path[i] == "S":
            if i + 1 >= len(mp_path):
                break
            out.append((mp_path[i + 1], 0))
            out.append((mp_path[i + 1], 1))
            i += 1
        else:
            out.append((mp_path[i], 1))
        i += 1
    out = out[:T]
    assert all(p != "S" for p, _ in out), "sentinel leaked into output"
    return out


def _planes_from_ptrs(ptrs, mid: int):
    """(plane_x, plane_y) (S, K) from pointer rows (L-1, S, K): record at
    j == mid, gather-propagate after (reference :338-346)."""
    S, K = ptrs.shape[1], ptrs.shape[2]
    px0 = ptrs[mid - 1]  # (S, K) source state at mid-1 per dest at mid
    py0 = jnp.broadcast_to(jnp.arange(K, dtype=jnp.int32)[None, :], (S, K))

    def step(carry, row):
        px, py = carry
        px = jnp.take_along_axis(px, row, axis=1)
        py = jnp.take_along_axis(py, row, axis=1)
        return (px, py), None

    (px, py), _ = jax.lax.scan(step, (px0, py0), ptrs[mid:])
    return px, py


def _bfs_masks(adjF, frontier0, parent_mask, hops: int):
    """Nodes within <= hops of the frontier, inside parent_mask.

    adjF: (K, K) f32 0/1 matrix, adjF[i, j] = edge i->j in traversal
    direction.  frontier0: (S, K) one-hot f32.  One matmul per hop.
    """
    visited = jnp.zeros_like(frontier0)

    def step(carry, _):
        visited, frontier = carry
        # a sum of 0/1 products compared with > 0: exact in any precision
        # a float32 matmul may use (TF32 on a GPU keeps every nonzero sum
        # nonzero), so no precision argument is needed
        reach = (frontier @ adjF) > 0
        new = jnp.logical_and(reach, visited == 0).astype(frontier0.dtype)
        new = new * parent_mask
        return (jnp.maximum(visited, new), new), None

    (visited, _), _ = jax.lax.scan(step, (visited, frontier0), None, length=hops)
    return visited  # (S, K) 0/1


def sieve_mp_decode(logA, logB, logPi, y, A_posF, prune: bool = True):
    """Full SIEVE-Mp decode; bit-compatible with
    ``oracle.sieve.sieve_mp(numerics='f32')`` when ``prune=True``.

    The recursion tree is built from ``y``'s *static shape*, so this is
    jit-safe.  ``A_posF`` is the (K, K) 0/1 float32 edge matrix.
    """
    T = int(y.shape[0])
    K = logA.shape[0]
    if T == 1:
        # degenerate case: the reference's pair flattening needs >= 2 output
        # slots (change_mp_path writes both pair states unconditionally,
        # SIEVE-Mp.c:470-471 — out of bounds at T=1); decode directly.
        d0 = logPi + logB[:, y[0]]
        return jnp.argmax(d0).astype(jnp.int32)[None]
    emits = logB[:, y].T  # (T, K)
    nodes = build_tree(T)

    iotaK = jnp.arange(K, dtype=jnp.int32)
    # subset-uniform prior for unforced segments (reference :303-307).
    # The oracle computes log(1/ksub) in float64 then truncates; a traced
    # f32 log can differ by 1 ulp and flip exact argmax ties, so use a
    # host-side f64->f32 table indexed by subset size (depends only on K)
    unif_tab = jnp.asarray(
        np.log(1.0 / np.arange(1, K + 1, dtype=np.float64)).astype(np.float32))
    # traced per-node state
    masks: dict[int, jax.Array] = {0: jnp.ones((K,), jnp.float32)}
    inits: dict[int, jax.Array] = {0: jnp.asarray(-1, jnp.int32)}
    lasts: dict[int, jax.Array] = {0: jnp.asarray(-1, jnp.int32)}
    pairs_x: dict[int, jax.Array] = {}
    pairs_y: dict[int, jax.Array] = {}

    max_depth = max(n.depth for n in nodes)
    for depth in range(max_depth + 1):
        level = [n for n in nodes if n.depth == depth]
        for length in sorted({n.length for n in level}):
            group = [n for n in level if n.length == length]
            S = len(group)
            mask = jnp.stack([masks[n.idx] for n in group])  # (S, K) 0/1
            init = jnp.stack([inits[n.idx] for n in group])  # (S,)
            last_f = jnp.stack([lasts[n.idx] for n in group])
            starts = np.asarray([n.start for n in group])

            # masked emissions for this group's time windows
            idx = jnp.asarray(starts[:, None] + np.arange(length)[None, :])
            seg_emits = emits[idx]  # (S, length, K)
            pen = jnp.where(mask > 0, 0.0, NEG)  # (S, K)
            seg_emits = seg_emits + pen[:, None, :]

            ksub = jnp.maximum(jnp.sum(mask, axis=1), 1.0)
            log_unif = unif_tab[ksub.astype(jnp.int32) - 1]
            root_pi = logPi[None, :] if depth == 0 else log_unif[:, None]
            forced0 = jnp.where(iotaK[None, :] == init[:, None], 0.0, NEG)
            d0 = jnp.where((init >= 0)[:, None], forced0, root_pi) + seg_emits[:, 0]

            emitsN = jnp.transpose(seg_emits[:, 1:, :], (1, 0, 2))  # (L-1, S, K)
            def stepf(d, e):
                val, arg = mp.maxplus_lanes(d, logA)
                return val + e, arg

            dfin, ptrs = jax.lax.scan(stepf, d0, emitsN)

            mid = length // 2
            px, py = _planes_from_ptrs(ptrs, mid)
            last = jnp.where(last_f >= 0, last_f,
                             jnp.argmax(jnp.where(mask > 0, dfin, NEG),
                                        axis=1).astype(jnp.int32))
            x_a = jnp.take_along_axis(px, last[:, None], axis=1)[:, 0]
            x_b = jnp.take_along_axis(py, last[:, None], axis=1)[:, 0]

            n_left = length // 2
            n_right = length - n_left
            onehot_a = jax.nn.one_hot(x_a, K, dtype=jnp.float32)
            onehot_b = jax.nn.one_hot(x_b, K, dtype=jnp.float32)
            if any(n.left >= 0 for n in group):
                if prune:
                    lmask = _bfs_masks(jnp.transpose(A_posF), onehot_a, mask,
                                       n_left - 1)
                    lmask = jnp.maximum(lmask, onehot_a)
                else:
                    lmask = mask
            if any(n.right >= 0 for n in group):
                if prune:
                    rmask = _bfs_masks(A_posF, onehot_b, mask, n_right - 1)
                    rmask = jnp.maximum(rmask, onehot_b)
                else:
                    rmask = mask

            for s, n in enumerate(group):
                pairs_x[n.idx] = x_a[s]
                pairs_y[n.idx] = x_b[s]
                if n.left >= 0:
                    masks[n.left] = lmask[s]
                    inits[n.left] = init[s]  # left child keeps parent's entry
                    lasts[n.left] = x_a[s]
                if n.right >= 0:
                    masks[n.right] = rmask[s]
                    inits[n.right] = x_b[s]
                    lasts[n.right] = jnp.asarray(-1, jnp.int32)  # quirk :452

    # static flattening
    by_inorder = sorted(nodes, key=lambda n: n.inorder)
    xs = jnp.stack([pairs_x[n.idx] for n in by_inorder])
    ys_ = jnp.stack([pairs_y[n.idx] for n in by_inorder])
    out_spec = flatten_positions(nodes, T)
    sel = jnp.asarray([pi for pi, _ in out_spec], jnp.int32)
    which = jnp.asarray([w for _, w in out_spec], jnp.int32)
    vals = jnp.where(which == 0, xs[sel], ys_[sel])
    out = jnp.zeros((T,), jnp.int32)
    return out.at[: len(out_spec)].set(vals.astype(jnp.int32))


# ---------------------------------------------------------------------------
# SIEVE-BS-Mp: beam-pruned fixed-median D&C
# ---------------------------------------------------------------------------

def sieve_bs_mp_decode(logA, logB_raw, logPi, y, A_posF, beam_width: int):
    """SIEVE-BS-Mp (``sieve_beam_search.py:351-501`` /
    ``SIEVE-BS-Mp.c``): fixed-median D&C with static top-B beam pruning,
    on the same static level-batched tree as :func:`sieve_mp_decode`.

    Reference semantics kept: only out-edges of the current token set
    relax (states with no in-edge from the beam drop out); emission misses
    contribute 0 (``B==0`` dict fallthrough, :405-409); the beam is the
    top-``min(B, #touched)`` of touched states; the median-step beam
    becomes the right child's token set; left children inherit the
    parent's tokens; left children force ``last=x_a``, right children
    inherit the parent's ``last`` (:496).

    Documented deltas vs the float64 reference (both fp-tie classes —
    ``oracle.framework.sieve_bs_mp`` is the bit-exact fp32 yardstick):
    (a) exact-tie resolution is lowest state index / beam rank instead of
    the reference's dict-insertion order; (b) *permuted-path ties* —
    cyclic paths traversing the same edge multiset in a different order
    under repeated observation symbols score mathematically equal; the
    f64 reference sees an exact tie (first-inserted wins) while the fp32
    sums, accumulated in different orders, round APART, silently picking
    the other path of the tie class.

    Cost shape: only each segment's FIRST step (whose token set can exceed
    the beam, e.g. the root's full K) runs a dense max-plus (the shared
    lane step, ``ops.maxplus.maxplus_lanes``); every later step gathers the B beam rows of ``logA``
    and runs in O(S*B*K) — which is what makes headline-K (3965+) decoding
    possible.

    Returns the flattened in-order pair path ``[p0.x, p0.y, p1.y, ...]``
    (the reference's pretty_print_path layout), -1 where a segment's
    median pair was never set.
    """
    T = int(y.shape[0])
    K = logA.shape[0]
    B = min(int(beam_width), K)
    if T == 1:
        d0 = logPi + logB_raw[:, y[0]]
        return jnp.argmax(d0).astype(jnp.int32)[None]

    # miss-as-zero emission table (reference acoustic dict fallthrough)
    emitQ = jnp.where(logB_raw > NEG, logB_raw, 0.0)  # (K, M)
    iota = jnp.arange(K, dtype=jnp.int32)
    NEGBIG = jnp.float32(-3.0e38)
    nodes = build_tree(T)

    masks: dict[int, jax.Array] = {0: jnp.ones((K,), jnp.float32)}
    tokens: dict[int, jax.Array | None] = {0: jnp.ones((K,), jnp.float32)}
    lasts: dict[int, jax.Array] = {0: jnp.asarray(-2, jnp.int32)}  # -2 = argmax
    pairs_x: dict[int, jax.Array] = {}
    pairs_y: dict[int, jax.Array] = {}

    def _select_beam(touched, newT1):
        """(top_idx (S,B), eff (S,), token mask (S,K)) of the touched top-B.

        The reference beam is ``nlargest`` over the *touched dict only* —
        a touched key whose score is still -inf IS in the dict (the
        ``setdefault`` comparison inserts it) and outranks every untouched
        state.  Two sentinels keep that order under dense top_k (same
        scheme as ``sieve_bs._beam_vals``): touched -inf -> -2e38, above
        untouched -> -3e38, so no untouched state can displace a touched
        one inside the eff = min(B, #touched) kept slots.
        """
        S = touched.shape[0]
        eff = jnp.minimum(B, jnp.sum(touched, axis=1))
        vals = jnp.where(touched,
                         jnp.where(jnp.isneginf(newT1),
                                   jnp.float32(-2.0e38), newT1),
                         NEGBIG)
        _, top_idx = jax.lax.top_k(vals, B)
        slot_ok = jnp.arange(B)[None, :] < eff[:, None]
        tokm = jnp.zeros_like(touched, jnp.float32).at[
            jnp.arange(S)[:, None], top_idx
        ].max(jnp.where(slot_ok, 1.0, 0.0))
        return top_idx, eff, tokm

    def run_group(group):
        S = len(group)
        length = group[0].length
        th = length // 2
        mask = jnp.stack([masks[n.idx] for n in group])  # (S, K)
        cur = jnp.stack([tokens[n.idx] for n in group])  # (S, K)
        last_f = jnp.stack([lasts[n.idx] for n in group])
        starts = jnp.asarray([n.start for n in group])

        sym0 = y[starts]  # (S,)
        # model Pi at every node — the C binary's convention
        # (SIEVE-BS-Mp.c:332: log(vit->Pi[i]) re-applied per recursion);
        # the Python chain instead threads Baseline.py's uniform log(1/K)
        # (:493 Pi=Pi), identical on all reference fixtures (Pi IS uniform
        # there).  We follow the C binary, like sieve_bs.
        T1 = jnp.where(mask > 0,
                       logPi[None, :] + emitQ[:, sym0].T, NEG)

        # --- step j=1: dense (the token set may exceed B) ---------------
        T1m = jnp.where(cur > 0, T1, NEG)
        val1, win1 = mp.maxplus_lanes(T1m, logA)
        touched = jnp.logical_and((cur @ A_posF) > 0, mask > 0)
        sym1 = y[starts + 1]
        T1 = jnp.where(touched, val1 + emitQ[:, sym1].T, NEG)

        # median planes mirror the reference's per-step ``new_middlepath``
        # dict, which is REBUILT every step: a destination that wins no
        # candidate this step has no entry, so inheriting from it later
        # must read (-1, -1) — non-winners are reset, never carried over
        won1 = jnp.logical_and(touched, val1 > NEG)
        if th == 1:
            px = jnp.where(won1, win1, -1)
            py = jnp.where(won1, jnp.broadcast_to(iota[None, :], (S, K)), -1)
        else:
            px = jnp.full((S, K), -1, jnp.int32)
            py = jnp.full((S, K), -1, jnp.int32)
        tok_idx, eff, tokm = _select_beam(touched, T1)
        mid_beam = tokm if th == 1 else cur

        # --- steps j>=2: beam-space gathered rows, O(S*B*K) -------------
        def step(carry, j):
            T1, px, py, mid_beam, tok_idx, eff, tokm = carry
            sym = y[starts + j]
            rows = logA[tok_idx]  # (S, B, K)
            t1tok = jnp.take_along_axis(T1, tok_idx, axis=1)  # (S, B)
            valid = jnp.arange(B)[None, :] < eff[:, None]
            t1tok = jnp.where(valid, t1tok, NEG)
            scores = t1tok[:, :, None] + rows  # (S, B, K)
            val = jnp.max(scores, axis=1)
            slot = jnp.argmax(scores, axis=1).astype(jnp.int32)
            win = jnp.take_along_axis(tok_idx, slot, axis=1)  # global sources
            touched = jnp.logical_and((tokm @ A_posF) > 0, mask > 0)
            newT1 = jnp.where(touched, val + emitQ[:, sym].T, NEG)

            rec = j == th
            px_rec = jnp.where(rec, win, jnp.take_along_axis(px, win, axis=1))
            py_rec = jnp.where(rec, jnp.broadcast_to(iota[None, :], (S, K)),
                               jnp.take_along_axis(py, win, axis=1))
            # per-step dict-rebuild semantics: only this step's winners
            # carry a pair forward; everyone else resets to the
            # defaultdict's (-1, -1) (sieve_beam_search.py:394,425)
            won = jnp.logical_and(touched, val > NEG)
            prop = j >= th
            px = jnp.where(prop, jnp.where(won, px_rec, -1), px)
            py = jnp.where(prop, jnp.where(won, py_rec, -1), py)

            ntok_idx, neff, ntokm = _select_beam(touched, newT1)
            mid_beam = jnp.where(rec, ntokm, mid_beam)
            return (newT1, px, py, mid_beam, ntok_idx, neff, ntokm), None

        if length > 2:
            (T1, px, py, mid_beam, tok_idx, eff, tokm), _ = jax.lax.scan(
                step, (T1, px, py, mid_beam, tok_idx, eff, tokm),
                jnp.arange(2, length))

        argm = jnp.argmax(jnp.where(mask > 0, T1, NEG), axis=1).astype(jnp.int32)
        last = jnp.where(last_f > -2, last_f, argm)
        safe = jnp.clip(last, 0, K - 1)
        x_a = jnp.where(last >= 0,
                        jnp.take_along_axis(px, safe[:, None], axis=1)[:, 0], -1)
        x_b = jnp.where(last >= 0,
                        jnp.take_along_axis(py, safe[:, None], axis=1)[:, 0], -1)
        return x_a, x_b, mid_beam, last

    max_depth = max(n.depth for n in nodes)
    for depth in range(max_depth + 1):
        level = [n for n in nodes if n.depth == depth]
        for length in sorted({n.length for n in level}):
            group = [n for n in level if n.length == length]
            x_a, x_b, mid_beam, last = run_group(group)
            n_left = length // 2
            n_right = length - n_left
            safe_a = jnp.maximum(x_a, 0)
            safe_b = jnp.maximum(x_b, 0)
            onehot_a = jax.nn.one_hot(safe_a, K, dtype=jnp.float32)
            onehot_b = jax.nn.one_hot(safe_b, K, dtype=jnp.float32)
            mask = jnp.stack([masks[n.idx] for n in group])
            if any(n.left >= 0 for n in group):
                # BFS bound is N_left hops w/ depth-from-1 counting ==
                # <= N_left-1 edges (single_node_ancestors :545-588)
                lmask = _bfs_masks(jnp.transpose(A_posF), onehot_a,
                                   jnp.ones_like(mask), n_left - 1)
                lmask = jnp.maximum(lmask, onehot_a)
            if any(n.right >= 0 for n in group):
                rmask = _bfs_masks(A_posF, onehot_b, jnp.ones_like(mask),
                                   n_right - 1)
                rmask = jnp.maximum(rmask, onehot_b)
            for s, n in enumerate(group):
                pairs_x[n.idx] = x_a[s]
                pairs_y[n.idx] = x_b[s]
                if n.left >= 0:
                    masks[n.left] = lmask[s]
                    tokens[n.left] = tokens[n.idx]  # parent's tokens thread
                    lasts[n.left] = x_a[s]
                if n.right >= 0:
                    masks[n.right] = rmask[s]
                    tokens[n.right] = mid_beam[s]
                    lasts[n.right] = last[s]  # parent's computed last (:496)

    by_inorder = sorted(nodes, key=lambda n: n.inorder)
    xs = jnp.stack([pairs_x[n.idx] for n in by_inorder])
    ys_ = jnp.stack([pairs_y[n.idx] for n in by_inorder])
    # pretty_print_path layout: p0.x, p0.y, then .y of each later pair
    flat = jnp.concatenate([xs[:1], ys_[:1], ys_[1:]])[:T]
    out = jnp.full((T,), -1, jnp.int32)
    return out.at[: flat.shape[0]].set(flat.astype(jnp.int32))


@register("sieve_bs_mp")
def _build_bs_mp(beam_width: int = 64, **static) -> Decoder:
    def fn(logA, logB, logPi, y):
        A_posF = (logA > NEG).astype(jnp.float32)
        return sieve_bs_mp_decode(logA, logB, logPi, y, A_posF,
                                  beam_width=beam_width)

    return Decoder("sieve_bs_mp", fn, {"beam_width": beam_width, **static},
                   lambda K, T, **_: T * beam_width * 8 + 4 * K * 4)


def _memory(K: int, T: int, **_) -> int:
    # per level: group pointer tables + masks + planes (dominant term: the
    # longest level's (T, K) pointer rows)
    return T * K * 4 + 4 * K * 4 + K * K * 4


@register("sieve_mp")
def _build(prune: bool = True, **static) -> Decoder:
    def fn(logA, logB, logPi, y):
        A_posF = (logA > NEG).astype(jnp.float32)
        return sieve_mp_decode(logA, logB, logPi, y, A_posF, prune=prune)

    return Decoder("sieve_mp", fn, {"prune": prune, **static}, _memory)

"""SIEVE (dynamic median) and SIEVE-DAG on the device.

These are the two reference algorithms that exist only as Python originals
(no C ports): ``Sieve.sieve`` (dynamic median selection,
``Base_line/Python implementations/Viterbi.py:529-681``) and
``Sieve.sieve_dag`` (DAG-structured HMMs, ``Viterbi.py:994-1152`` with the
topological preprocessing ``:850-990``).  Both recurse over a
*data-dependent* split: the forward pass tracks, per end state, the best
transition ``(x_a, x_b, t)`` seen so far — the one minimizing
``max(#ancestors(x_a), #descendants(x_b))`` (first strictly smaller wins,
no closeness tie-break — unlike SIEVE-BS) — then BFS-prunes each half and
recurses.

Decomposition (same shape as ``algorithms.sieve_bs``):

* **The ENTIRE recursion tree runs on device in one dispatch**
  (:func:`_device_recursion_dyn`, ``engine="device"``, the default):
  node stack in a ``lax.while_loop``, exact-length forward
  passes, subgraph-restricted BFS prunes as early-exit frontier
  matvecs, host-exact f32 subset-uniform priors from a log table, one
  readback at the end.  The host-driven level scheduler (kept under
  ``engine="host"``) pays one host sync per level across serial-chain
  trees.
* Each node's forward pass is a dense masked scan: the median carry
  ``(mx, my, mn, mval)`` is vectorized over all K destinations; the
  sequential per-destination update of the original
  (``Viterbi.py:602-636``) depends only on the argmax predecessor, so a
  dense masked argmax with lowest-active-index tie-breaking reproduces it
  exactly (including the all-(-inf) case, where ``np.argmax`` over the
  compacted subproblem picks the lowest *active* state).
* **Neighborhood counts on device** as simultaneous BFS frontier advances
  (dense matmuls): SIEVE uses one global ``<= b``-hop count per state
  (``b = floor(log2 K)``, ``Viterbi.py:476-526``); SIEVE-DAG *recomputes*
  per-node counts over the index-restricted subgraph with ``T_seg - 1``
  hops (the topological accumulation of ``:850-988`` equals BFS
  reachability counting on a DAG — and BFS also terminates on cyclic
  inputs where the reference's topological sweep would spin).

Reference quirks kept: subproblem priors are uniform over the *active
subset* unless an ``initial_state`` is forced (a module-level mutable in
the original — left children inherit the nearest right-ancestor's forced
state, reproduced by threading the same mutable through the in-order
recursion); forced entry states use a one-hot prior (log 0 = -inf
elsewhere); a node whose median was never set returns silently.

Documented delta (same policy as ``sieve_bs``): scores are fp32 here vs
the reference's float64 — identical decisions off exact fp ties; count
comparisons are integer-exact in both.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from .base import Decoder, register
from .sieve import NEG
from .sieve_bs import _bhop_counts, _host_bfs


def _bfs_masks_capped(adjF, frontier0, parent_mask, max_hops: int, n_hops):
    """`_bfs_masks` with a traced hop count ``n_hops`` under a static bound
    ``max_hops`` (lets the host bucket compiled programs by length)."""
    visited = jnp.zeros_like(frontier0)

    def step(carry, h):
        visited, frontier = carry
        reach = (frontier @ adjF) > 0
        new = jnp.logical_and(reach, visited == 0).astype(frontier0.dtype)
        new = new * parent_mask * (h < n_hops).astype(frontier0.dtype)
        return (jnp.maximum(visited, new), new), None

    (visited, _), _ = jax.lax.scan(step, (visited, frontier0),
                                   jnp.arange(max_hops))
    return visited


@partial(jax.jit, static_argnames=("max_hops",))
def _dag_counts(A_posF, mask, max_hops: int, n_hops):
    """Per-node (ancestors, descendants) counts over the index-restricted
    subgraph, <= n_hops edge hops (sieve_dag's per-level preprocessing)."""
    K = A_posF.shape[0]
    adj = A_posF * (mask[:, None] * mask[None, :])
    eye = jnp.eye(K, dtype=jnp.float32) * mask[:, None]
    desc = _bfs_masks_capped(adj, eye, mask, max_hops, n_hops).sum(axis=1)
    anc = _bfs_masks_capped(jnp.transpose(adj), eye, mask, max_hops,
                            n_hops).sum(axis=1)
    return anc.astype(jnp.float32), desc.astype(jnp.float32)


def _node_forward_dyn_impl(logA, logB, anc_cnt, desc_cnt, y_seg, n_valid,
                           mask, pi_vec, last_forced):
    """One recursion node: masked forward pass + dynamic-median carry.

    Mirrors ``oracle.sieve.sieve_dynamic``'s inner loop (Viterbi.py:570-636)
    over global state indices: ``scores = (T1[:,None] + logA) + emit`` with
    -inf outside the active subset, argmax per destination with
    lowest-active-index ties, median update gated on
    ``cand < prev_val[arg]`` else inheritance if the source has a median.

    ``y_seg`` may be padded past the true segment length ``n_valid`` (the
    host buckets lengths to powers of two so the recursion compiles
    O(log T) programs, not one per distinct length); padded steps pass the
    carry through unchanged.

    Returns (x_a, x_b, n_left, last) scalars; x_a == -1 means the node's
    median was never set (the oracle's early return).
    """
    L = y_seg.shape[0]
    K = logA.shape[0]
    iota = jnp.arange(K, dtype=jnp.int32)
    active = mask > 0
    pair_mask = active[:, None] & active[None, :]
    emits = jnp.transpose(logB[:, y_seg])  # (L, K)

    T1 = jnp.where(active, pi_vec + emits[0], NEG)

    def step(carry, x):
        T1, mx, my, mn, mval = carry
        j, emit_row = x
        valid = j < n_valid
        scores = (T1[:, None] + logA) + emit_row[None, :]
        scores = jnp.where(jnp.isnan(scores), NEG, scores)
        scores = jnp.where(pair_mask, scores, NEG)
        best = jnp.max(scores, axis=0)
        win = (scores == best[None, :]) & active[:, None]
        arg = jnp.min(jnp.where(win, iota[:, None], K), axis=0).astype(jnp.int32)
        cand = jnp.maximum(anc_cnt[arg], desc_cnt)
        pv = mval[arg]
        take_new = cand < pv
        inh = jnp.logical_and(~take_new, mx[arg] != -1)
        nmx = jnp.where(take_new, arg, jnp.where(inh, mx[arg], -1))
        nmy = jnp.where(take_new, iota, jnp.where(inh, my[arg], -1))
        nmn = jnp.where(take_new, j, jnp.where(inh, mn[arg], -1)).astype(jnp.int32)
        nmval = jnp.where(take_new, cand, jnp.where(inh, pv, jnp.inf))
        return (jnp.where(valid, best, T1),
                jnp.where(valid, nmx, mx), jnp.where(valid, nmy, my),
                jnp.where(valid, nmn, mn), jnp.where(valid, nmval, mval)), None

    init = (T1, jnp.full((K,), -1, jnp.int32), jnp.full((K,), -1, jnp.int32),
            jnp.full((K,), -1, jnp.int32), jnp.full((K,), jnp.inf, jnp.float32))
    (T1, mx, my, mn, mval), _ = jax.lax.scan(
        step, init, (jnp.arange(1, L, dtype=jnp.int32), emits[1:]))

    bestT = jnp.max(jnp.where(active, T1, NEG))
    last_arg = jnp.min(jnp.where((T1 == bestT) & active, iota, K)).astype(jnp.int32)
    last = jnp.where(last_forced >= 0, last_forced, last_arg)
    return mx[last], my[last], mn[last], last


_node_forward_dyn = jax.jit(_node_forward_dyn_impl)

# level-batched dispatch (same scheme as algorithms.sieve_bs._LANES): all
# ready nodes of a length bucket forward in fixed-width vmapped lanes —
# a host sync per dispatch makes one-call-per-node the dominant cost of
# host-driven recursion at T>=128
_LANES = 8


@jax.jit
def _node_forward_dyn_lanes(logA, logB, anc_g, desc_g, y_segs, n_valids,
                            masks, pi_vecs, last_forceds):
    """Lanes share the global b-hop counts (SIEVE)."""
    return jax.vmap(
        lambda ys, nv, mk, pv, lf: _node_forward_dyn_impl(
            logA, logB, anc_g, desc_g, ys, nv, mk, pv, lf)
    )(y_segs, n_valids, masks, pi_vecs, last_forceds)


@partial(jax.jit, static_argnames=("max_hops",))
def _node_forward_dag_lanes(logA, logB, A_posF, y_segs, n_valids, masks,
                            pi_vecs, last_forceds, max_hops: int):
    """Each lane recomputes its subgraph-restricted counts (SIEVE-DAG)."""
    K = logA.shape[0]

    def one(ys, nv, mk, pv, lf):
        anc, desc = _dag_counts(A_posF, mk, max_hops=max_hops,
                                n_hops=jnp.minimum(nv - 1, K))
        return _node_forward_dyn_impl(logA, logB, anc, desc, ys, nv, mk,
                                      pv, lf)

    return jax.vmap(one)(y_segs, n_valids, masks, pi_vecs, last_forceds)


@partial(jax.jit, static_argnames=("dag",))
def _device_recursion_dyn(logA, logB, A_posF, A_posT, anc_g, desc_g,
                          logu_table, y, root_mask, dag: bool):
    """The ENTIRE SIEVE / SIEVE-DAG recursion tree in one device dispatch.

    Same scheme as ``sieve_bs._device_recursion`` (see its docstring):
    an explicit node stack in a
    ``lax.while_loop``; each node runs the dense masked forward pass of
    :func:`_node_forward_dyn_impl` (exact lengths, no bucketing pad),
    then the children's subgraph-restricted BFS prunes; one readback at
    the end.  ``dag=True`` recomputes per-node (ancestor, descendant)
    counts over the index-restricted subgraph before the forward pass
    (``_dag_counts`` semantics, early-exit while_loop).

    ``logu_table[k] = float32(log(1/k))`` precomputed on host so the
    subset-uniform prior is bit-identical to the host scheduler's
    ``np.float32(np.log(1.0 / k_sub))``.
    """
    K = logA.shape[0]
    T = y.shape[0]
    C = max(int(T), 1)
    iota = jnp.arange(K, dtype=jnp.int32)
    NEGj = jnp.float32(-jnp.inf)

    def bfs_sub(adjF, src, hops, maskf):
        """Visited-gated BFS restricted to the node's subset
        (== ``_host_bfs`` over ``adj & outer(mask, mask)``)."""
        def cond(c):
            h, vis, fr, alive = c
            return alive & (h < hops)

        def body(c):
            h, vis, fr, alive = c
            nxt = (((fr.astype(jnp.float32) * maskf) @ adjF) > 0) \
                & (maskf > 0) & (~vis)
            return (h + 1, vis | nxt, nxt, jnp.any(nxt))

        _, vis, _, _ = jax.lax.while_loop(
            cond, body, (jnp.int32(0), jnp.zeros((K,), jnp.bool_),
                         iota == src, jnp.bool_(True)))
        return vis

    def dag_counts(maskf, n_hops):
        """Per-node subgraph counts: K simultaneous frontier advances
        (== ``_dag_counts`` with early exit on an empty frontier)."""
        pair = maskf[:, None] * maskf[None, :]
        adj = A_posF * pair
        adjT = A_posT * pair.T

        def run(a):
            def cond(c):
                h, vis, fr, alive = c
                return alive & (h < n_hops)

            def body(c):
                h, vis, fr, alive = c
                new = ((fr @ a) > 0) & (~vis) & (maskf > 0)[None, :]
                return (h + 1, vis | new, new.astype(jnp.float32),
                        jnp.any(new))

            f0 = jnp.eye(K, dtype=jnp.float32) * maskf[:, None]
            _, vis, _, _ = jax.lax.while_loop(
                cond, body,
                (jnp.int32(0), jnp.zeros((K, K), jnp.bool_), f0,
                 jnp.bool_(True)))
            return vis.sum(axis=1).astype(jnp.float32)

        return run(adjT), run(adj)  # (ancestors, descendants)

    def process(state):
        (stack, sp, count, masks, lo_a, ln_a, lastf, inits, kind,
         pa, pb, lch, rch) = state
        nid = stack[sp - 1]
        sp = sp - jnp.int32(1)
        mask = masks[nid]
        maskf = mask.astype(jnp.float32)
        lo = lo_a[nid]
        L = ln_a[nid]
        msum = jnp.sum(mask.astype(jnp.int32))

        def fwd(op):
            (stack, sp, count, masks, lo_a, ln_a, lastf, inits, kind,
             pa, pb, lch, rch) = op
            if dag:
                anc_cnt, desc_cnt = dag_counts(
                    maskf, jnp.minimum(L - 1, K))
            else:
                anc_cnt, desc_cnt = anc_g, desc_g
            init = inits[nid]
            pi_vec = jnp.where(init == -1, logu_table[msum],
                               jnp.where(iota == init, 0.0, NEGj))
            T1 = jnp.where(mask, pi_vec + logB[:, y[lo]], NEGj)
            pair_mask = mask[:, None] & mask[None, :]

            def tbody(c):
                j, T1, mx, my, mn, mval = c
                emit_row = logB[:, y[lo + j]]
                scores = (T1[:, None] + logA) + emit_row[None, :]
                scores = jnp.where(jnp.isnan(scores), NEGj, scores)
                scores = jnp.where(pair_mask, scores, NEGj)
                best = jnp.max(scores, axis=0)
                win = (scores == best[None, :]) & mask[:, None]
                arg = jnp.min(jnp.where(win, iota[:, None], K),
                              axis=0).astype(jnp.int32)
                cand = jnp.maximum(anc_cnt[arg], desc_cnt)
                pv = mval[arg]
                take_new = cand < pv
                inh = jnp.logical_and(~take_new, mx[arg] != -1)
                nmx = jnp.where(take_new, arg, jnp.where(inh, mx[arg], -1))
                nmy = jnp.where(take_new, iota, jnp.where(inh, my[arg], -1))
                nmn = jnp.where(take_new, j,
                                jnp.where(inh, mn[arg], -1)).astype(jnp.int32)
                nmval = jnp.where(take_new, cand,
                                  jnp.where(inh, pv, jnp.inf))
                return (j + 1, best, nmx.astype(jnp.int32),
                        nmy.astype(jnp.int32), nmn, nmval)

            (_, T1, mx, my, mn, mval) = jax.lax.while_loop(
                lambda c: c[0] < L, tbody,
                (jnp.int32(1), T1, jnp.full((K,), -1, jnp.int32),
                 jnp.full((K,), -1, jnp.int32),
                 jnp.full((K,), -1, jnp.int32),
                 jnp.full((K,), jnp.inf, jnp.float32)))

            bestT = jnp.max(jnp.where(mask, T1, NEGj))
            last_arg = jnp.min(jnp.where((T1 == bestT) & mask, iota,
                                         K)).astype(jnp.int32)
            lf = lastf[nid]
            last = jnp.where(lf >= 0, lf, last_arg)
            x_a, x_b, n_left = mx[last], my[last], mn[last]
            ok = x_a != -1  # median never set: the oracle's early return
            kind = kind.at[nid].set(jnp.where(ok, 1, 3))
            pa = pa.at[nid].set(x_a)
            pb = pb.at[nid].set(x_b)

            # left child: subgraph ancestors of x_a; inherit parent init
            spawn_l = ok & (n_left > 1)
            lmask = bfs_sub(A_posT, x_a, n_left - 1, maskf) | (iota == x_a)
            cid = count
            masks = masks.at[cid].set(lmask)
            lo_a = lo_a.at[cid].set(lo)
            ln_a = ln_a.at[cid].set(n_left)
            lastf = lastf.at[cid].set(x_a)
            inits = inits.at[cid].set(inits[nid])
            stack = stack.at[sp].set(cid)
            dl = spawn_l.astype(jnp.int32)
            lch = lch.at[nid].set(jnp.where(spawn_l, cid, -1))
            sp2, count2 = sp + dl, count + dl

            # right child: subgraph descendants of x_b; forced init=x_b,
            # end state re-picked by argmax (last=-1)
            n_right = L - n_left
            spawn_r = ok & (n_right > 1)
            rmask = bfs_sub(A_posF, x_b, n_right - 1, maskf) | (iota == x_b)
            cid2 = count2
            masks = masks.at[cid2].set(rmask)
            lo_a = lo_a.at[cid2].set(lo + n_left)
            ln_a = ln_a.at[cid2].set(n_right)
            lastf = lastf.at[cid2].set(-1)
            inits = inits.at[cid2].set(x_b)
            stack = stack.at[sp2].set(cid2)
            dr = spawn_r.astype(jnp.int32)
            rch = rch.at[nid].set(jnp.where(spawn_r, cid2, -1))
            return (stack, sp2 + dr, count2 + dr, masks, lo_a, ln_a,
                    lastf, inits, kind, pa, pb, lch, rch)

        kind = kind.at[nid].set(3)  # overwritten by fwd when it runs
        op = (stack, sp, count, masks, lo_a, ln_a, lastf, inits, kind,
              pa, pb, lch, rch)
        return jax.lax.cond((msum > 1) & (L > 1), fwd, lambda o: o, op)

    state = (jnp.zeros((C,), jnp.int32),          # stack ([0])
             jnp.int32(1), jnp.int32(1),          # sp, count
             jnp.zeros((C, K), jnp.bool_).at[0].set(root_mask > 0),
             jnp.zeros((C,), jnp.int32),          # lo
             jnp.zeros((C,), jnp.int32).at[0].set(T),
             jnp.full((C,), -1, jnp.int32),       # last forced
             jnp.full((C,), -1, jnp.int32),       # init (-1 = uniform)
             jnp.zeros((C,), jnp.int32),          # kind
             jnp.full((C,), -1, jnp.int32),       # pair a
             jnp.full((C,), -1, jnp.int32),       # pair b
             jnp.full((C,), -1, jnp.int32),       # left child
             jnp.full((C,), -1, jnp.int32))       # right child
    out = jax.lax.while_loop(lambda s: s[1] > 0, process, state)
    return out[8], out[9], out[10], out[11], out[12]


def sieve_dynamic_decode(logA, logB, logPi, y, b_hops: int | None = None,
                         dag: bool = False) -> list[tuple[int, int]]:
    """Full SIEVE (dynamic median) / SIEVE-DAG decode; returns the in-order
    median-pair list (matches ``oracle.sieve.sieve_dynamic`` /
    ``oracle.sieve.sieve_dag`` off exact fp ties).
    """
    return sieve_dynamic_decode_many(logA, logB, logPi, np.asarray(y)[None],
                                     b_hops=b_hops, dag=dag)[0]


def sieve_dynamic_decode_many(logA, logB, logPi, ys,
                              b_hops: int | None = None,
                              dag: bool = False,
                              engine: str = "device"
                              ) -> list[list[tuple[int, int]]]:
    """SIEVE / SIEVE-DAG over a batch of sequences with one shared lane
    scheduler — all trees feed the same level queue, so the 8-lane
    dispatches fill across the batch even though each dynamic-median tree
    is typically a serial chain (no closeness tie-break pulls splits to
    the middle).  Per-sequence results identical to one-at-a-time."""
    logA_np = np.asarray(logA)
    logB_np = np.asarray(logB)
    K = logA_np.shape[0]
    ys_np = np.asarray(ys)
    S, _T = ys_np.shape

    # logical (non-padding) states: padded states are all -inf everywhere
    real = (np.isfinite(logA_np).any(axis=1) | np.isfinite(logB_np).any(axis=1)
            | np.isfinite(np.asarray(logPi)))
    A_pos_np = np.isfinite(logA_np)
    A_posF = jnp.asarray(A_pos_np, jnp.float32)
    logA_d = jnp.asarray(logA)
    logB_d = jnp.asarray(logB)

    if not dag:
        b = (max(1, int(np.floor(np.log2(max(2, int(real.sum()))))))
             if b_hops is None else int(b_hops))
        anc_g, desc_g = _bhop_counts(A_posF, hops=b)
    else:
        anc_g = desc_g = jnp.zeros((K,), jnp.float32)  # engine recomputes

    if engine == "device":
        A_posT = jnp.transpose(A_posF)
        # host-exact subset-uniform priors: float32(log(1/k_sub))
        with np.errstate(divide="ignore"):
            logu = np.log(1.0 / np.maximum(np.arange(K + 1), 1)
                          ).astype(np.float32)
        logu_d = jnp.asarray(logu)
        real_f = jnp.asarray(real.astype(np.float32))
        outs = [_device_recursion_dyn(logA_d, logB_d, A_posF, A_posT,
                                      anc_g, desc_g, logu_d,
                                      jnp.asarray(ys_np[s]), real_f,
                                      dag=dag)
                for s in range(S)]  # issue all, then read back once
        from .sieve_bs import _flatten_device_tree
        return [_flatten_device_tree(*map(np.asarray, o)) for o in outs]

    # Level-batched host recursion (same scheme as algorithms.sieve_bs):
    # sibling subtrees are independent once the parent's split is known.
    # The original's module-level ``initial_state`` mutable reduces to a
    # static edge rule — at forward time a node sees the x_b of its
    # nearest ancestor reached by one right edge then only left edges
    # (right children get the parent's x_b; left children inherit the
    # parent's own incoming value, since the parent assigns only before
    # its right recursion) — so each child's prior is known at enqueue
    # time and whole levels can forward together.
    iota = np.arange(K)
    nodes: list[dict] = []

    def new_node(mask_np, y_seg, last, init):
        nodes.append({"mask": mask_np, "y": y_seg, "last": last,
                      "init": init, "kind": None, "pair": None,
                      "left": None, "right": None})
        return len(nodes) - 1

    roots = [new_node(np.asarray(real, bool), ys_np[s], None, None)
             for s in range(S)]
    level = list(roots)
    while level:
        buckets: dict[int, list[int]] = {}
        for nid in level:
            nd = nodes[nid]
            if nd["mask"].sum() <= 1:
                nd["kind"] = "skip"
                continue
            nd["kind"] = "forward"
            L = len(nd["y"])
            Lp = 1 << max(1, (L - 1)).bit_length() if L > 2 else L
            buckets.setdefault(Lp, []).append(nid)

        nxt: list[int] = []
        # issue every lane-chunk of the level WITHOUT syncing, then read
        # back once per level (a dispatch sync is otherwise paid per chunk
        # — same scheme as algorithms.sieve_bs)
        pending = []
        for Lp, grp in sorted(buckets.items()):
            for g0 in range(0, len(grp), _LANES):
                chunk = grp[g0:g0 + _LANES]
                n = len(chunk)
                ys = np.zeros((_LANES, Lp), np.int32)
                ns = np.zeros((_LANES,), np.int32)
                ms = np.zeros((_LANES, K), np.float32)
                pis = np.zeros((_LANES, K), np.float32)
                lf = np.full((_LANES,), -1, np.int32)
                for i, nid in enumerate(chunk):
                    nd = nodes[nid]
                    L = len(nd["y"])
                    ys[i, :L] = nd["y"]
                    ns[i] = L
                    ms[i] = nd["mask"]
                    if nd["init"] is None:
                        k_sub = int(nd["mask"].sum())
                        pis[i] = np.float32(np.log(1.0 / k_sub))
                    else:
                        pis[i] = np.where(iota == nd["init"], np.float32(0.0),
                                          np.float32(-np.inf))
                    lf[i] = -1 if nd["last"] is None else nd["last"]
                for i in range(n, _LANES):  # pad: replay lane 0 (discarded)
                    ys[i], ns[i], ms[i], pis[i], lf[i] = (ys[0], ns[0], ms[0],
                                                          pis[0], lf[0])
                if dag:
                    out = _node_forward_dag_lanes(
                        logA_d, logB_d, A_posF, jnp.asarray(ys),
                        jnp.asarray(ns), jnp.asarray(ms), jnp.asarray(pis),
                        jnp.asarray(lf), max_hops=min(Lp, K))
                else:
                    out = _node_forward_dyn_lanes(
                        logA_d, logB_d, anc_g, desc_g, jnp.asarray(ys),
                        jnp.asarray(ns), jnp.asarray(ms), jnp.asarray(pis),
                        jnp.asarray(lf))
                pending.append((chunk, out))
        for chunk, (xa, xb, nl, lr) in pending:
            xa = np.asarray(xa); xb = np.asarray(xb)
            nl = np.asarray(nl); lr = np.asarray(lr)
            for i, nid in enumerate(chunk):
                nd = nodes[nid]
                L = len(nd["y"])
                x_a, x_b, n_left = int(xa[i]), int(xb[i]), int(nl[i])
                if x_a == -1:  # median never set: the oracle's early return
                    nd["kind"] = "skip"
                    continue
                nd["pair"] = (x_a, x_b)
                adj_sub = A_pos_np & np.outer(nd["mask"], nd["mask"])
                if n_left > 1:
                    lm = _host_bfs(adj_sub.T, x_a, n_left - 1).copy()
                    lm[x_a] = True
                    nd["left"] = new_node(lm, nd["y"][:n_left], x_a,
                                          nd["init"])
                    nxt.append(nd["left"])
                n_right = L - n_left
                if n_right > 1:
                    rm = _host_bfs(adj_sub, x_b, n_right - 1).copy()
                    rm[x_b] = True
                    nd["right"] = new_node(rm, nd["y"][-n_right:],
                                           None, x_b)
                    nxt.append(nd["right"])
        level = nxt

    # in-order flatten == the original's append order
    def flatten_tree(root: int) -> list[tuple[int, int]]:
        path: list[tuple[int, int]] = []
        stack: list[tuple[int, bool]] = [(root, False)]
        while stack:
            nid, emit = stack.pop()
            nd = nodes[nid]
            if nd["kind"] == "skip":
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

    return [flatten_tree(r) for r in roots]


def _flatten(pairs: list[tuple[int, int]], T: int) -> np.ndarray:
    """pretty_print_path layout (Viterbi.py:827-847): p0.x, p0.y, then the
    .y of each later pair; -1 padding to T."""
    out = np.full((T,), -1, np.int32)
    if pairs:
        flat = [pairs[0][0], pairs[0][1]] + [p[1] for p in pairs[1:]]
        out[:min(len(flat), T)] = np.asarray(flat[:T], np.int32)
    return out


def _memory(K: int, T: int, **_) -> int:
    # device engine live buffers: node masks (T, K) bool + forward
    # carries (5 K-vectors f32/int32) + the two count vectors + the
    # int32 node table (~11 T-vectors)
    return T * K + 7 * K * 4 + 11 * T * 4


@register("sieve")
def _build(b_hops: int | None = None, **static) -> Decoder:
    def fn(logA, logB, logPi, y):
        pairs = sieve_dynamic_decode(logA, logB, logPi, y, b_hops=b_hops)
        return jnp.asarray(_flatten(pairs, int(y.shape[0])))

    def batch_fn(logA, logB, logPi, ys):
        T = int(ys.shape[1])
        many = sieve_dynamic_decode_many(logA, logB, logPi, ys, b_hops=b_hops)
        return jnp.stack([jnp.asarray(_flatten(p, T)) for p in many])

    return Decoder("sieve", fn, {"b_hops": b_hops, **static}, _memory,
                   jittable=False, batch_fn=batch_fn)


@register("sieve_dag")
def _build_dag(**static) -> Decoder:
    def fn(logA, logB, logPi, y):
        pairs = sieve_dynamic_decode(logA, logB, logPi, y, dag=True)
        return jnp.asarray(_flatten(pairs, int(y.shape[0])))

    def batch_fn(logA, logB, logPi, ys):
        T = int(ys.shape[1])
        many = sieve_dynamic_decode_many(logA, logB, logPi, ys, dag=True)
        return jnp.stack([jnp.asarray(_flatten(p, T)) for p in many])

    return Decoder("sieve_dag", fn, static, _memory, jittable=False,
                   batch_fn=batch_fn)

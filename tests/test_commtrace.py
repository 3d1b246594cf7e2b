"""The scaling model's comm terms vs the program that actually runs.

``parallel.scaling.analyze``'s comm terms validated against the
jaxpr-level tracer (``parallel.commtrace``), which counts every
collective the pipelined sharded decode issues on a virtual mesh (scan
trip counts multiplied through).  Every kind is pinned EXACTLY —
ppermute (the tick count inside is the pipeline bubble), psum (path
reduce), all_gather (per-step state gathers + the phase-1 per-tick and
phase-2 per-lane boundary gathers), and therefore the total.
"""

import math

import pytest

from flash_viterbi_tpu.parallel.commtrace import trace_sharded_decode
from flash_viterbi_tpu.parallel.scaling import analyze
from flash_viterbi_tpu.parallel.sharded import make_mesh


@pytest.mark.parametrize("shape,batch,segs,mb", [
    ((2, 2, 2), 8, 8, 1),
    ((1, 4, 2), 8, 8, 2),
    ((2, 1, 4), 8, 4, 1),
])
def test_model_matches_traced_collectives(shape, batch, segs, mb):
    d, s, t = shape
    mesh = make_mesh(d, s, t)
    K, T = 64, 64
    got = trace_sharded_decode(mesh, K=K, T=T, batch=batch,
                               num_segments=segs, microbatch=mb)
    rep = analyze(shape, K=K, T=T, batch=batch, num_segments=segs,
                  microbatch=mb, card_updates_per_s=1.0, link_bytes_per_s=1.0)

    # model's individual terms (mirror analyze()'s formulas)
    Bd = batch // d
    mbe = min(mb, Bd)
    n_mb = Bd // mbe
    ticks = n_mb + s - 1
    L = T // s
    spd = max(1, segs // s)
    hop_bytes = ticks * mbe * K * 4 if s > 1 else 0
    psum_bytes = (math.ceil(math.log2(s)) * Bd * T * 4) if s > 1 else 0
    frac_t = (t - 1) / t if t > 1 else 0.0
    rows_state = (2 * (ticks * mbe * max(L - 1, 1) + Bd * max(L - spd, 1))
                  + 3 * mbe * ticks + 2 * Bd * spd)
    gather_bytes = rows_state * K * 4 * frac_t
    if s > 1:  # seq-axis plane + finals gathers
        gather_bytes += (s - 1) * Bd * K * 4 + (s - 1) * Bd * 4

    traced_hop = got.get("ppermute", {}).get("bytes", 0)
    traced_psum = got.get("psum", {}).get("bytes", 0)
    traced_gather = got.get("all_gather", {}).get("bytes", 0)
    assert traced_hop == hop_bytes, (traced_hop, hop_bytes)
    assert traced_psum == psum_bytes, (traced_psum, psum_bytes)
    assert traced_gather == gather_bytes, (traced_gather, gather_bytes)

    total = sum(v["bytes"] for v in got.values())
    assert total == rep.link_bytes_per_device, (
        total, rep.link_bytes_per_device)

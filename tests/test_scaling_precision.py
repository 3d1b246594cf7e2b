"""Scaling model/virtual sweep and the bf16 approximate mode."""

import numpy as np

import flash_viterbi_tpu as fvt
from flash_viterbi_tpu.parallel.scaling import analyze, measure_virtual

# explicit rates for the model: an H100-class card (~3.35 TB/s of logA
# stream at 4 B a cell) and NVLink's 450 GB/s each way (data sheets; the
# model has no built-in device figures)
CARD_UPDATES_PER_S = 8.4e11
LINK_BYTES_PER_S = 4.5e11
RATES = dict(card_updates_per_s=CARD_UPDATES_PER_S,
             link_bytes_per_s=LINK_BYTES_PER_S)


def test_scaling_model_meets_target():
    """Config-5 scale (256 sequences, K=16384, T=65536) must model >= 80%
    efficiency on every >= 2-host mesh split — with the pipeline bubble,
    per-step state-axis gathers and the path psum all charged."""
    for shape in [(1, 1, 2), (1, 2, 2), (2, 2, 2), (1, 1, 8), (4, 4, 4),
                  (8, 2, 1), (4, 2, 2)]:
        r = analyze(shape, K=16384, T=65536, batch=256, **RATES)
        assert r.modeled_efficiency >= 0.8, (shape, r.modeled_efficiency)
    r = analyze((1, 2, 2), K=16384, T=65536, batch=256, **RATES)
    assert r.link_bytes_per_device > 0
    assert r.ptr_bytes_per_device > 0
    assert set(r.as_dict()) >= {"modeled_efficiency", "updates_per_device",
                                "ideal_updates_per_device"}


def test_scaling_model_honest_about_single_sequence():
    """One sequence on a pure seq mesh: phase 1 is a serial chain and the
    model must NOT claim high efficiency (the old model's blind spot)."""
    r = analyze((1, 4, 1), K=1024, T=4096, batch=1, **RATES)
    assert r.modeled_efficiency < 0.6, r.modeled_efficiency


def test_scaling_model_scales_with_given_rates():
    """The model's time terms are the counters over the rates it is
    given: doubling the card rate halves compute, doubling the link
    bandwidth halves communication."""
    a = analyze((1, 2, 2), K=16384, T=65536, batch=256, **RATES)
    b = analyze((1, 2, 2), K=16384, T=65536, batch=256,
                card_updates_per_s=2 * CARD_UPDATES_PER_S,
                link_bytes_per_s=2 * LINK_BYTES_PER_S)
    assert abs(b.compute_s * 2 - a.compute_s) <= 1e-9 * a.compute_s
    assert abs(b.comm_s * 2 - a.comm_s) <= 1e-9 * a.comm_s
    assert a.compute_s == a.updates_per_device / CARD_UPDATES_PER_S


def test_measure_update_rate_runs():
    from flash_viterbi_tpu.parallel.scaling import measure_update_rate

    assert measure_update_rate(K=64, T=16) > 0


def test_work_counters_balance():
    """Per-device work counters: batched config-5-like shapes divide all
    the work (balance ~= 1); the counters are the claim, not wall clocks."""
    from flash_viterbi_tpu.parallel.scaling import work_report

    rep = work_report((2, 2, 2), K=16384, T=65536, batch=256)
    assert rep["work_balance"] > 0.9
    one = work_report((1, 1, 1), K=1024, T=4096, batch=1)
    assert one["work_balance"] <= 1.0


def test_virtual_mesh_sweep_agrees():
    rows = measure_virtual([(1, 1, 1), (2, 2, 2), (1, 2, 4)],
                           K=48, T=32, batch=4)
    assert all(r["paths_equal"] for r in rows)
    assert all(r["updates_per_device"] > 0 for r in rows)


def test_bf16_mode_quality(small_problem):
    hmm, y = small_problem
    exact = fvt.decode(hmm, y, algorithm="fused", warmup=False, pad_to=1,
                       use_pallas=False)
    approx = fvt.decode(hmm, y, algorithm="fused", warmup=False, pad_to=1,
                        use_pallas=False, precision="bf16")
    with np.errstate(divide="ignore"):
        lA, lB, lPi = (np.log(x) for x in (hmm.A, hmm.B, hmm.Pi))

    def ll(p):
        s = lPi[p[0]] + lB[p[0], y[0]]
        s += sum(lA[p[t - 1], p[t]] + lB[p[t], y[t]] for t in range(1, len(y)))
        return s

    le, la = ll(exact.path), ll(approx.path)
    assert la <= le + 1e-6              # never better than optimal
    assert la >= le - 0.05 * abs(le)    # within 5% relative of optimal

"""2-process DCN-style test: the pipelined shard_map decode over a global
mesh spanning two OS processes (jax.distributed on the CPU backend), the
standard stand-in for a multi-host deployment (SURVEY.md §4)."""

import os

from flash_viterbi_tpu.parallel.multihost import launch_workers


def test_two_process_decode(tmp_path):
    worker = os.path.join(os.path.dirname(__file__), "multihost_worker.py")
    launch_workers(worker, 2, tmp_path)


def test_four_process_decode(tmp_path):
    """4 processes x 2 virtual devices: a (4, 2, 1) global mesh whose
    (seq, state) planes are each process-local (asserted in the worker,
    with the DCN-crossing refusal case) — VERDICT r3 item 6."""
    worker = os.path.join(os.path.dirname(__file__), "multihost_worker.py")
    launch_workers(worker, 4, tmp_path)


def test_eight_process_decode(tmp_path):
    """8-process layout-contract coverage (VERDICT r4 item 6); heavier
    spawn cost, so gated with the slow tier."""
    import pytest

    if not os.environ.get("FVT_SLOW_TESTS"):
        pytest.skip("set FVT_SLOW_TESTS=1 for the 8-process rig")
    worker = os.path.join(os.path.dirname(__file__), "multihost_worker.py")
    launch_workers(worker, 8, tmp_path, timeout=480.0)


def test_dcn_state_refusal_unit():
    """The refusal path's positive case in the plain CPU tier: a (seq,
    state) plane spanning two processes must raise unless explicitly
    allowed — no distributed runtime needed (VERDICT r4 item 6)."""
    import numpy as np
    import pytest

    from flash_viterbi_tpu.parallel.multihost import check_plane_locality

    class Dev:
        def __init__(self, pi):
            self.process_index = pi

    # (data=1, seq=2, state=2) over 2 processes: the single plane spans both
    bad = np.asarray([[[Dev(0), Dev(0)], [Dev(1), Dev(1)]]], dtype=object)
    with pytest.raises(ValueError, match="DCN"):
        check_plane_locality(bad)
    check_plane_locality(bad, allow_dcn_state=True)  # explicit opt-in runs

    # (data=2, seq=2, state=1) data-major: every plane process-local
    ok = np.asarray([[[Dev(0)], [Dev(0)]], [[Dev(1)], [Dev(1)]]],
                    dtype=object)
    check_plane_locality(ok)

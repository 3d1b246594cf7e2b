"""Test configuration: force CPU with 8 virtual devices so sharding paths
(`shard_map` over a Mesh) run without a GPU (SURVEY.md §4).

A separate tier runs on the card: ``FVT_GPU_TESTS=1 python -m pytest tests/
-m gpu`` keeps JAX's default (GPU) backend and runs the ``@pytest.mark.gpu``
tests — the compiled Triton step and the decoders on it, which the CPU tier
only reaches through the Pallas interpreter.  Elsewhere those tests skip
with a reason; whether to skip is decided inside a fixture, never while a
module is imported, so every xdist worker collects the same tests.
"""

import os

_GPU_TIER = os.environ.get("FVT_GPU_TESTS", "") == "1"

_flags = os.environ.get("XLA_FLAGS", "")
if not _GPU_TIER and "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax

if not _GPU_TIER:
    jax.config.update("jax_platforms", "cpu")

import functools

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs the card (FVT_GPU_TESTS=1 pytest -m gpu)")


@pytest.fixture(autouse=True)
def _gpu_tier(request):
    if request.node.get_closest_marker("gpu") is None:
        return
    if not _GPU_TIER:
        pytest.skip("needs a GPU: run FVT_GPU_TESTS=1 pytest -m gpu on the card")
    if jax.devices()[0].platform != "gpu":
        pytest.skip(f"FVT_GPU_TESTS=1 but the device is "
                    f"{jax.devices()[0].platform}, not a GPU")


@pytest.fixture
def interpret_kernel(monkeypatch):
    """Route every ``ops.maxplus.maxplus_lanes`` step through the Triton
    kernel run by the Pallas interpreter, as if on a GPU."""
    from flash_viterbi_tpu.ops import maxplus, maxplus_triton

    monkeypatch.setattr(maxplus, "use_kernel_for", lambda *a, **k: True)
    monkeypatch.setattr(maxplus_triton, "maxplus_lanes_triton",
                        functools.partial(maxplus_triton.maxplus_lanes_triton,
                                          interpret=True))


from flash_viterbi_tpu.models.generate import make_sparse_hmm


@pytest.fixture(scope="session")
def small_problem():
    """K=64, T=32 sparse HMM — small enough for exhaustive parity checks."""
    hmm, y = make_sparse_hmm(K=64, M=12, T=32, prob=0.3, seed=7)
    return hmm, y


@pytest.fixture(scope="session")
def medium_problem():
    hmm, y = make_sparse_hmm(K=128, M=20, T=64, prob=0.2, seed=3)
    return hmm, y

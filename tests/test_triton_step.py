"""The Triton max-plus step (Pallas interpreter on the CPU) against the
plain XLA step, its tiling and kernel choice, and the decoders run on it."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import flash_viterbi_tpu as fvt
from flash_viterbi_tpu.ops import maxplus as mp
from flash_viterbi_tpu.ops.maxplus_triton import (StepTiles, combine_splits,
                                                  default_tiles,
                                                  maxplus_lanes_triton)
from flash_viterbi_tpu.oracle import framework as ofw

step = functools.partial(maxplus_lanes_triton, interpret=True)


def _planted(K, N, Kd=None, seed=0):
    """Random lanes and transition block with exact ties (duplicate source
    rows), a -inf source row, a -inf destination column and, with 4+
    lanes, one all -inf lane."""
    Kd = K if Kd is None else Kd
    rng = np.random.RandomState(seed + K + N)
    logA = rng.randn(K, Kd).astype(np.float32)
    logA[9 % K] = logA[5 % K]
    logA[3 % K] = -np.inf
    logA[:, 7 % Kd] = -np.inf
    delta = rng.randn(N, K).astype(np.float32)
    delta[:, 9 % K] = delta[:, 5 % K]
    if N >= 4:
        delta[1] = -np.inf
    return delta, logA


def _check(got, delta, logA):
    scores = delta[:, :, None] + logA[None]
    np.testing.assert_array_equal(np.asarray(got[0]), scores.max(axis=1))
    np.testing.assert_array_equal(np.asarray(got[1]), scores.argmax(axis=1))


@pytest.mark.parametrize("N", [1, 4, 16])
@pytest.mark.parametrize("K", [64, 100, 128, 384])
def test_triton_step_matches_xla(K, N):
    delta, logA = _planted(K, N)
    _check(step(jnp.asarray(delta), jnp.asarray(logA)), delta, logA)


@pytest.mark.parametrize("K,Kd,N", [(256, 128, 4), (100, 36, 3)])
def test_triton_step_rectangular_block(K, Kd, N):
    """The state-sharded path's (K, K/n_state) column block."""
    delta, logA = _planted(K, N, Kd)
    _check(step(jnp.asarray(delta), jnp.asarray(logA)), delta, logA)


@pytest.mark.parametrize("tiles", [
    StepTiles(cols=32, rows=8, lanes=2, splits=16),   # splits past the rows
    StepTiles(cols=64, rows=32, lanes=4, splits=3),   # lanes don't divide N
    StepTiles(cols=16, rows=4, lanes=1, splits=1),
])
def test_triton_step_explicit_tiles(tiles):
    delta, logA = _planted(72, 7)
    _check(step(jnp.asarray(delta), jnp.asarray(logA), tiles=tiles),
           delta, logA)


def test_triton_step_bf16_block():
    """precision="bf16" hands the step a bf16 logA; the kernel widens it
    exactly as XLA's promotion does."""
    delta, logA = _planted(128, 4)
    a16 = jnp.asarray(logA).astype(jnp.bfloat16)
    got = step(jnp.asarray(delta), a16)
    want = mp.maxplus_lanes_xla(jnp.asarray(delta), a16)
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))


def test_triton_step_under_vmap():
    """vmap of the kernel (decode_batch with algorithm="flash") becomes a
    grid axis; results stay bit-equal."""
    rng = np.random.RandomState(3)
    d = jnp.asarray(rng.randn(3, 2, 100).astype(np.float32))
    a = jnp.asarray(rng.randn(100, 100).astype(np.float32))
    got = jax.vmap(step, in_axes=(0, None))(d, a)
    want = jax.vmap(mp.maxplus_lanes_xla, in_axes=(0, None))(d, a)
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))


def test_combine_splits_keeps_lowest_index():
    vals = jnp.asarray([[[1.0, 2.0, -np.inf]], [[1.0, 3.0, -np.inf]]])
    args = jnp.asarray([[[4, 5, 0]], [[40, 50, 64]]], jnp.int32)
    v, a = combine_splits(vals, args)
    np.testing.assert_array_equal(np.asarray(v), [[1.0, 3.0, -np.inf]])
    np.testing.assert_array_equal(np.asarray(a), [[4, 50, 0]])


def test_default_tiles_by_lane_count():
    assert default_tiles(1) == StepTiles(rows=64, lanes=1, splits=8)
    assert default_tiles(2).lanes == 2 and default_tiles(3).lanes == 2
    assert default_tiles(4).lanes == 4 and default_tiles(7).rows == 32
    for n in (8, 16, 64):
        assert default_tiles(n) == StepTiles(rows=16, lanes=8, splits=4)
    for n in (1, 2, 5, 9, 64):
        t = default_tiles(n)
        for size in (t.cols, t.rows, t.lanes, t.splits):
            assert size & (size - 1) == 0  # Triton wants powers of two


def test_kernel_choice():
    assert mp.use_kernel_for("auto", platform="gpu")
    assert not mp.use_kernel_for("auto", platform="cpu")
    assert not mp.use_kernel_for(False, platform="gpu")
    assert mp.use_kernel_for(True, platform="gpu")
    with pytest.raises(ValueError, match="needs a GPU"):
        mp.use_kernel_for(True, platform="cpu")
    # off the GPU "auto" is XLA: no interpreted kernel unless asked for
    delta, logA = _planted(64, 2)
    jaxpr = str(jax.make_jaxpr(mp.maxplus_lanes)(jnp.asarray(delta),
                                                 jnp.asarray(logA)))
    assert "pallas_call" not in jaxpr


def test_maxplus_lanes_dispatches_to_kernel(interpret_kernel):
    delta, logA = _planted(100, 5)
    jaxpr = str(jax.make_jaxpr(mp.maxplus_lanes)(jnp.asarray(delta),
                                                 jnp.asarray(logA)))
    assert "pallas_call" in jaxpr
    _check(mp.maxplus_lanes(jnp.asarray(delta), jnp.asarray(logA)),
           delta, logA)


@pytest.mark.parametrize("alg,kw", [
    ("fused", {}),
    ("flash", {"num_segments": 5}),
    ("flash", {"num_segments": 5, "mode": "lean"}),
    ("flash", {"num_segments": 3, "mode": "lean", "lean_leaf": 0}),
    ("flash", {"num_segments": 3, "mode": "lean", "lean_leaf": 4}),
])
def test_decoders_on_kernel_equal_vanilla(interpret_kernel, alg, kw):
    hmm, y = fvt.make_sparse_hmm(K=40, M=7, T=21, prob=0.35, seed=102)
    want = ofw.vanilla(hmm.A, hmm.B, hmm.Pi, y)
    r = fvt.decode(hmm, y, algorithm=alg, pad_to=1, warmup=False, **kw)
    np.testing.assert_array_equal(r.path, want, err_msg=f"{alg} {kw}")


def test_decode_batch_on_kernel(interpret_kernel, small_problem):
    """The fused lane batch (one kernel step for every sequence) equals
    per-sequence vanilla decodes."""
    hmm, y = small_problem
    rng = np.random.RandomState(4)
    ys = np.stack([np.asarray(y, np.int32)]
                  + [rng.randint(0, hmm.M, len(y)).astype(np.int32)
                     for _ in range(4)])
    r = fvt.decode_batch(hmm, ys, pad_to=1, warmup=False)
    for b in range(len(ys)):
        np.testing.assert_array_equal(
            r.path[b], ofw.vanilla(hmm.A, hmm.B, hmm.Pi, ys[b]))


def test_kernel_off_gpu_refuses_explicit_request(small_problem):
    hmm, y = small_problem
    with pytest.raises(ValueError, match="needs a GPU"):
        fvt.decode(hmm, y, algorithm="fused", use_pallas=True, warmup=False)

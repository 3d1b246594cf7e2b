"""Multi-chip sharded decode on the virtual 8-device CPU mesh (SURVEY.md §4):
every (data, seq, state) factorization must reproduce the single-chip FLASH
path bit-exactly."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from flash_viterbi_tpu.algorithms.flash import flash_decode
from flash_viterbi_tpu.parallel.sharded import (
    flash_decode_sharded,
    make_mesh,
    mesh_shape_for,
)


def _tables(hmm):
    lh = hmm.log()
    return jnp.asarray(lh.logA), jnp.asarray(lh.logB), jnp.asarray(lh.logPi)


@pytest.mark.parametrize("shape,segs", [
    ((2, 2, 2), 4),
    ((1, 2, 4), 8),
    ((4, 2, 1), 2),
    ((1, 1, 8), 4),
    ((1, 8, 1), 8),
    ((1, 1, 1), 4),
])
def test_sharded_matches_single_chip(small_problem, shape, segs):
    hmm, y = small_problem
    logA, logB, logPi = _tables(hmm)
    ys = jnp.stack([jnp.asarray(y, jnp.int32)] * 4)
    mesh = make_mesh(*shape)
    out = np.asarray(flash_decode_sharded(mesh, logA, logB, logPi, ys, num_segments=segs))
    ref = np.asarray(flash_decode(logA, logB, logPi, jnp.asarray(y, jnp.int32),
                                  num_segments=segs, mode="pointer"))
    np.testing.assert_array_equal(out, ref[None, :].repeat(4, axis=0))


@pytest.mark.parametrize("shape,segs,mb", [
    ((1, 1, 1), 8, 1),
    ((1, 2, 1), 8, 1),
    ((1, 4, 1), 8, 2),
    ((2, 2, 2), 8, 1),
    ((1, 2, 4), 8, 1),
    ((1, 8, 1), 8, 1),
    ((1, 1, 8), 4, 4),
    ((1, 2, 2), 4, 2),
])
def test_pipelined_matches_single_chip(small_problem, shape, segs, mb):
    """The pipelined seq-parallel path (GPipe-style block flow + hierarchical
    anchor-plane resolution) must be bit-identical to single-chip flash."""
    hmm, y = small_problem
    logA, logB, logPi = _tables(hmm)
    ys = jnp.stack([jnp.asarray(y, jnp.int32)] * 4)
    mesh = make_mesh(*shape)
    out = np.asarray(flash_decode_sharded(mesh, logA, logB, logPi, ys,
                                          num_segments=segs, microbatch=mb,
                                          pipeline=True))
    ref = np.asarray(flash_decode(logA, logB, logPi, jnp.asarray(y, jnp.int32),
                                  num_segments=segs, mode="pointer"))
    np.testing.assert_array_equal(out, ref[None, :].repeat(4, axis=0))


@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 1, 1), (1, 2, 1),
                                   (1, 1, 2), (1, 2, 2)])
def test_pipelined_kernel_interpret(small_problem, shape, interpret_kernel):
    """The Triton step inside shard_map (on the local (K, K/n_state)
    column block when n_state > 1), interpret mode on the CPU mesh."""
    hmm, y = small_problem
    logA, logB, logPi = _tables(hmm)
    ys = jnp.stack([jnp.asarray(y, jnp.int32)] * 4)
    out = np.asarray(flash_decode_sharded(make_mesh(*shape), logA, logB, logPi,
                                          ys, num_segments=4, microbatch=2,
                                          pipeline=True, use_kernel=True))
    ref = np.asarray(flash_decode(logA, logB, logPi, jnp.asarray(y, jnp.int32),
                                  num_segments=4, mode="pointer"))
    np.testing.assert_array_equal(out, ref[None, :].repeat(4, axis=0))


def test_pipelined_distinct_batch(medium_problem):
    hmm, y = medium_problem
    logA, logB, logPi = _tables(hmm)
    rng = np.random.RandomState(0)
    y = np.asarray(y)
    ys = np.stack([y, rng.randint(0, hmm.M, size=len(y)).astype(y.dtype),
                   y[::-1].copy(), (y + 1) % hmm.M])
    mesh = make_mesh(2, 2, 2)
    out = np.asarray(flash_decode_sharded(mesh, logA, logB, logPi,
                                          jnp.asarray(ys, jnp.int32),
                                          num_segments=4, pipeline=True))
    for b in range(4):
        ref = np.asarray(flash_decode(logA, logB, logPi, jnp.asarray(ys[b], jnp.int32),
                                      num_segments=4, mode="pointer"))
        np.testing.assert_array_equal(out[b], ref)


def test_distinct_batch_elements(medium_problem):
    """Different sequences in the batch decode independently."""
    hmm, y = medium_problem
    logA, logB, logPi = _tables(hmm)
    rng = np.random.RandomState(0)
    ys = np.stack([y, rng.randint(0, hmm.M, size=len(y)).astype(np.int32),
                   y[::-1].copy(), (y + 1) % hmm.M])
    mesh = make_mesh(2, 2, 2)
    out = np.asarray(flash_decode_sharded(mesh, logA, logB, logPi,
                                          jnp.asarray(ys), num_segments=4))
    for b in range(4):
        ref = np.asarray(flash_decode(logA, logB, logPi, jnp.asarray(ys[b]),
                                      num_segments=4, mode="pointer"))
        np.testing.assert_array_equal(out[b], ref)


def test_mesh_shape_for():
    assert mesh_shape_for(8) == (2, 2, 2)
    assert mesh_shape_for(4) == (1, 2, 2)
    assert mesh_shape_for(2) == (1, 1, 2)
    assert mesh_shape_for(1) == (1, 1, 1)
    for n in (1, 2, 3, 4, 6, 8):
        d, s, t = mesh_shape_for(n)
        assert d * s * t == n


def test_graft_entry_dryrun():
    import sys
    sys.path.insert(0, "/root/repo")
    import __graft_entry__ as g

    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    assert out.shape == (args[3].shape[0],)
    g.dryrun_multichip(8)


@pytest.mark.skipif(not __import__("os").environ.get("FVT_SLOW_TESTS"),
                    reason="slow (~1.5 min): set FVT_SLOW_TESTS=1")
@pytest.mark.parametrize("shape", [(1, 2, 2), (2, 2, 2), (1, 4, 2)])
def test_sharded_bit_exact_at_tie_flip_scale(shape):
    """Bit-exactness across mesh shapes at a scale where fp32 exact-tie
    flips actually occur (K=512, T=2048: flash legitimately differs from
    vanilla at 5 positions, same as the reference C binary).  The sharded
    orchestration must not introduce a single additional flip."""
    from flash_viterbi_tpu.models.generate import make_sparse_hmm

    K, M, T, segs = 512, 50, 2048, 8
    hmm, y = make_sparse_hmm(K=K, M=M, T=T, prob=0.112, seed=1)
    logA, logB, logPi = _tables(hmm)
    ys = jnp.stack([jnp.asarray(y, jnp.int32)] * 2)
    out = np.asarray(flash_decode_sharded(make_mesh(*shape), logA, logB,
                                          logPi, ys, num_segments=segs,
                                          pipeline=True))
    ref = np.asarray(flash_decode(logA, logB, logPi,
                                  jnp.asarray(y, jnp.int32),
                                  num_segments=segs, mode="pointer"))
    np.testing.assert_array_equal(out, ref[None].repeat(2, axis=0))

"""Card tier: the compiled Triton step and the decoders on it.

Run on the card with ``FVT_GPU_TESTS=1 python -m pytest tests/ -m gpu -q``
(one process: a JAX process reserves most of the card's memory).  The CPU
tier checks the same kernel in the Pallas interpreter; this tier pins what
only the compiled kernel can show: the lowest-index tie rule under the
GPU's own reduction order, agreement of every exact decoder, the sharded
path on the kernel, and the largest widths.
"""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def _tables(hmm, pad=128):
    import jax.numpy as jnp

    lh = hmm.log().padded(pad)
    return tuple(jnp.asarray(x) for x in (lh.logA, lh.logB, lh.logPi))


@pytest.mark.parametrize("K,Kd,N", [(256, 256, 1), (512, 256, 4),
                                    (3968, 3968, 16), (1000, 1000, 3)])
def test_step_ties_on_card(K, Kd, N):
    """Lowest-index argmax on exact fp32 ties, compiled Triton vs XLA,
    including a rectangular (state-sharded) block and an unpadded K."""
    import jax.numpy as jnp

    from flash_viterbi_tpu.ops.maxplus import maxplus_lanes_xla
    from flash_viterbi_tpu.ops.maxplus_triton import maxplus_lanes_triton

    rng = np.random.RandomState(K + N)
    logA = rng.randn(K, Kd).astype(np.float32)
    logA[17] = logA[3]
    logA[:, 5] = -np.inf
    delta = rng.randn(N, K).astype(np.float32)
    delta[:, 17] = delta[:, 3]
    got = maxplus_lanes_triton(jnp.asarray(delta), jnp.asarray(logA))
    want = maxplus_lanes_xla(jnp.asarray(delta), jnp.asarray(logA))
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))


def test_step_bf16_block_on_card():
    """precision="bf16" hands the compiled step a bf16 logA."""
    import jax.numpy as jnp

    from flash_viterbi_tpu.ops.maxplus import maxplus_lanes_xla
    from flash_viterbi_tpu.ops.maxplus_triton import maxplus_lanes_triton

    rng = np.random.RandomState(2)
    logA = jnp.asarray(rng.randn(512, 512).astype(np.float32)).astype(
        jnp.bfloat16)
    delta = jnp.asarray(rng.randn(4, 512).astype(np.float32))
    got = maxplus_lanes_triton(delta, logA)
    want = maxplus_lanes_xla(delta, logA)
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))


def test_exact_decoders_agree_on_card():
    import flash_viterbi_tpu as fvt

    hmm, y = fvt.make_sparse_hmm(K=96, M=10, T=48, prob=0.25, seed=11)
    v = fvt.decode(hmm, y, algorithm="vanilla", warmup=False)
    for alg, kw in [("fused", {}), ("checkpoint", {}),
                    ("flash", {"num_segments": 6}),
                    ("flash", {"num_segments": 6, "mode": "lean"}),
                    ("flash", {"num_segments": 6, "mode": "lean",
                               "lean_leaf": 0})]:
        r = fvt.decode(hmm, y, algorithm=alg, warmup=False, **kw)
        np.testing.assert_array_equal(v.path, r.path, err_msg=f"{alg} {kw}")


def test_sharded_single_card_kernel_path():
    """The pipelined sharded decode on a (1,1,1) mesh with the kernel
    equals the single-card flash decode."""
    import jax.numpy as jnp

    import flash_viterbi_tpu as fvt
    from flash_viterbi_tpu.algorithms.flash import flash_decode
    from flash_viterbi_tpu.parallel.sharded import flash_decode_sharded, make_mesh

    hmm, y = fvt.make_sparse_hmm(K=128, M=10, T=64, prob=0.2, seed=5)
    logA, logB, logPi = _tables(hmm)
    yd = jnp.asarray(np.asarray(y), jnp.int32)
    out = np.asarray(flash_decode_sharded(make_mesh(1, 1, 1), logA, logB,
                                          logPi, jnp.stack([yd, yd]),
                                          num_segments=4, pipeline=True,
                                          use_kernel=True))
    ref = np.asarray(flash_decode(logA, logB, logPi, yd, num_segments=4))
    np.testing.assert_array_equal(out, ref[None].repeat(2, axis=0))


def test_sieve_device_engines_on_card():
    """The on-device sieve recursion engines match the host schedulers."""
    import jax.numpy as jnp

    import flash_viterbi_tpu as fvt
    from flash_viterbi_tpu.algorithms.sieve_bs import sieve_bs_decode
    from flash_viterbi_tpu.algorithms.sieve_dyn import sieve_dynamic_decode_many

    hmm, y = fvt.make_sparse_hmm(K=96, M=10, T=48, prob=0.15, seed=3)
    lh = hmm.log()
    tbl = (jnp.asarray(lh.logA), jnp.asarray(lh.logB), jnp.asarray(lh.logPi))
    assert (sieve_bs_decode(*tbl, np.asarray(y), beam_width=8, engine="device")
            == sieve_bs_decode(*tbl, np.asarray(y), beam_width=8,
                               engine="host"))
    assert (sieve_dynamic_decode_many(*tbl, np.asarray(y)[None],
                                      engine="device")[0]
            == sieve_dynamic_decode_many(*tbl, np.asarray(y)[None],
                                         engine="host")[0])

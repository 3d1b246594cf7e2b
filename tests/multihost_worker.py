"""Worker process for the 2-process DCN-style CPU test (test_multihost.py).

Each process owns 2 virtual CPU devices; the two processes form a
(2, 2, 1) global mesh with the data axis across the process (DCN)
boundary and seq inside each process — the layout make_global_mesh
guarantees.  Runs the SAME pipelined shard_map decode as single-chip and
checks this process's batch shard against a locally computed single-chip
reference, writing an ok-file on success (the parent asserts both).
"""

import os
import sys


def main():
    port, pid, nproc, outdir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"

    import jax

    jax.config.update("jax_platforms", "cpu")
    # distributed init must precede anything that touches the backend
    # (including importing modules that enumerate devices)
    jax.distributed.initialize(coordinator_address=f"localhost:{port}",
                               num_processes=nproc, process_id=pid)

    import numpy as np
    import jax.numpy as jnp

    from flash_viterbi_tpu.algorithms.flash import flash_decode
    from flash_viterbi_tpu.models.generate import make_sparse_hmm
    from flash_viterbi_tpu.parallel import multihost
    from flash_viterbi_tpu.parallel.sharded import flash_decode_sharded
    assert jax.process_count() == nproc
    assert len(jax.devices()) == 2 * nproc

    mesh = multihost.make_global_mesh(n_data=nproc, n_seq=2, n_state=1)

    # ---- mesh-layout contract (parallel/multihost.py:11-19) -------------
    # every (seq, state) plane must be process-local: the per-step state
    # collectives stay inside one process, never cross DCN
    arr = np.asarray(mesh.devices, dtype=object)
    for d in range(arr.shape[0]):
        procs = {dev.process_index for dev in arr[d].ravel()}
        assert len(procs) == 1, f"plane {d} spans processes {procs}"
    # data-major assignment: plane p belongs to process p (sorted order)
    planes = [next(iter({dev.process_index for dev in arr[d].ravel()}))
              for d in range(arr.shape[0])]
    assert planes == sorted(planes), planes
    # a state axis wider than one process's devices must be REFUSED
    try:
        multihost.make_global_mesh(n_data=1, n_seq=nproc, n_state=2)
        assert False, "DCN-crossing state axis was not refused"
    except ValueError as e:
        assert "DCN" in str(e), e
    # ... unless explicitly allowed
    multihost.make_global_mesh(n_data=1, n_seq=nproc, n_state=2,
                               allow_dcn_state=True)

    hmm, y = make_sparse_hmm(K=64, M=8, T=32, prob=0.3, seed=7)
    lh = hmm.log()
    logA = jnp.asarray(lh.logA)
    logB = jnp.asarray(lh.logB)
    logPi = jnp.asarray(lh.logPi)
    y_np = np.asarray(y, np.int32)
    rng = np.random.RandomState(0)
    B = max(4, nproc)  # the data axis (nproc) must divide the batch
    ys_np = np.stack([np.asarray(rng.randint(0, hmm.M, size=len(y_np)),
                                 np.int32) for _ in range(B - 1)] + [y_np])

    # global (B, T) batch: each process materializes it fully and the mesh
    # sharding splits rows over the data axis (process-spanning)
    from jax.sharding import NamedSharding, PartitionSpec as P

    sharding = NamedSharding(mesh, P("data", None))
    ys = jax.make_array_from_callback(
        ys_np.shape, sharding,
        lambda idx: ys_np[idx])

    out = flash_decode_sharded(mesh, logA, logB, logPi, ys,
                               num_segments=4, pipeline=True)

    # check the locally addressable rows against a single-chip decode
    for shard in out.addressable_shards:
        rows = range(*shard.index[0].indices(B))
        for j, b in enumerate(rows):
            ref = np.asarray(flash_decode(logA, logB, logPi,
                                          jnp.asarray(ys_np[b]),
                                          num_segments=4, use_pallas=False))
            got = np.asarray(shard.data)[j]
            assert (got == ref).all(), (b, got[:8], ref[:8])

    with open(os.path.join(outdir, f"ok_{pid}"), "w") as f:
        f.write("ok")


if __name__ == "__main__":
    main()

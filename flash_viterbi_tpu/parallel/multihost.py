"""Multi-host scaffolding: ``jax.distributed`` init + host-aware meshes.

The reference is single-process by construction (pthread shared memory,
SURVEY.md §2.7).  The growth path past one host is the SAME ``shard_map``
program (``parallel.sharded``) over a *global* mesh; the only new
concerns are (a) initializing the distributed runtime and (b) laying the
mesh out so the chatty axes stay inside one host:

* ``state`` — two K-vector all_gathers per trellis step: must NEVER cross
  a process boundary (network latency per step would dominate).
* ``seq``   — one (mb, K) delta ppermute per pipeline *block* (thousands
  of steps apart) + the final path psum: tolerates the network, prefers
  the host's own links.
* ``data``  — zero cross-device traffic: the axis that should span hosts.

:func:`make_global_mesh` therefore sorts devices by process and assigns
them (data-major) so each (seq, state) plane is process-local whenever
the per-process device count allows, and verifies it — refusing silently
host-crossing state axes unless ``allow_dcn_state=True``.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import numpy as np

import jax
from jax.sharding import Mesh

from .sharded import AXES

_initialized = False


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> bool:
    """Join the jax.distributed runtime; returns True if multi-process.

    No-op (returns False) for plain single-process runs, so callers can
    use it unconditionally.  The arguments are always explicit: nothing
    is auto-detected from the environment.
    """
    global _initialized
    if num_processes in (None, 1) and coordinator_address is None:
        return False
    if not _initialized:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
        _initialized = True
    return True


def make_global_mesh(n_data: int | None = None, n_seq: int = 1,
                     n_state: int = 1, allow_dcn_state: bool = False) -> Mesh:
    """(data, seq, state) mesh over ALL processes' devices, data-major.

    Devices are ordered by (process_index, id); the data axis is the
    outermost, so process boundaries fall across ``data`` whenever
    n_seq*n_state divides the per-process device count — the seq/state
    collectives then stay inside each host.
    """
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    n = len(devs)
    inner = n_seq * n_state
    if n_data is None:
        if n % inner:
            raise ValueError(f"{n} devices not divisible by seq*state={inner}")
        n_data = n // inner
    if n_data * inner != n:
        raise ValueError(f"mesh {n_data}x{n_seq}x{n_state} != {n} devices")
    arr = np.asarray(devs, dtype=object).reshape(n_data, n_seq, n_state)
    if jax.process_count() > 1:
        check_plane_locality(arr, allow_dcn_state=allow_dcn_state)
    return Mesh(arr, AXES)


def check_plane_locality(device_arr, allow_dcn_state: bool = False) -> None:
    """Raise unless every (seq, state) plane of a (data, seq, state)
    device array is process-local (the module-docstring layout contract).
    Pure function of ``.process_index`` so the CPU tier can unit-test the
    refusal without a distributed runtime."""
    if allow_dcn_state:
        return
    for d in range(device_arr.shape[0]):
        procs = {dev.process_index for dev in device_arr[d].ravel()}
        if len(procs) > 1:
            raise ValueError(
                f"(seq, state) plane {d} spans processes {sorted(procs)}: "
                "per-step state collectives would cross DCN (the network "
                "between hosts).  Shrink "
                "seq*state to the per-process device count or pass "
                "allow_dcn_state=True.")


def launch_workers(worker: str, n_processes: int, outdir,
                   timeout: float = 240.0) -> list[str]:
    """Run the multi-process CPU rig in fresh OS processes.

    Spawns ``n_processes`` copies of the ``worker`` script (argv: port,
    process_id, n_processes, outdir), each joining ``jax.distributed``
    over a fresh localhost port.  The parent's ``XLA_FLAGS`` device split
    is scrubbed so each worker configures its own virtual devices, and
    ``JAX_PLATFORMS=cpu`` keeps every worker off any GPU (one process per
    card: a worker must never claim the card's memory).  Every worker must exit 0 AND write ``ok_<pid>``
    into ``outdir``; returns the captured stdout of each, raising
    RuntimeError (with the failing worker's tail) otherwise.
    """
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    repo = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # workers set their own device split
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(port), str(pid),
             str(n_processes), str(outdir)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        for pid in range(n_processes)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise RuntimeError("multihost worker timed out")
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"worker {pid} failed:\n{out[-3000:]}")
        if not os.path.exists(os.path.join(str(outdir), f"ok_{pid}")):
            raise RuntimeError(f"worker {pid} wrote no ok-file:\n{out[-2000:]}")
    return outs


def local_batch_slice(global_batch: int) -> slice:
    """Rows of the global (Bs, T) batch owned by this process under the
    data-major layout (data axis split across processes first)."""
    p = jax.process_index()
    n = jax.process_count()
    if global_batch % n:
        raise ValueError(
            f"global batch {global_batch} must be divisible by the "
            f"{n} processes (pad the batch); remainder rows would be "
            "silently dropped otherwise")
    per = global_batch // n
    return slice(p * per, (p + 1) * per)

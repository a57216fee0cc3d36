"""Multi-host runtime: process bring-up + global 'lists' mesh.

SURVEY.md §2.4 prescribes `jax.distributed.initialize` + sharded list
processing end-to-end; the sharded programs (parallel.mesh, parallel.search)
are process-count agnostic — under a multi-process runtime the same
shard_map code spans all hosts, with the coarse/merge all_gathers and the
translation psum riding the interconnect (NCCL between GPUs).

One process per host, standard JAX multi-process model:

    from vector_db_id_compression_tpu.parallel import multihost
    multihost.initialize()                  # no-op for a single process
    mesh = multihost.global_lists_mesh()    # all devices on all hosts
    ...build ShardedIVF(mesh, ...) exactly as on one host...

Each process feeds only its addressable rows of globally-sharded arrays:
`ShardedIVF`'s constructor is process-local by default — it materializes
rows [lo, hi) from `process_shard_bounds`/the sharding's addressable index
map and assembles globals with `jax.make_array_from_process_local_data`
(never `device_put` of full host arrays, which raises for non-addressable
shardings). Results computed after collectives are replicated, so every
host sees the full (D, I).

Coverage: the 8-virtual-device CPU mesh tests (including process-local ==
device_put construction equality, tests/test_parallel.py), a real
two-process CPU cluster (tests/test_multiprocess.py), and
``chip_smoke.py --chips 4``, which runs ShardedIVF over four GPUs of one
host and compares it with the one-GPU run.
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Bring up the JAX distributed runtime when launched multi-process.

    Arguments default from the standard env vars (JAX_COORDINATOR_ADDRESS,
    JAX_NUM_PROCESSES, JAX_PROCESS_ID); with one process and no coordinator
    configured this is a no-op, so the same driver script runs unchanged on
    one machine and on a cluster.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    num_processes = num_processes if num_processes is not None else int(
        os.environ.get("JAX_NUM_PROCESSES", "1"))
    if num_processes <= 1 and coordinator_address is None:
        return  # single-process: nothing to initialize
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=(process_id if process_id is not None
                    else int(os.environ.get("JAX_PROCESS_ID", "0"))),
    )


def global_lists_mesh(n_devices: Optional[int] = None) -> Mesh:
    """1-D 'lists' mesh over every device of every process (jax.devices()
    is global after initialize())."""
    devs = jax.devices()[: n_devices or len(jax.devices())]
    return Mesh(np.array(devs), axis_names=("lists",))


def addressable_row_bounds(mesh: Mesh, n_rows: int) -> tuple[int, int]:
    """[lo, hi) rows of a P('lists')-sharded [n_rows, ...] array owned by
    THIS process's addressable devices — what a process must materialize
    and feed to ``jax.make_array_from_process_local_data``. Rows are
    sharded contiguously (mesh device order == jax.devices() order ==
    process order), so the union of local shards is one contiguous range.
    This is the canonical helper: ShardedIVF's constructor uses it."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    sh = NamedSharding(mesh, P("lists"))
    idxs = [ix[0] for ix in
            sh.addressable_devices_indices_map((n_rows,)).values()]
    starts = [ix.start or 0 for ix in idxs]
    stops = [n_rows if ix.stop is None else ix.stop for ix in idxs]
    lo, hi = min(starts), max(stops)
    spans = sorted(zip(starts, stops))
    cover = spans[0][0]
    for s, e in spans:
        assert s <= cover, "non-contiguous process shard layout"
        cover = max(cover, e)
    return lo, hi


def process_shard_bounds(n_rows: int, mesh: Optional[Mesh] = None
                         ) -> tuple[int, int]:
    """[lo, hi) slice of a lists-sharded global array that THIS process must
    materialize. With a mesh, exact (via the sharding's addressable-device
    index map); without, the uniform contiguous layout the global 'lists'
    mesh produces."""
    if mesh is not None:
        return addressable_row_bounds(mesh, n_rows)
    per = n_rows // jax.process_count()
    p = jax.process_index()
    return p * per, (p + 1) * per if p + 1 < jax.process_count() else n_rows


def host_local_slice(arr: np.ndarray, mesh: Optional[Mesh] = None
                     ) -> np.ndarray:
    """The rows of a global lists-sharded host array this process feeds to
    jax.make_array_from_process_local_data."""
    lo, hi = process_shard_bounds(arr.shape[0], mesh)
    return arr[lo:hi]

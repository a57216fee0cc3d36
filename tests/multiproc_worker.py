"""Worker for tests/test_multiprocess.py: one JAX process of a 2-process
CPU cluster (4 virtual devices each → one global 8-device 'lists' mesh).

Builds the SAME deterministic workload in every process, runs the sharded
codec + the end-to-end ShardedIVF search across processes, and writes this
process's view of the results for the parent test to stitch and compare
against a single-process run. Usage:

    python tests/multiproc_worker.py <coordinator> <num_procs> <pid> <outdir>
"""

import os
import sys

coordinator, num_procs, pid, outdir = (
    sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=4").strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vector_db_id_compression_tpu.parallel import multihost  # noqa: E402

multihost.initialize(coordinator_address=coordinator,
                     num_processes=num_procs, process_id=pid)
assert jax.process_count() == num_procs
assert jax.device_count() == 4 * num_procs

from vector_db_id_compression_tpu.codecs import roc_device as rd  # noqa: E402
from vector_db_id_compression_tpu.parallel.mesh import (  # noqa: E402
    sharded_roc_decode,
    sharded_roc_encode,
    sharded_size_accounting,
)
from vector_db_id_compression_tpu.parallel.search import ShardedIVF  # noqa: E402
from tests.multiproc_workload import build_workload  # noqa: E402

mesh = multihost.global_lists_mesh()
assert mesh.size == 4 * num_procs

wl = build_workload()

# ---- sharded codec: encode + size psum + decode across both processes ----
cap = rd.stack_capacity(wl["n_max"], int(wl["prec"].max()))
states, order = sharded_roc_encode(
    mesh, jnp.asarray(wl["sorted_ids"]), jnp.asarray(wl["lengths"]),
    jnp.asarray(wl["prec"]), cap)
total_bytes, total_ids = sharded_size_accounting(
    mesh, states, jnp.asarray(wl["lengths"]))
decoded = sharded_roc_decode(
    mesh, states, jnp.asarray(wl["lengths"]), jnp.asarray(wl["prec"]),
    wl["n_max"])

# this process's contiguous rows of the lane-sharded outputs
def local_rows(garr):
    shards = sorted(garr.addressable_shards, key=lambda s: s.index[0].start)
    return np.concatenate([np.asarray(s.data) for s in shards], axis=0), \
        int(shards[0].index[0].start)

dec_rows, dec_lo = local_rows(decoded)
stack_rows, _ = local_rows(states.stack)
head_rows, _ = local_rows(states.head)

# ---- end-to-end sharded search across processes --------------------------
index, container = wl["make_index"]()
sh = ShardedIVF(mesh, index, container, process_local=True)
D, I = sh.search(wl["xq"], k=5, nprobe=4)

# ---- roc_pl: the kernel translate built PROCESS-LOCALLY -------------------
# (interpret mode — each process materializes only its rows' lane buffers)
index2, cont2, xq2 = wl["make_index_pl"]()
sh2 = ShardedIVF(mesh, index2, cont2, process_local=True, interpret=True)
assert sh2._kernel is not None, "roc_pl must engage cross-process"
D2, I2 = sh2.search(xq2, k=5, nprobe=4)

np.savez(
    os.path.join(outdir, f"proc{pid}.npz"),
    dec_rows=dec_rows, dec_lo=np.int64(dec_lo),
    stack_rows=stack_rows, head_rows=head_rows,
    total_bytes=np.asarray(total_bytes), total_ids=np.asarray(total_ids),
    D=D, I=I, D2=D2, I2=I2,
)
print(f"proc {pid} done", flush=True)

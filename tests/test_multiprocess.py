"""REAL multi-process distributed coverage (VERDICT r3 item 8): two OS
processes under ``jax.distributed.initialize`` with a local coordinator,
4 virtual CPU devices each → one global 8-device 'lists' mesh spanning
processes. Asserts the gathered codec artifact AND end-to-end search (D, I)
equal the single-process 8-device run — the determinism oracle SURVEY.md §4
prescribes for the distributed backend."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_artifact_and_search_equal_single(tmp_path):
    port = _free_port()
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = str(REPO)
    procs = [
        subprocess.Popen(
            [sys.executable, str(REPO / "tests" / "multiproc_worker.py"),
             f"127.0.0.1:{port}", "2", str(pid), str(tmp_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, cwd=str(REPO))
        for pid in (0, 1)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out[-4000:]}"

    z0 = np.load(tmp_path / "proc0.npz")
    z1 = np.load(tmp_path / "proc1.npz")

    # ---- single-process oracle on the in-test 8-device CPU mesh ----------
    import jax
    import jax.numpy as jnp

    from vector_db_id_compression_tpu.codecs import roc_device as rd
    from vector_db_id_compression_tpu.parallel.mesh import (
        make_lists_mesh,
        sharded_roc_decode,
        sharded_roc_encode,
        sharded_size_accounting,
    )
    from vector_db_id_compression_tpu.parallel.search import ShardedIVF
    from tests.multiproc_workload import build_workload

    assert jax.device_count() == 8
    wl = build_workload()
    mesh = make_lists_mesh()
    cap = rd.stack_capacity(wl["n_max"], int(wl["prec"].max()))
    states, _ = sharded_roc_encode(
        mesh, jnp.asarray(wl["sorted_ids"]), jnp.asarray(wl["lengths"]),
        jnp.asarray(wl["prec"]), cap)
    tb, ti = sharded_size_accounting(mesh, states,
                                     jnp.asarray(wl["lengths"]))
    decoded = np.asarray(sharded_roc_decode(
        mesh, states, jnp.asarray(wl["lengths"]), jnp.asarray(wl["prec"]),
        wl["n_max"]))
    stack = np.asarray(states.stack)
    head = np.asarray(states.head)

    # artifact equality: the 2-process gathered rows == single-process rows
    assert int(z0["dec_lo"]) == 0
    rows0 = z0["dec_rows"].shape[0]
    assert int(z1["dec_lo"]) == rows0
    np.testing.assert_array_equal(
        np.concatenate([z0["dec_rows"], z1["dec_rows"]]), decoded)
    np.testing.assert_array_equal(
        np.concatenate([z0["stack_rows"], z1["stack_rows"]]), stack)
    np.testing.assert_array_equal(
        np.concatenate([z0["head_rows"], z1["head_rows"]]), head)
    assert int(z0["total_bytes"]) == int(z1["total_bytes"]) == int(tb)
    assert int(z0["total_ids"]) == int(z1["total_ids"]) == int(ti)

    # end-to-end search equality: replicated (D, I) identical on both
    # processes and identical to the single-process mesh run
    index, container = wl["make_index"]()
    sh = ShardedIVF(mesh, index, container, process_local=True)
    D, I = sh.search(wl["xq"], k=5, nprobe=4)
    np.testing.assert_array_equal(z0["I"], z1["I"])
    np.testing.assert_array_equal(z0["I"], I)
    np.testing.assert_allclose(z0["D"], D, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(z0["D"], z1["D"], rtol=0, atol=0)

    # roc_pl (kernel translate, process-local lane buffers, interpret
    # mode): both processes agree with the single-process run
    index2, cont2, xq2 = wl["make_index_pl"]()
    sh2 = ShardedIVF(mesh, index2, cont2, process_local=True, interpret=True)
    assert sh2._kernel is not None
    D2, I2 = sh2.search(xq2, k=5, nprobe=4)
    np.testing.assert_array_equal(z0["I2"], z1["I2"])
    np.testing.assert_array_equal(z0["I2"], I2)
    np.testing.assert_allclose(z0["D2"], D2, rtol=1e-6, atol=1e-6)

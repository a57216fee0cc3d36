"""Sharded codec over an 8-device CPU mesh: the N-device artifact must be
bit-identical to the 1-device artifact (determinism is the sanitizer —
SURVEY.md §5)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from vector_db_id_compression_tpu.codecs import roc_device as rd
from vector_db_id_compression_tpu.parallel.mesh import (
    make_lists_mesh,
    sharded_roc_decode,
    sharded_roc_encode,
)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    B, n_max, bits = 16, 200, 18
    ids = np.zeros((B, n_max), dtype=np.uint64)
    lengths = rng.integers(50, n_max + 1, size=B).astype(np.int32)
    prec = np.zeros(B, dtype=np.int32)
    for b in range(B):
        v = np.sort(rng.choice(2**bits - 1, size=lengths[b], replace=False) + 1)
        ids[b, : lengths[b]] = v
        prec[b] = int(v.max()).bit_length()
    return ids, lengths, prec


def test_sharded_encode_matches_single_device(batch):
    ids, lengths, prec = batch
    n_max = ids.shape[1]
    cap = rd.stack_capacity(n_max, int(prec.max()))
    pool = rd.default_pool(n_max)

    # single device
    st1, order1 = rd.roc_encode_batch(
        jnp.asarray(ids), jnp.asarray(lengths), jnp.asarray(prec), pool,
        rd.fresh_states(ids.shape[0], cap),
    )

    mesh = make_lists_mesh(8)
    assert mesh.size == 8, "conftest must provide 8 virtual CPU devices"
    stN, orderN = sharded_roc_encode(
        mesh, jnp.asarray(ids), jnp.asarray(lengths), jnp.asarray(prec), cap
    )
    np.testing.assert_array_equal(np.asarray(stN.head), np.asarray(st1.head))
    np.testing.assert_array_equal(np.asarray(stN.stack), np.asarray(st1.stack))
    np.testing.assert_array_equal(
        np.asarray(stN.stack_len), np.asarray(st1.stack_len)
    )
    np.testing.assert_array_equal(np.asarray(orderN), np.asarray(order1))

    # sharded decode round-trips
    decoded = sharded_roc_decode(
        mesh, stN, jnp.asarray(lengths), jnp.asarray(prec), n_max
    )
    decoded = np.asarray(decoded)
    for b in range(ids.shape[0]):
        n = lengths[b]
        np.testing.assert_array_equal(
            np.sort(decoded[b, :n]), ids[b, :n]
        )


def test_sharded_size_accounting(batch):
    from vector_db_id_compression_tpu.parallel.mesh import (
        sharded_size_accounting,
    )

    ids, lengths, prec = batch
    n_max = ids.shape[1]
    cap = rd.stack_capacity(n_max, int(prec.max()))
    mesh = make_lists_mesh(8)
    states, _ = sharded_roc_encode(
        mesh, jnp.asarray(ids), jnp.asarray(lengths), jnp.asarray(prec), cap)
    total_bytes, total_ids = sharded_size_accounting(
        mesh, states, jnp.asarray(lengths))
    # oracle: host accounting over the gathered states
    want = int(np.where(lengths > 0,
                        8 + 4 * np.asarray(states.stack_len), 0).sum())
    assert int(total_bytes) == want
    assert int(total_ids) == int(lengths.sum())


# ---------------------------------------------------------------------------
# sharded end-to-end search (parallel/search.py)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ivf_setup():
    from vector_db_id_compression_tpu.search.ivf import IndexIVF

    rng = np.random.default_rng(5)
    # nlist > distinct-cluster count so some lists are EMPTY (the 1M sweep
    # exposed the empty-list case in the sharded translation tables)
    d, nlist, nb, nq = 16, 48, 900, 40
    xb = rng.normal(size=(nb, d)).astype(np.float32)
    xq = rng.normal(size=(nq, d)).astype(np.float32)
    index = IndexIVF(d, nlist, storage="flat", nprobe=4)
    index.train(xb[:400])
    index.add(xb)
    # force an EMPTY list (the 1M sweep exposed empty-list handling in the
    # sharded translation tables): merge the smallest list into the largest,
    # keeping per-list ids ascending with codes aligned
    il = index.invlists
    src = int(np.argmin(np.where(il.lengths > 0, il.lengths, 1 << 30)))
    dst = int(np.argmax(il.lengths))
    cs = il.code_size
    ids = np.concatenate([il.ids[dst], il.ids[src]])
    codes = np.concatenate([il.codes[dst].reshape(-1, cs),
                            il.codes[src].reshape(-1, cs)])
    order = np.argsort(ids, kind="stable")
    il.ids[dst], il.codes[dst] = ids[order], codes[order].reshape(-1)
    il.ids[src] = np.empty(0, np.uint64)
    il.codes[src] = np.empty(0, np.uint8)
    index.replace_invlists(il)
    assert (il.lengths == 0).any()
    return index, xq


@pytest.mark.parametrize(
    "mode", ["raw", "roc", "packed-bits", "elias-fano", "wavelet-tree",
             "wavelet-tree-1"])
def test_sharded_search_matches_single_device(ivf_setup, mode):
    """8-device sharded coarse+scan+merge+translate == the single-device
    deferred-decoding search (D and I), for every container's translation
    path (grouped ROC decode, packed/EF random access, replicated WT)."""
    from vector_db_id_compression_tpu.parallel.search import ShardedIVF
    from vector_db_id_compression_tpu.store.invlists import (
        AVAILABLE_COMPRESSED_IVFS,
    )

    index, xq = ivf_setup
    k = 10
    if mode == "raw":
        container = index.invlists
    else:
        container = AVAILABLE_COMPRESSED_IVFS[mode](index.invlists)
    index.replace_invlists(container)
    decode_1by1 = getattr(container, "supports_random_access", True)
    D_ref, I_ref = index.search_defer_id_decoding(
        xq, k, nprobe=4, decode_1by1=decode_1by1)

    mesh = make_lists_mesh(8)
    sh = ShardedIVF(mesh, index, container)
    D, I = sh.search(xq, k, nprobe=4)
    np.testing.assert_array_equal(I, I_ref)
    np.testing.assert_allclose(D, D_ref, rtol=1e-5, atol=1e-5)


def test_sharded_search_pq_storage(ivf_setup):
    """PQ storage rides the sharded decoded-reconstruction scan: 8-device
    results == the host deferred-decoding search on the same PQ index."""
    from vector_db_id_compression_tpu.parallel.search import ShardedIVF
    from vector_db_id_compression_tpu.search.ivf import IndexIVF
    from vector_db_id_compression_tpu.store.invlists import RocInvertedLists

    rng = np.random.default_rng(11)
    d, nlist, nb, nq = 16, 24, 600, 25
    xb = rng.normal(size=(nb, d)).astype(np.float32)
    xq = rng.normal(size=(nq, d)).astype(np.float32)
    index = IndexIVF(d, nlist, storage="pq", pq_m=4, nprobe=4)
    index.train(xb[:400])
    index.add(xb)
    container = RocInvertedLists(index.invlists)
    index.replace_invlists(container)
    assert index._scan_is_float, "PQ should decode to f32 at this scale"
    D_ref, I_ref = index.search_defer_id_decoding(
        xq, 8, nprobe=4, decode_1by1=False)

    sh = ShardedIVF(make_lists_mesh(8), index, container)
    D, I = sh.search(xq, 8, nprobe=4)
    np.testing.assert_array_equal(I, I_ref)
    np.testing.assert_allclose(D, D_ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mode", ["raw", "roc", "elias-fano"])
def test_process_local_ctor_matches_device_put(ivf_setup, mode):
    """The process-local construction path (make_array_from_process_local_data
    fed with this process's rows — the multi-process default) must produce
    identical D/I to the legacy full-host-array device_put path on the same
    8-device mesh (single-process: local rows == all rows)."""
    from vector_db_id_compression_tpu.parallel.search import ShardedIVF
    from vector_db_id_compression_tpu.store.invlists import (
        AVAILABLE_COMPRESSED_IVFS,
    )

    index, xq = ivf_setup
    container = (index.invlists if mode == "raw"
                 else AVAILABLE_COMPRESSED_IVFS[mode](index.invlists))
    index.replace_invlists(container)
    mesh = make_lists_mesh(8)
    sh_pl = ShardedIVF(mesh, index, container)  # process-local (default)
    sh_dp = ShardedIVF(mesh, index, container, process_local=False)
    D_pl, I_pl = sh_pl.search(xq, 10, nprobe=4)
    D_dp, I_dp = sh_dp.search(xq, 10, nprobe=4)
    np.testing.assert_array_equal(I_pl, I_dp)
    np.testing.assert_allclose(D_pl, D_dp, rtol=1e-6)


def test_sharded_search_pq_lut_scan(ivf_setup):
    """Past the PQ decode budget the sharded scan falls back to the u8
    code payload + LUT gather-sum (the host path's VDBIDC_PQ_DECODE_SCAN=0
    policy — ADVICE r2) and must still match the host search."""
    import os

    from vector_db_id_compression_tpu.parallel.search import ShardedIVF
    from vector_db_id_compression_tpu.search.ivf import IndexIVF
    from vector_db_id_compression_tpu.store.invlists import RocInvertedLists

    rng = np.random.default_rng(13)
    d, nlist, nb, nq = 16, 24, 600, 25
    xb = rng.normal(size=(nb, d)).astype(np.float32)
    xq = rng.normal(size=(nq, d)).astype(np.float32)
    index = IndexIVF(d, nlist, storage="pq", pq_m=4, nprobe=4)
    index.train(xb[:400])
    index.add(xb)
    container = RocInvertedLists(index.invlists)
    os.environ["VDBIDC_PQ_DECODE_SCAN"] = "0"
    try:
        index.replace_invlists(container)
        assert not index._scan_is_float
        D_ref, I_ref = index.search_defer_id_decoding(
            xq, 8, nprobe=4, decode_1by1=False)
        sh = ShardedIVF(make_lists_mesh(8), index, container)
        assert not sh._scan_is_float
        D, I = sh.search(xq, 8, nprobe=4)
    finally:
        del os.environ["VDBIDC_PQ_DECODE_SCAN"]
    np.testing.assert_array_equal(I, I_ref)
    np.testing.assert_allclose(D, D_ref, rtol=1e-4, atol=1e-4)


def test_sharded_search_device_count_invariant(ivf_setup):
    """N-device == 1-device results, the §2.4 determinism contract applied
    to the search path."""
    from vector_db_id_compression_tpu.parallel.search import ShardedIVF
    from vector_db_id_compression_tpu.store.invlists import RocInvertedLists

    index, xq = ivf_setup
    container = RocInvertedLists(index.invlists)
    index.replace_invlists(container)
    sh1 = ShardedIVF(make_lists_mesh(1), index, container)
    sh8 = ShardedIVF(make_lists_mesh(8), index, container)
    D1, I1 = sh1.search(xq, 10, nprobe=4)
    D8, I8 = sh8.search(xq, 10, nprobe=4)
    np.testing.assert_array_equal(I1, I8)
    np.testing.assert_allclose(D1, D8, rtol=1e-6)


def test_roc_pallas_translate_interpret_process_local():
    """The fused roc_pl translate (one decode-kernel call over every local
    lane) in interpret mode, on a 2-device mesh with 50 lanes per shard —
    the kernel wrapper pads them — through the process-local construction
    path with mesh-sharded kernel buffers. Results must equal the host
    container search exactly."""
    from vector_db_id_compression_tpu.parallel.search import ShardedIVF
    from vector_db_id_compression_tpu.search.ivf import IndexIVF
    from vector_db_id_compression_tpu.store.invlists import RocInvertedLists

    rng = np.random.default_rng(17)
    d, nlist, nb, nq = 8, 100, 2600, 16
    xb = rng.normal(size=(nb, d)).astype(np.float32)
    xq = rng.normal(size=(nq, d)).astype(np.float32)
    index = IndexIVF(d, nlist, storage="flat", nprobe=4)
    index.train(xb[:1200], niter=5)
    index.add(xb)
    container = RocInvertedLists(index.invlists)
    index.replace_invlists(container)
    D_ref, I_ref = index.search_defer_id_decoding(
        xq, 5, nprobe=4, decode_1by1=False)

    sh = ShardedIVF(make_lists_mesh(2), index, container, interpret=True)
    assert sh._kernel is not None, "interpret-mode roc_pl must engage"
    assert sh.b_loc == 50
    D, I = sh.search(xq, 5, nprobe=4)
    np.testing.assert_array_equal(I, I_ref)
    np.testing.assert_allclose(D, D_ref, rtol=1e-5, atol=1e-5)

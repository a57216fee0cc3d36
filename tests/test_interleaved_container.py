"""InterleavedRocInvertedLists: multiset round-trip, code co-reordering,
rate accounting, and search equality vs the single-stream ROC container."""

import numpy as np
import pytest

from vector_db_id_compression_tpu.search.ivf import IndexIVF
from vector_db_id_compression_tpu.store.invlists import (
    InterleavedRocInvertedLists,
    InvertedLists,
    RocInvertedLists,
)


def make_il(nlist=6, ntotal=3000, code_size=4, seed=0):
    rng = np.random.default_rng(seed)
    assign = rng.integers(0, nlist, ntotal)
    codes = rng.integers(0, 256, (ntotal, code_size), dtype=np.uint8)
    il = InvertedLists(nlist, code_size)
    for ln in range(nlist):
        members = np.flatnonzero(assign == ln).astype(np.uint64)
        il.add_entries(ln, members, codes[members].reshape(-1))
    return il, codes


def test_round_trip_and_codes():
    il, codes = make_il()
    c = InterleavedRocInvertedLists(il, interleave=4, interleave_min=64)
    ids, lens = c.decode_lists(np.arange(il.nlist))
    for ln in range(il.nlist):
        got = ids[ln, : lens[ln]]
        np.testing.assert_array_equal(np.sort(got), np.sort(il.ids[ln]))
        # codes must be co-reordered to decode order
        dec_codes = c.get_codes(ln).reshape(-1, il.code_size)
        np.testing.assert_array_equal(dec_codes,
                                      codes[got.astype(np.int64)])


def test_rate_close_to_single_stream():
    il, _ = make_il(nlist=2, ntotal=8000)
    single = RocInvertedLists(il)
    multi = InterleavedRocInvertedLists(il, interleave=8, interleave_min=64)
    s = single.compressed_ids_size_in_bytes
    m = multi.compressed_ids_size_in_bytes + multi.overhead_in_bytes
    assert m <= s * 1.15 + 2 * 8 * 24, (m, s)


def test_short_lists_stay_single_stream():
    il, _ = make_il(nlist=8, ntotal=400)  # ~50/list < interleave_min
    c = InterleavedRocInvertedLists(il, interleave=4, interleave_min=4096)
    for ln in range(il.nlist):
        assert len(c._entries_of[ln]) <= 1 or il.lengths[ln] >= 4096
    ref = RocInvertedLists(il)
    # single-stream entries are bit-identical to the plain container
    assert c.compressed_ids_size_in_bytes == ref.compressed_ids_size_in_bytes


def test_auto_policy():
    """interleave='auto' (the default): lists past 1.5x AUTO_CHUNK_TARGET
    split into ceil(n/target) lanes, short lists stay single-stream
    bit-exact, and the round-trip holds."""
    il, _ = make_il(nlist=3, ntotal=3000)  # ~1000/list > 768
    tgt = InterleavedRocInvertedLists.AUTO_CHUNK_TARGET
    c = InterleavedRocInvertedLists(il)
    assert c.interleave == "auto"
    for ln in range(il.nlist):
        n = int(il.lengths[ln])
        want = -(-n // tgt) if n > (3 * tgt) // 2 else 1
        assert len(c._entries_of[ln]) == want, (ln, n)
    ids, lens = c.decode_lists(np.arange(il.nlist))
    for ln in range(il.nlist):
        np.testing.assert_array_equal(
            np.sort(ids[ln, : lens[ln]]), np.sort(il.ids[ln]))

    il2, _ = make_il(nlist=8, ntotal=400)  # ~50/list, under the threshold
    c2 = InterleavedRocInvertedLists(il2)
    ref = RocInvertedLists(il2)
    assert c2.compressed_ids_size_in_bytes == ref.compressed_ids_size_in_bytes


def test_search_equality_vs_plain_roc():
    rng = np.random.default_rng(5)
    xb = rng.normal(size=(3000, 8)).astype(np.float32)
    xq = rng.normal(size=(20, 8)).astype(np.float32)
    index = IndexIVF(8, 4, storage="flat")
    index.train(xb[:1000], niter=5)
    index.add(xb)
    index.replace_invlists(RocInvertedLists(index.invlists))
    D1, I1 = index.search_defer_id_decoding(xq, 10, nprobe=2,
                                            decode_1by1=False)
    index.replace_invlists(
        InterleavedRocInvertedLists(index.invlists, interleave=4,
                                    interleave_min=64))
    D2, I2 = index.search_defer_id_decoding(xq, 10, nprobe=2,
                                            decode_1by1=False)
    # same distances always; ids may swap only between equal distances
    np.testing.assert_allclose(D1, D2, rtol=1e-5)
    swap_ok = (I1 == I2) | np.isclose(D1, D2, rtol=1e-5)
    assert swap_ok.all()


def test_prepared_interleaved_translate_interpret():
    """Single-kernel interleaved decode_select (chunk-lane mapping in
    closed form) must equal the grouped per-bucket path — interpret mode
    covers the GPU kernel's program on the CPU."""
    import numpy as np

    from vector_db_id_compression_tpu.store import invlists as inv_mod
    from vector_db_id_compression_tpu.store.invlists import (
        InterleavedRocInvertedLists,
        InvertedLists,
    )

    rng = np.random.default_rng(23)
    nlist, code_size = 10, 2
    il = InvertedLists(nlist, code_size)
    sizes = [0, 3, 17, 40, 41, 43, 8, 97, 100, 5]
    pool_ids = rng.choice(1 << 20, size=sum(sizes), replace=False)
    pos = 0
    for ln, nsz in enumerate(sizes):
        ids = pool_ids[pos: pos + nsz].astype(np.uint64)
        pos += nsz
        il.add_entries(ln, ids,
                       rng.integers(0, 256, nsz * code_size).astype(np.uint8))
    comp = InterleavedRocInvertedLists(il, interleave=4, interleave_min=16)

    lns, offs = [], []
    for ln, nsz in enumerate(sizes):
        if nsz == 0:
            continue
        take = rng.integers(0, nsz, size=min(nsz, 7))
        lns += [ln] * len(take)
        offs += list(take)
    lns = np.array(lns, np.int64)
    offs = np.array(offs, np.int64)

    expect = inv_mod.CompressedInvertedLists.decode_select(comp, lns, offs)
    prep = inv_mod._prepared_translate(comp, interpret=True)
    assert prep is not None
    got = inv_mod._translate_prepared(prep, lns, offs)
    np.testing.assert_array_equal(got, expect)

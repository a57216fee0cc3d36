"""Compressed inverted-list containers: per-list multiset equality vs the
uncompressed source, (id, code) pair consistency under reordering, size
accounting, random access — the reference's oracle pattern
(test_compressed_ivfs.py TestCompressedIDInvertedLists)."""

import numpy as np
import pytest

from vector_db_id_compression_tpu.store.invlists import (
    EliasFanoInvertedLists,
    InvertedLists,
    PackedBitsInvertedLists,
    RocInvertedLists,
    WaveletTreeInvertedLists,
)

CODE_SIZE = 4


def _make_source(rng, nlist=16, ntotal=800, ascending=True):
    il = InvertedLists(nlist, CODE_SIZE)
    assignment = rng.integers(0, nlist, size=ntotal)
    for ln in range(nlist):
        ids = np.flatnonzero(assignment == ln).astype(np.uint64)
        codes = rng.integers(0, 256, size=len(ids) * CODE_SIZE).astype(np.uint8)
        il.add_entries(ln, ids, codes)
    return il


def _pairs(ids, codes_flat):
    codes = codes_flat.reshape(-1, CODE_SIZE)
    return sorted((int(i), bytes(c)) for i, c in zip(ids, codes))


ALL_VARIANTS = [
    PackedBitsInvertedLists,
    RocInvertedLists,
    EliasFanoInvertedLists,
    WaveletTreeInvertedLists,
    lambda il: WaveletTreeInvertedLists(il, wt_type=1),
]


@pytest.mark.parametrize("variant", ALL_VARIANTS)
def test_multiset_and_pair_equality(variant):
    rng = np.random.default_rng(0)
    il = _make_source(rng)
    comp = variant(il)
    for ln in range(il.nlist):
        src_ids = il.ids[ln]
        got = comp.get_ids(ln)
        assert comp.list_size(ln) == len(src_ids)
        np.testing.assert_array_equal(np.sort(got), np.sort(src_ids))
        # decoded order must match the stored (possibly reordered) codes
        assert _pairs(got, comp.get_codes(ln)) == _pairs(src_ids, il.codes[ln])


@pytest.mark.parametrize("variant", ALL_VARIANTS)
def test_grouped_decode(variant):
    rng = np.random.default_rng(1)
    il = _make_source(rng, nlist=24, ntotal=1200)
    comp = variant(il)
    query = np.array([3, 17, 3, 0, 23, 11])
    ids, lens = comp.decode_lists(query)
    for q, ln in enumerate(query):
        np.testing.assert_array_equal(
            np.sort(ids[q, : lens[q]]), np.sort(il.ids[ln])
        )
        assert (ids[q, lens[q]:] == 0).all()


@pytest.mark.parametrize(
    "variant",
    [PackedBitsInvertedLists, EliasFanoInvertedLists, WaveletTreeInvertedLists],
)
def test_random_access(variant):
    rng = np.random.default_rng(2)
    il = _make_source(rng)
    comp = variant(il)
    assert comp.supports_random_access
    lns, offs, expect = [], [], []
    for ln in range(il.nlist):
        decoded = comp.get_ids(ln)  # offsets refer to the container's order
        for k in range(0, len(decoded), 5):
            lns.append(ln); offs.append(k); expect.append(int(decoded[k]))
    got = comp.get_single_ids_batch(np.array(lns), np.array(offs))
    np.testing.assert_array_equal(got, np.array(expect, dtype=np.uint64))


def test_roc_has_no_random_access():
    rng = np.random.default_rng(3)
    comp = RocInvertedLists(_make_source(rng))
    assert not comp.supports_random_access
    with pytest.raises(NotImplementedError):
        comp.get_single_id(0, 0)


def test_size_accounting_sane():
    rng = np.random.default_rng(4)
    il = _make_source(rng, nlist=8, ntotal=2000)
    ntotal = 2000
    packed = PackedBitsInvertedLists(il)
    roc = RocInvertedLists(il)
    ef = EliasFanoInvertedLists(il)
    wt = WaveletTreeInvertedLists(il)
    raw = ntotal * 8  # 8-byte ids
    # every codec beats raw ids; roc/ef/wt beat packed bits on this layout
    for c in (packed, roc, ef, wt):
        assert 0 < c.compressed_ids_size_in_bytes < raw
    assert roc.compressed_ids_size_in_bytes < packed.compressed_ids_size_in_bytes
    assert ef.compressed_ids_size_in_bytes < packed.compressed_ids_size_in_bytes
    # packed size formula exact: sum over lists of (ls*bits+7)//8
    bits = packed.bits
    assert packed.compressed_ids_size_in_bytes == sum(
        (il.list_size(ln) * bits + 7) // 8 for ln in range(il.nlist)
    )


def test_empty_lists_handled():
    il = InvertedLists(4, CODE_SIZE)
    il.add_entries(1, np.array([0, 2, 5], dtype=np.uint64),
                   (np.arange(3 * CODE_SIZE) % 256).astype(np.uint8))
    il.add_entries(3, np.array([1, 3, 4], dtype=np.uint64),
                   (np.arange(3 * CODE_SIZE) % 256).astype(np.uint8))
    for variant in ALL_VARIANTS:
        comp = variant(il)
        assert comp.list_size(0) == 0
        np.testing.assert_array_equal(np.sort(comp.get_ids(1)), [0, 2, 5])
        np.testing.assert_array_equal(np.sort(comp.get_ids(3)), [1, 3, 4])


def test_prepared_container_translate_interpret():
    """The whole-container kernel translate (single-kernel decode_select)
    must match the per-bucket chain exactly — run through interpret mode so
    the CPU tests cover the GPU kernel's program."""
    from vector_db_id_compression_tpu.store import invlists as inv_mod

    rng = np.random.default_rng(11)
    il = _make_source(rng, nlist=12, ntotal=400)
    comp = RocInvertedLists(il)

    # labels across every non-empty list, mixed offsets, duplicates included
    lens = comp.lengths
    lns, offs = [], []
    for ln in range(il.nlist):
        n = int(lens[ln])
        if n == 0:
            continue
        take = rng.integers(0, n, size=min(n, 5))
        lns += [ln] * len(take)
        offs += list(take)
    lns = np.array(lns, np.int64)
    offs = np.array(offs, np.int64)

    expect = inv_mod.CompressedInvertedLists.decode_select(comp, lns, offs)
    prep = inv_mod._prepared_translate(comp, interpret=True)
    assert prep is not None, "interpret-mode prep must build on CPU"
    got = inv_mod._translate_prepared(prep, lns, offs)
    np.testing.assert_array_equal(got, expect)
    # the CPU route of decode_select is the per-bucket XLA chain
    assert inv_mod._prepared_translate(comp) is None
    np.testing.assert_array_equal(comp.decode_select(lns, offs), expect)

    # empty query is safe
    assert len(inv_mod._translate_prepared(
        prep, np.zeros(0, np.int64), np.zeros(0, np.int64))) == 0

"""The device ROC encoder that builds indexes without the native library
(``codecs.roc_device.roc_encode_batch``, the XLA scan): bit-exact states and
sampling order vs the host oracle and the native C++ encoder, and a full
encode -> kernel-decode round trip (decode kernel in interpret mode)."""

import jax.numpy as jnp
import numpy as np
import pytest

from vector_db_id_compression_tpu import native
from vector_db_id_compression_tpu.codecs import roc_device as rd
from vector_db_id_compression_tpu.codecs.roc import (
    precision_for_max_id_safe,
    roc_encode,
)
from vector_db_id_compression_tpu.ops.roc_pallas import roc_decode_pallas


def _workload(seed, n_lists, max_len, id_bits):
    rng = np.random.default_rng(seed)
    lists, lengths = [], []
    for _ in range(n_lists):
        n = int(rng.integers(2, max_len))
        lists.append(np.sort(rng.choice(1 << id_bits, size=n,
                                        replace=False).astype(np.uint64)))
        lengths.append(n)
    n_max = max(lengths)
    ids = np.zeros((n_lists, n_max), dtype=np.uint64)
    for i, l in enumerate(lists):
        ids[i, : len(l)] = l
    prec = np.array([precision_for_max_id_safe(int(l[-1])) for l in lists],
                    np.int32)
    return lists, ids, np.array(lengths, np.int32), prec


def _encode(ids, lengths, prec):
    n_max = ids.shape[1]
    maxp = int(prec.max())
    states, order = rd.roc_encode_batch(
        jnp.asarray(ids), jnp.asarray(lengths), jnp.asarray(prec),
        rd.default_pool(n_max),
        rd.fresh_states(len(lengths), rd.stack_capacity(n_max, maxp)),
        rd.n_slices_for(maxp))
    assert not bool(np.asarray(states.err).any())
    return states, np.asarray(order)


def _assert_matches_host(lists, prec, states, order=None):
    heads = np.asarray(states.head)
    stacks = np.asarray(states.stack)
    lens = np.asarray(states.stack_len)
    mts = np.asarray(states.mt_ctr)
    for i, l in enumerate(lists):
        st, want_order = roc_encode(l, int(prec[i]))
        assert heads[i] == st.head, i
        assert lens[i] == len(st.stack), i
        np.testing.assert_array_equal(
            stacks[i, : lens[i]], np.array(st.stack, dtype=np.uint32))
        assert mts[i] == st.mt_draws, i
        if order is not None:
            # host roc_encode input is the raw (sorted here) list, so its
            # order permutation is directly comparable
            np.testing.assert_array_equal(order[i, : len(l)], want_order)


@pytest.mark.parametrize("id_bits", [10, 14, 20])
def test_encode_bit_exact_vs_host(id_bits):
    lists, ids, lengths, prec = _workload(id_bits, 6, 60, id_bits)
    states, order = _encode(ids, lengths, prec)
    _assert_matches_host(lists, prec, states, order)
    if native.available():
        heads, stacks, lens, orders, mt = native.roc_encode_lists(
            lists, prec, cap=np.asarray(states.stack).shape[1])
        np.testing.assert_array_equal(heads, np.asarray(states.head))
        np.testing.assert_array_equal(lens, np.asarray(states.stack_len))
        np.testing.assert_array_equal(stacks, np.asarray(states.stack))
        for i, l in enumerate(lists):
            np.testing.assert_array_equal(orders[i], order[i, : len(l)])


def test_encode_then_pallas_decode_round_trip():
    lists, ids, lengths, prec = _workload(99, 8, 80, 16)
    states, order = _encode(ids, lengths, prec)
    n_max = ids.shape[1]
    decoded, ok = roc_decode_pallas(states, lengths, prec,
                                    rd.default_pool(n_max), n_max,
                                    interpret=True)
    assert ok
    for i, l in enumerate(lists):
        n = len(l)
        # decode order == encode sampling order
        np.testing.assert_array_equal(decoded[i, :n].astype(np.uint64),
                                      l[order[i, :n]])


def test_mt_underflow_lane():
    """A tiny list: two pops from the initial head, whose refill would draw
    MT19937 initial bits — head and draw count match the host oracle."""
    l = np.array([5, 11], dtype=np.uint64)
    states, _ = _encode(l[None, :], np.array([2], np.int32),
                        np.array([4], np.int32))
    st, _ = roc_encode(l, 4)
    assert int(np.asarray(states.head)[0]) == st.head
    assert int(np.asarray(states.mt_ctr)[0]) == st.mt_draws


def test_8bit_digit_division_path(monkeypatch):
    """Lists of 2^16 ids and more divide the 64-bit head in 8-bit digits
    (16-bit digits would overflow the u32 remainder). Force the 8-bit path
    on a small workload and assert bit-exactness against the host oracle."""
    monkeypatch.setattr(rd, "digit_bits_for", lambda n_max: 8)
    rd.roc_encode_batch.clear_cache()
    try:
        lists, ids, lengths, prec = _workload(7, 4, 50, 12)
        states, _ = _encode(ids, lengths, prec)
        _assert_matches_host(lists, prec, states)
    finally:
        rd.roc_encode_batch.clear_cache()

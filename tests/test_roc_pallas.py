"""ROC decode kernel (ops/roc_pallas.py) in Pallas interpret mode on the
CPU: bit-exact vs the XLA scan decoder, hence vs the C++ reference. The
same kernel compiled for the card is checked by the ``gpu`` test below and
by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vector_db_id_compression_tpu.codecs import roc_device as rd
from vector_db_id_compression_tpu.codecs.roc import precision_for_max_id_safe
from vector_db_id_compression_tpu.ops import roc_pallas as rp
from vector_db_id_compression_tpu.ops.roc_pallas import roc_decode_pallas


def _encode_batch(rng, sizes, bits):
    n_max = max(sizes)
    B = len(sizes)
    ids = np.zeros((B, n_max), dtype=np.uint64)
    prec = np.zeros(B, dtype=np.int32)
    for b, n in enumerate(sizes):
        v = np.sort(rng.choice(2**bits - 1, size=n, replace=False).astype(np.uint64) + 1)
        ids[b, :n] = v
        prec[b] = precision_for_max_id_safe(int(v.max()))
    lengths = np.array(sizes, dtype=np.int32)
    maxp = int(prec.max())
    cap = rd.stack_capacity(n_max, maxp)
    pool = rd.default_pool(n_max)
    states, _ = rd.roc_encode_batch(
        jnp.asarray(ids), jnp.asarray(lengths), jnp.asarray(prec), pool,
        rd.fresh_states(B, cap), rd.n_slices_for(maxp),
    )
    return ids, lengths, prec, states, pool, n_max, maxp


def _xla_decode(states, lengths, prec, pool, n_max, maxp):
    ids, _ = rd.roc_decode_batch(
        states, jnp.asarray(lengths), jnp.asarray(prec), pool, n_max,
        rd.n_slices_for(maxp),
    )
    return np.asarray(ids)


@pytest.mark.parametrize(
    "sizes,bits",
    [([64], 16), ([1, 5, 128, 37], 16), ([513, 2, 300], 20), ([1000] * 3, 24)],
)
def test_pallas_decode_bit_exact(sizes, bits):
    rng = np.random.default_rng(sum(sizes) + bits)
    ids, lengths, prec, states, pool, n_max, maxp = _encode_batch(rng, sizes, bits)
    ref_ids = _xla_decode(states, lengths, prec, pool, n_max, maxp)

    got, ok = roc_decode_pallas(
        states, lengths, prec, pool, n_max, interpret=True
    )
    assert ok
    np.testing.assert_array_equal(got, ref_ids)


def test_pallas_decode_emit_rev_matches():
    """The kernel's raw output is in decode-iteration order: element j of
    lane b sits at emit row length-1-j — the layout the fused translate
    stages gather from — and the wrapper pads 4 lanes to a full block."""
    rng = np.random.default_rng(7)
    sizes, bits = [700, 3, 513, 64], 20
    ids, lengths, prec, states, pool, n_max, maxp = _encode_batch(
        rng, sizes, bits)
    dec = rp.RocPallasDecoder(states, lengths, prec, pool, n_max)
    fwd, ok = dec.decode(interpret=True)
    assert ok
    emit, err = rp.run_kernel(dec.buf, dec.head, dec.ptr, dec.lens,
                              dec.prec, n_max=n_max, interpret=True)
    assert not bool(err)
    emit = np.asarray(emit)
    assert emit.shape == (1, n_max, len(sizes))
    fwd = np.asarray(fwd)
    for b, n in enumerate(sizes):
        np.testing.assert_array_equal(emit[0, :n, b][::-1], fwd[b, :n])
        assert (fwd[b, n:] == 0).all()


def test_pallas_chained_decode_bit_exact():
    """Chained slots (2-D lengths) match the XLA chained decoder on the
    RocBlockGraph format (S multisets threaded through one state)."""
    rng = np.random.default_rng(11)
    L, S, K, bits = 5, 4, 16, 18
    ids = np.zeros((L, S, K), dtype=np.uint64)
    degs = np.zeros((L, S), dtype=np.int32)
    prec = np.ones((L, S), dtype=np.int32)
    for b in range(L):
        for s in range(S):
            n = int(rng.integers(0, K + 1))
            degs[b, s] = n
            if n == 0:
                continue
            v = np.sort(rng.choice(2**bits - 1, size=n,
                                   replace=False).astype(np.uint64) + 1)
            ids[b, s, :n] = v
            prec[b, s] = precision_for_max_id_safe(int(v.max()))
    maxp = int(prec.max())
    n_sl = rd.n_slices_for(maxp)
    cap = rd.stack_capacity(S * K, maxp)
    pool = rd.default_pool(S * K)
    states = rd.roc_encode_chained(
        jnp.asarray(ids), jnp.asarray(degs), jnp.asarray(prec), pool,
        rd.fresh_states(L, cap), n_sl)
    assert not bool(np.asarray(states.err).any())

    ref, _ = rd.roc_decode_chained(
        states, jnp.asarray(degs), jnp.asarray(prec), pool, K, n_sl)
    ref = np.asarray(ref)

    dec = rp.RocPallasDecoder(states, degs, prec, pool, K)
    got, ok = dec.decode(interpret=True)
    assert ok
    np.testing.assert_array_equal(np.asarray(got).astype(np.uint64), ref)

    # traced subset entry (the in-traversal fetch path), repeats included
    idx = np.array([3, 3, 0, 4], dtype=np.int32)
    sub = jax.jit(lambda i: dec.decode_lanes(i, interpret=True))(
        jnp.asarray(idx))
    np.testing.assert_array_equal(np.asarray(sub).astype(np.uint64), ref[idx])


@pytest.mark.parametrize("n_lanes,expect", [(64, 8), (1024, 8), (8692, 32),
                                            (4224, 16), (20000, 64)])
def test_lanes_per_program(n_lanes, expect):
    """Few lanes -> narrow blocks so the programs still cover the SMs."""
    assert rp.lanes_per_program(n_lanes) == expect


@pytest.mark.gpu
def test_kernel_on_gpu_matches_xla(gpu_device):
    """The kernel compiled for the card (no interpret mode) is bit-exact
    with the XLA scan decoder."""
    rng = np.random.default_rng(5)
    sizes, bits = [900, 17, 256, 1], 22
    with jax.default_device(gpu_device):
        ids, lengths, prec, states, pool, n_max, maxp = _encode_batch(
            rng, sizes, bits)
        ref_ids = _xla_decode(states, lengths, prec, pool, n_max, maxp)
        got, ok = roc_decode_pallas(states, lengths, prec, pool, n_max)
    assert ok
    np.testing.assert_array_equal(got, ref_ids)

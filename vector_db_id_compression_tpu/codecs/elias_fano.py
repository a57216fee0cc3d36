"""Elias-Fano monotone-sequence codec, batched for device decode.

Parameter-compatible with the reference's modified succinct elias_fano
(elias_fano.hpp:16-283):
  - low-bit width  l = floor(log2(n // m)) for m>0 and n//m>0 else 0, where
    n = universe (max id) and m = element count (elias_fano.hpp:28);
  - low bits: m*l bits, each id's low l bits LSB-first (elias_fano.hpp:35-46);
  - high bits: bitvector of (m+1) + (n >> l) + 1 bits with a set bit at
    (id >> l) + i for the i-th id (elias_fano.hpp:43);
  - select(k) = ((select1(high, k) - k) << l) | low[k] (elias_fano.hpp:141-145);
  - reported compressed size = high_bits + low_bits in bits
    (custom_invlists_impl.cpp:277-282 sums them per list, then /8).

Host (`ef_encode_lists`): fully vectorized numpy build — Elias-Fano encoding
has no sequential dependency, so unlike ROC it needs no scan at all.
Device (`EliasFanoBatch`): packed words + sampled superblock select directory
per lane (core.bits, one i32 per 512 bits — darray-class overhead, the
batched shape of elias_fano.hpp:141-145's darray1). The full-list sweep (`ef_decode_all`) replaces the reference's
word-buffered select_enumerator (elias_fano.hpp:210-261) with one dense
cumsum/scatter over the high bitvector — every element of every lane decoded
in a single fused XLA program. Random-access `ef_select` vectorizes over
(lane, k) query pairs for deferred 1-by-1 ID translation.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..core.bits import (
    BitVectorBatch,
    build_bitvector_batch,
    np_pack_fixed,
    np_set_bits,
    select1_batch,
)


def ef_low_width(universe: int, m: int) -> int:
    """floor(log2(universe // m)) — reference elias_fano.hpp:28."""
    if m == 0 or universe // m == 0:
        return 0
    return (universe // m).bit_length() - 1


class EFList(NamedTuple):
    """One encoded list (host arrays)."""

    high_words: np.ndarray  # u32
    low_words: np.ndarray   # u32
    l: int
    m: int
    universe: int
    high_bits: int

    @property
    def size_in_bits(self) -> int:
        return self.high_bits + self.m * self.l


def ef_encode_list(sorted_ids: np.ndarray) -> EFList:
    """Encode one ascending id list. Vectorized, no per-element loop."""
    ids = np.asarray(sorted_ids, dtype=np.uint64)
    m = len(ids)
    if m == 0:
        return EFList(np.zeros(1, np.uint32), np.zeros(1, np.uint32), 0, 0, 0, 0)
    universe = int(ids[-1])
    l = ef_low_width(universe, m)
    high_bits = (m + 1) + (universe >> l) + 1
    positions = (ids >> np.uint64(l)).astype(np.int64) + np.arange(m, dtype=np.int64)
    high_words = np_set_bits(positions, high_bits)
    low_words = np_pack_fixed(ids & np.uint64((1 << l) - 1), l)
    return EFList(high_words, low_words, l, m, universe, high_bits)


class EliasFanoBatch(NamedTuple):
    """B encoded lists padded to common word counts, device-resident."""

    high: BitVectorBatch   # words u32[B, HW]
    low_words: jax.Array   # u32[B, LW]
    l: jax.Array           # i32[B]
    m: jax.Array           # i32[B]

    @property
    def batch(self) -> int:
        return self.low_words.shape[0]


def batch_ef_lists(lists: Sequence[EFList]) -> EliasFanoBatch:
    B = len(lists)
    hw = max(max(len(e.high_words) for e in lists), 1)
    lw = max(max(len(e.low_words) for e in lists), 1)
    high = np.zeros((B, hw), dtype=np.uint32)
    low = np.zeros((B, lw), dtype=np.uint32)
    l = np.zeros(B, dtype=np.int32)
    m = np.zeros(B, dtype=np.int32)
    nbits = np.zeros(B, dtype=np.int32)
    for b, e in enumerate(lists):
        high[b, : len(e.high_words)] = e.high_words
        low[b, : len(e.low_words)] = e.low_words
        l[b], m[b], nbits[b] = e.l, e.m, e.high_bits
    return EliasFanoBatch(
        high=build_bitvector_batch(jnp.asarray(high), jnp.asarray(nbits)),
        low_words=jnp.asarray(low),
        l=jnp.asarray(l),
        m=jnp.asarray(m),
    )


# low-words rows at or under this width read their three-word window by a
# dense in-row compare+reduce instead of three minor-dim element gathers —
# the graph-adjacency shape (K<=64 neighbors, l<=16 -> W<=32 words) sits
# under it, and dense forms avoid per-element gathers (same trade as the
# count-select form below and the WT superblock row windows)
_EF_DENSE_LOW_WORDS = 32


def _low_fields_dyn(words: jax.Array, l: jax.Array, lane: jax.Array, k: jax.Array) -> jax.Array:
    """Read the k-th l[lane]-bit LSB-first field; per-lane dynamic width
    (l <= 63). Three-word window covers any (offset, width)."""
    W = words.shape[1]
    lw = l[lane].astype(jnp.int64)
    start = k.astype(jnp.int64) * lw
    w0 = (start >> 5).astype(jnp.int32)
    off = (start & 31).astype(jnp.uint64)
    if W <= _EF_DENSE_LOW_WORDS:
        roww = words[lane]  # row gather: contiguous words, major-dim index
        widx = jnp.arange(W, dtype=jnp.int32)

        def sel(t):
            t = jnp.clip(t, 0, W - 1)
            return jnp.sum(
                jnp.where(widx == t[..., None], roww, jnp.uint32(0)),
                axis=-1).astype(jnp.uint64)

        lo, hi, h2 = sel(w0), sel(w0 + 1), sel(w0 + 2)
        val = (lo | (hi << jnp.uint64(32))) >> off
        extra = jnp.where(off > 0, h2 << (jnp.uint64(64) - off),
                          jnp.uint64(0))
        val = val | extra
        width = lw.astype(jnp.uint64)
        mask = jnp.where(width >= 64, ~jnp.uint64(0),
                         (jnp.uint64(1) << width) - jnp.uint64(1))
        return val & mask
    lo = words[lane, jnp.clip(w0, 0, W - 1)].astype(jnp.uint64)
    hi = words[lane, jnp.clip(w0 + 1, 0, W - 1)].astype(jnp.uint64)
    h2 = words[lane, jnp.clip(w0 + 2, 0, W - 1)].astype(jnp.uint64)
    val = (lo | (hi << jnp.uint64(32))) >> off
    extra = jnp.where(off > 0, h2 << (jnp.uint64(64) - off), jnp.uint64(0))
    val = val | extra
    width = lw.astype(jnp.uint64)
    mask = jnp.where(width >= 64, ~jnp.uint64(0), (jnp.uint64(1) << width) - jnp.uint64(1))
    return val & mask


def ef_select(ef: EliasFanoBatch, lane: jax.Array, k: jax.Array) -> jax.Array:
    """select(k) per (lane, k) query — reference elias_fano.hpp:141-145."""
    high_pos = select1_batch(ef.high, lane, k)
    low = _low_fields_dyn(ef.low_words, ef.l, lane, k)
    high_val = (high_pos - k).astype(jnp.uint64)
    return (high_val << ef.l[lane].astype(jnp.uint64)) | low


# ---------------------------------------------------------------------------
# secondary op surface (reference elias_fano.hpp:147-208)
#
# The reference implements rank via a darray0 zero-directory plus a
# data-dependent backward walk over the shared high bucket
# (elias_fano.hpp:146-167) — pointer-chasing that maps poorly to SIMD lanes.
# Here rank is a fixed-depth vectorized binary search over ef_select (the
# sequence is sorted, so rank(pos) == lower_bound(ids, pos)); every query in
# the batch takes the same 35-step path, each step a dense select. Identical
# outputs, batch-shaped control flow.
# ---------------------------------------------------------------------------

_RANK_STEPS = 35  # ceil(log2(2^34)) — covers any m the u32-word layout can hold


def ef_rank(ef: EliasFanoBatch, lane: jax.Array, pos: jax.Array) -> jax.Array:
    """Number of elements with value < pos (reference elias_fano.hpp:146-167;
    pos == universe+1 returns m as the reference's pos==size() branch does)."""
    pos = pos.astype(jnp.uint64)
    m = ef.m[lane]
    lo = jnp.zeros_like(m)
    hi = m
    for _ in range(_RANK_STEPS):
        active = lo < hi
        mid = (lo + hi) >> 1
        v = ef_select(ef, lane, jnp.minimum(mid, jnp.maximum(m - 1, 0)))
        go_right = v < pos
        lo = jnp.where(active & go_right, mid + 1, lo)
        hi = jnp.where(active & ~go_right, mid, hi)
    return lo


def ef_predecessor1(ef: EliasFanoBatch, lane: jax.Array, pos: jax.Array) -> jax.Array:
    """Largest element <= pos (reference elias_fano.hpp:169-171; as there,
    the caller must ensure one exists — k is clamped at 0 here)."""
    k = ef_rank(ef, lane, pos.astype(jnp.int64) + 1) - 1
    return ef_select(ef, lane, jnp.maximum(k, 0))


def ef_successor1(ef: EliasFanoBatch, lane: jax.Array, pos: jax.Array) -> jax.Array:
    """Smallest element >= pos (reference elias_fano.hpp:173-175; caller must
    ensure one exists — k is clamped at m-1 here)."""
    k = ef_rank(ef, lane, pos)
    return ef_select(ef, lane, jnp.minimum(k, jnp.maximum(ef.m[lane] - 1, 0)))


def ef_delta(ef: EliasFanoBatch, lane: jax.Array, n: jax.Array) -> jax.Array:
    """select(n) - select(n-1), select(0) for n == 0 (elias_fano.hpp:178-194).
    The reference walks high bits backward for the predecessor; two dense
    selects are branch-free and batched here."""
    cur = ef_select(ef, lane, n)
    prev = ef_select(ef, lane, jnp.maximum(n - 1, 0))
    return jnp.where(n > 0, cur - prev, cur)


def ef_select_range(ef: EliasFanoBatch, lane: jax.Array, n: jax.Array):
    """(select(n), select(n+1)) pairs (elias_fano.hpp:197-207; requires
    n+1 < m as the reference asserts)."""
    return ef_select(ef, lane, n), ef_select(ef, lane, n + 1)


# below this many compare cells per lane the select is computed by dense
# counting (no scatter) — the graph-adjacency shape (P ~ 96, n_max = K ~ 32)
# sits far under it; invlist full decodes (P, n_max in the thousands) would
# blow past it and keep the scatter form
_EF_COUNT_SELECT_CELLS = 1 << 17


def ef_decode_all(ef: EliasFanoBatch, n_max: int) -> jax.Array:
    """Decode every lane's full list → u64[B, n_max], zero-padded.

    One dense pass over the high bitvector — the batched equivalent of the
    reference's select_enumerator sweep (elias_fano.hpp:210-261). Two select
    forms, bit-identical:

      - **count-select** (small P*n_max — the in-traversal graph fetch):
        position of the (k+1)-th set bit = #positions whose inclusive
        set-bit count <= k, a dense compare+reduce with no scatter;
      - **scatter-select** (large shapes — invlist full decodes): cumsum
        ranks then scatter set-bit positions to their rank slots.
    """
    B, HW = ef.high.words.shape
    P = HW * 32
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = ((ef.high.words[:, :, None] >> shifts) & jnp.uint32(1)).reshape(B, P)
    counts = jnp.cumsum(bits.astype(jnp.int32), axis=1)  # inclusive
    k = jnp.broadcast_to(jnp.arange(n_max, dtype=jnp.int32)[None, :], (B, n_max))
    if P * n_max <= _EF_COUNT_SELECT_CELLS:
        # counts increments exactly at set bits, so for k < m the number of
        # positions with counts <= k IS select1(k); padding columns beyond
        # nbits are zero bits and never change counts
        high_pos = jnp.sum(
            (counts[:, :, None] <= k[:, None, :]).astype(jnp.int32), axis=1)
    else:
        ranks = counts - bits.astype(jnp.int32)  # exclusive: rank of each set bit
        pos = jnp.arange(P, dtype=jnp.int32)[None, :]
        valid = (bits == 1) & (ranks < n_max) & (pos < ef.high.nbits[:, None])
        b_idx = jnp.broadcast_to(jnp.arange(B)[:, None], ranks.shape)
        # invalid writes are routed to index n_max and dropped
        high_pos = jnp.zeros((B, n_max), dtype=jnp.int32).at[
            b_idx, jnp.where(valid, ranks, n_max)
        ].set(jnp.broadcast_to(pos, ranks.shape), mode="drop")
    lane = jnp.broadcast_to(jnp.arange(B, dtype=jnp.int32)[:, None], (B, n_max))
    low = _low_fields_dyn(ef.low_words, ef.l, lane, k)
    high_val = (high_pos - k).astype(jnp.uint64)
    vals = (high_val << ef.l[lane].astype(jnp.uint64)) | low
    return jnp.where(k < ef.m[:, None], vals, 0)

"""Wavelet tree over the cluster-assignment string.

The reference inverts the IVF: it builds the length-ntotal string
``list_nos[id] = list_no`` and wraps it in an SDSL ``wt_int`` (plain bitvector
or rrr_vector<63>-compressed), so ``get_single_id(list_no, offset)`` is
``wt.select(offset+1, list_no)`` (custom_invlists_impl.cpp:346-392).

This is a from-scratch levelwise balanced wavelet tree designed for batched
device queries:

  build (host, vectorized): level-l sequence is the stable sort of the
    symbols by their top-l bits (stable sorts compose, so no per-node
    partitioning loop); each level stores one packed bitvector of the
    current bit plane plus a **sampled superblock popcount directory** —
    one cumulative count per SB_WORDS words (SB_WORDS=32 → one entry per
    1024 bits, ~3% overhead, the SDSL-superblock footprint the reference's
    wt_int carries rather than the 100% a per-word prefix would cost).

  select (device): the classic two-sweep walk — a top-down pass computes the
    node interval along the symbol's bit path via rank, a bottom-up pass
    lifts the leaf offset through select0/select1 at each level. Rank and
    select search the superblock directory (``jnp.searchsorted``), then
    resolve within the 32-word window by a dense popcount cumsum — fully
    vectorized over (symbol, offset) query batches, the batched replacement
    for SDSL's pointer-walking select.

Levels L = ceil(log2(sigma)) with sigma = alphabet size (nlist); symbols must
be < 2**L. Total payload: L * ntotal bits (+ index), the wavelet-tree rate the
paper's Table 2 reports.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.bits import np_pack_fixed

# superblock: 32 u32 words = 1024 bits per directory entry
SB_WORDS = 32
SB_BITS = SB_WORDS * 32


class WaveletTree(NamedTuple):
    words: jax.Array      # u32[L, W] packed bit planes, W a SB_WORDS multiple
    sb_prefix: jax.Array  # i64[L, SB] inclusive popcount through superblock
    n: int                # sequence length
    levels: int

    @property
    def size_in_bits(self) -> int:
        """Payload bits (bit planes only), matching the plain-wt accounting
        granularity of the reference (index overhead reported separately)."""
        return self.levels * self.n

    @property
    def index_size_in_bits(self) -> int:
        """Sampled directory: one 32-bit entry per superblock per level."""
        entries_per_level = max((self.n + SB_BITS - 1) // SB_BITS, 1)
        return self.levels * entries_per_level * 32


def wt_levels(sigma: int) -> int:
    """Number of bit planes for alphabet size sigma (>=1 symbol)."""
    return max(1, int(sigma - 1).bit_length()) if sigma > 1 else 1


def _popcount_np(x: np.ndarray) -> np.ndarray:
    return np.bitwise_count(x.astype(np.uint32)).astype(np.int64)


def wt_index_from_words(words: np.ndarray) -> np.ndarray:
    """Superblock directory from packed planes u32[L, W] (W padded) —
    shared by build and artifact load (store.serialize)."""
    L, W = words.shape
    pops = _popcount_np(words).reshape(L, W // SB_WORDS, SB_WORDS).sum(axis=2)
    return np.cumsum(pops, axis=1)


def build_wavelet_tree(symbols: np.ndarray, sigma: int) -> WaveletTree:
    """Host build. ``symbols``: u32[n] values in [0, sigma)."""
    symbols = np.asarray(symbols, dtype=np.uint32)
    n = len(symbols)
    L = wt_levels(sigma)
    W = max((n + SB_BITS - 1) // SB_BITS, 1) * SB_WORDS
    words = np.zeros((L, W), dtype=np.uint32)
    for l in range(L):
        # level-l sequence = stable sort by top-l bits
        if l == 0:
            seq = symbols
        else:
            seq = symbols[np.argsort(symbols >> (L - l), kind="stable")]
        plane = ((seq >> (L - 1 - l)) & 1).astype(np.uint64)
        w = np_pack_fixed(plane, 1, total_bits=W * 32)
        words[l, : len(w)] = w
    sb = wt_index_from_words(words)
    return WaveletTree(jnp.asarray(words), jnp.asarray(sb), n, L)


# ---------------------------------------------------------------------------
# device rank/select on one level
# ---------------------------------------------------------------------------


def _window(wt: WaveletTree, level: int, sb: jax.Array) -> jax.Array:
    """Gather each query's superblock window → u32[Q, SB_WORDS].

    Fetched as ROWS of the [L*SB, SB_WORDS] view: a major-dim gather of
    contiguous 128-byte rows instead of per-element gathers from
    u32[L, W]."""
    SB = wt.words.shape[1] // SB_WORDS
    rows = wt.words.reshape(wt.words.shape[0] * SB, SB_WORDS)
    return rows[level * SB + sb]


def _rank1(wt: WaveletTree, level: int, pos: jax.Array) -> jax.Array:
    """Set bits strictly below pos on a level; pos i64[Q]."""
    word_idx = pos >> 5
    SB = wt.sb_prefix.shape[1]
    sb = jnp.minimum(word_idx // SB_WORDS, SB - 1)
    before = jnp.where(sb > 0, wt.sb_prefix[level, jnp.maximum(sb - 1, 0)], 0)
    win = _window(wt, level, sb)
    g = sb[..., None] * SB_WORDS + jnp.arange(SB_WORDS, dtype=jnp.int64)
    bit = (pos & 31).astype(jnp.uint32)[..., None]
    part = jnp.where(bit > 0, (jnp.uint32(1) << bit) - jnp.uint32(1), jnp.uint32(0))
    mask = jnp.where(
        g < word_idx[..., None],
        jnp.uint32(0xFFFFFFFF),
        jnp.where(g == word_idx[..., None], part, jnp.uint32(0)),
    )
    inwin = jax.lax.population_count(win & mask).astype(jnp.int64).sum(axis=-1)
    return before + inwin


def _select_in_word(word: jax.Array, k: jax.Array) -> jax.Array:
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (word[..., None] >> shifts) & jnp.uint32(1)
    cum = jnp.cumsum(bits.astype(jnp.int32), axis=-1)
    return jnp.argmax(cum == (k[..., None] + 1), axis=-1).astype(jnp.int64)


def _select_common(wt: WaveletTree, level: int, k: jax.Array,
                   sb_counts: jax.Array, invert: bool) -> jax.Array:
    """Shared select over ones (invert=False) or zeros (invert=True):
    searchsorted over the (possibly complemented) superblock directory, then
    dense popcount cumsum within the window, then in-word scan."""
    SB = sb_counts.shape[0]
    sb = jnp.searchsorted(sb_counts, k + 1, side="left").astype(jnp.int64)
    sb = jnp.clip(sb, 0, SB - 1)
    before_sb = jnp.where(sb > 0, sb_counts[jnp.maximum(sb - 1, 0)], 0)
    win = _window(wt, level, sb)
    if invert:
        win = ~win
    cum = jnp.cumsum(jax.lax.population_count(win).astype(jnp.int64), axis=-1)
    k_rel = k - before_sb
    rel = jnp.sum((cum <= k_rel[..., None]).astype(jnp.int64), axis=-1)
    rel = jnp.clip(rel, 0, SB_WORDS - 1)
    before = before_sb + jnp.where(
        rel > 0,
        jnp.take_along_axis(cum, jnp.maximum(rel - 1, 0)[..., None], axis=-1)[..., 0],
        0,
    )
    word = jnp.take_along_axis(win, rel[..., None], axis=-1)[..., 0]
    return (sb * SB_WORDS + rel) * 32 + _select_in_word(word, k - before)


def _select1(wt: WaveletTree, level: int, k: jax.Array) -> jax.Array:
    """Position of (k+1)-th set bit (k 0-based)."""
    return _select_common(wt, level, k, wt.sb_prefix[level], invert=False)


_HB = 64  # superblocks per hyperblock in the dense two-level select search


def sb_select_search(p1: jax.Array, k: jax.Array, invert: jax.Array,
                     sb_bits: int, with_before: bool = False):
    """First superblock whose inclusive prefix exceeds ``k``, per query,
    with per-query polarity (``invert`` → search the zeros prefix, derived
    elementwise as (i+1)*sb_bits − ones).

    Equivalent to two ``searchsorted(prefix, k+1, 'left')`` calls, but as
    two dense compare+reduce passes — hyperblock level then ONE row gather
    of the winning hyperblock's superblock window, in place of a
    ``searchsorted`` (a log2(SB)-step data-dependent gather chain).

    All arithmetic runs in ``k.dtype`` — callers pass i32 when the plane
    length fits (half the bytes of i64).

    ``with_before=True`` additionally returns the selected-polarity count
    before the winning superblock, read from the already-gathered window
    (saves the caller a serialized [SB] element gather)."""
    dt = k.dtype
    p1 = p1.astype(dt)
    SB = p1.shape[0]
    NH = -(-SB // _HB)
    pad = NH * _HB - SB
    p1p = jnp.pad(p1, (0, pad)) if pad else p1
    rows = p1p.reshape(NH, _HB)
    # prefix through each hyperblock's last VALID superblock
    idx_h = jnp.minimum(
        (jnp.arange(NH, dtype=dt) + 1) * _HB, SB) - 1
    hp1 = p1[idx_h]
    hp0 = (idx_h + 1) * sb_bits - hp1
    hpv = jnp.where(invert[..., None], hp0, hp1)
    hb = jnp.minimum(
        jnp.sum((hpv <= k[..., None]).astype(jnp.int32), axis=-1), NH - 1)
    win1 = rows[hb]                                   # [Q, _HB] row gather
    gidx = (hb[..., None].astype(dt) * _HB
            + jnp.arange(_HB, dtype=dt))
    valid = gidx < SB
    win0 = (gidx + 1) * sb_bits - win1
    winv = jnp.where(invert[..., None], win0, win1)
    r = jnp.sum((valid & (winv <= k[..., None])).astype(dt), axis=-1)
    sb = jnp.minimum(hb.astype(dt) * _HB + r, SB - 1)
    if not with_before:
        return sb
    # count before sb, from the gathered window: winv[r-1] when r > 0,
    # else the previous hyperblock's closing count (0 at the very start)
    prev_hp = jnp.where(
        hb > 0,
        jnp.take_along_axis(
            hpv, jnp.maximum(hb - 1, 0)[..., None], axis=-1)[..., 0],
        jnp.zeros((), dt))
    in_win = jnp.take_along_axis(
        winv, jnp.maximum(r - 1, 0)[..., None].astype(jnp.int32),
        axis=-1)[..., 0]
    before = jnp.where(r > 0, in_win, prev_hp)
    return sb, before


def _select_merged(wt: WaveletTree, level: int, k: jax.Array,
                   invert: jax.Array) -> jax.Array:
    """select0/select1 fused with a per-query ``invert`` vector: one window
    gather + one in-window pass for the batch (a static-invert caller under
    jnp.where evaluates both polarities). The zeros directory derives from
    the ones directory: zeros-through-sb = (sb+1)*SB_BITS - ones. All
    arithmetic in ``k.dtype`` (i32 when the caller's plane fits)."""
    dt = k.dtype
    p1 = wt.sb_prefix[level]
    sb, before_sb = sb_select_search(p1, k, invert, SB_BITS,
                                     with_before=True)
    win = _window(wt, level, sb)
    win = jnp.where(invert[..., None], ~win, win)
    cum = jnp.cumsum(jax.lax.population_count(win).astype(dt), axis=-1)
    k_rel = k - before_sb
    rel = jnp.sum((cum <= k_rel[..., None]).astype(dt), axis=-1)
    rel = jnp.clip(rel, 0, SB_WORDS - 1)
    before = before_sb + jnp.where(
        rel > 0,
        jnp.take_along_axis(
            cum, jnp.maximum(rel - 1, 0)[..., None].astype(jnp.int32),
            axis=-1)[..., 0],
        0,
    )
    word = jnp.take_along_axis(
        win, rel[..., None].astype(jnp.int32), axis=-1)[..., 0]
    return ((sb * SB_WORDS + rel) * 32
            + _select_in_word(word, k - before).astype(dt))


def _select0(wt: WaveletTree, level: int, k: jax.Array) -> jax.Array:
    p1 = wt.sb_prefix[level]
    SB = p1.shape[0]
    p0 = (jnp.arange(SB, dtype=jnp.int64) + 1) * SB_BITS - p1
    return _select_common(wt, level, k, p0, invert=True)


# ---------------------------------------------------------------------------
# wavelet-tree select: position of the (offset+1)-th occurrence of symbol
# ---------------------------------------------------------------------------


def wt_path_tables(symbol_counts: np.ndarray, L: int) -> np.ndarray:
    """Static per-symbol walk tables i64[2^L, L, 3].

    The top-down sweep of the select walk (node interval + rank at the node
    start along the symbol's bit path) depends only on the SYMBOL, never on
    the query offset — and node boundaries in a levelwise tree are prefix
    histograms of the symbol distribution. For the IVF wavelet tree that
    histogram is exactly the list-length array, so the whole sweep
    precomputes from metadata the container already holds (no format
    change, nothing new to serialize).

    Entry [s, l] = (r0_lo, r1_lo, child_lo) for the level-l node on s's
    path: rank0/rank1 of plane l at the node start, and the start of the
    child node the path descends into. child_lo at the last level is the
    leaf (= first global position index of symbol s's occurrences block).
    """
    counts = np.asarray(symbol_counts, dtype=np.int64)
    sigma_pad = 1 << L
    if len(counts) > sigma_pad:
        raise ValueError(f"{len(counts)} symbols exceed 2^{L}")
    hist = np.zeros(sigma_pad, np.int64)
    hist[: len(counts)] = counts
    # hists[w][p] = #symbols whose width-w prefix == p
    hists = [None] * (L + 1)
    hists[L] = hist
    for w in range(L - 1, -1, -1):
        hists[w] = hists[w + 1].reshape(-1, 2).sum(axis=1)

    out = np.zeros((sigma_pad, L, 3), np.int64)
    sym = np.arange(sigma_pad, dtype=np.int64)
    for l in range(L):
        p = sym >> (L - l)                      # level-l node = width-l prefix
        # ones of plane l inside node q = #symbols with prefix q and next
        # bit 1 = hists[l+1][2q+1]; node starts tile the level in prefix
        # order, so rank at a node start is a cumsum over earlier nodes
        c_lo = np.concatenate(([0], np.cumsum(hists[l])))
        c_r1 = np.concatenate(([0], np.cumsum(hists[l + 1][1::2])))
        c_child = np.concatenate(([0], np.cumsum(hists[l + 1])))
        lo = c_lo[p]
        r1_lo = c_r1[p]
        out[:, l, 0] = lo - r1_lo               # r0_lo
        out[:, l, 1] = r1_lo
        out[:, l, 2] = c_child[sym >> (L - 1 - l)]
    return out


def _wt_select_tables(L: int, select_merged, tables: jax.Array,
                      symbol: jax.Array, offset: jax.Array,
                      dt=jnp.int64) -> jax.Array:
    """Bottom-up-only select walk using precomputed path tables: one row
    gather [Q, L, 3] replaces every rank of the top-down sweep, and each
    level runs ONE merged select (per-query polarity) instead of both.
    ``dt`` is the walk dtype — i32 when the sequence length fits."""
    symbol = symbol.astype(dt)
    offset = offset.astype(dt)
    t = tables.astype(dt)[symbol]               # [..., L, 3] row gather
    p = t[..., L - 1, 2] + offset               # leaf position
    for l in reversed(range(L)):
        zero = ((symbol >> (L - 1 - l)) & 1) == 0
        j = p - t[..., l, 2]
        k = jnp.where(zero, t[..., l, 0], t[..., l, 1]) + j
        p = select_merged(l, k, zero).astype(dt)
    return p


def _wt_select_generic(n: int, L: int, rank1, select0, select1,
                       symbol: jax.Array, offset: jax.Array) -> jax.Array:
    """The two-sweep select walk, parameterized over the level primitives
    (plain bit planes or RRR-compressed planes — codecs/rrr.py)."""
    symbol = symbol.astype(jnp.int64)
    offset = offset.astype(jnp.int64)

    # top-down: node interval [lo, hi) along the bit path; remember per level
    # the node start, its rank0/rank1 there, the branch bit, and child start
    lo = jnp.zeros_like(offset)
    hi = jnp.full_like(offset, n)
    Q = offset.shape[0]
    per_level = []
    for l in range(L):
        b = (symbol >> (L - 1 - l)) & 1
        # one batched rank covers both interval ends: the window gathers
        # dominate the walk, and one 2Q-query gather beats two Q-query ones
        r1_both = rank1(l, jnp.concatenate([lo, hi]))
        r1_lo, r1_hi = r1_both[:Q], r1_both[Q:]
        r0_lo = lo - r1_lo
        z = (hi - r1_hi) - r0_lo  # zeros inside [lo, hi)
        child_lo = jnp.where(b == 0, lo, lo + z)
        child_hi = jnp.where(b == 0, lo + z, hi)
        per_level.append((b, lo, r0_lo, r1_lo, child_lo))
        lo, hi = child_lo, child_hi

    # bottom-up: lift the in-leaf offset through select at each level
    p = lo + offset
    for l in reversed(range(L)):
        b, lo_l, r0_lo, r1_lo, child_lo = per_level[l]
        j = p - child_lo
        p = jnp.where(
            b == 0,
            select0(l, r0_lo + j),
            select1(l, r1_lo + j),
        )
    return p


def wt_select(wt: WaveletTree, symbol: jax.Array, offset: jax.Array,
              tables: jax.Array | None = None) -> jax.Array:
    """Vectorized over query arrays: global position (the vector id) of the
    (offset+1)-th occurrence of ``symbol`` (0-based offset) — the reference's
    wt.select(offset+1, list_no) (custom_invlists_impl.cpp:377-379).

    With ``tables`` (wt_path_tables) the top-down rank sweep is replaced by
    one table gather and only the L bottom-up selects run; without, the
    classic two-sweep walk.
    """
    if tables is not None:
        dt = jnp.int32 if wt.n < 2 ** 31 else jnp.int64
        return _wt_select_tables(
            wt.levels, lambda l, k, inv: _select_merged(wt, l, k, inv),
            tables, symbol, offset, dt).astype(jnp.int64)
    return _wt_select_generic(
        wt.n, wt.levels,
        lambda l, pos: _rank1(wt, l, pos),
        lambda l, k: _select0(wt, l, k),
        lambda l, k: _select1(wt, l, k),
        symbol, offset,
    )


def wt_select_rrr(rrr, symbol: jax.Array, offset: jax.Array,
                  tables: jax.Array | None = None) -> jax.Array:
    """wt_select over RRR(63)-compressed bit planes (wt_type 1 —
    sdsl::wt_int<rrr_vector<63>> parity, custom_invlists_impl.cpp:367-373)."""
    from .rrr import rrr_rank1, rrr_select0, rrr_select1, rrr_select_merged

    if tables is not None:
        dt = jnp.int32 if rrr.n < 2 ** 31 else jnp.int64
        return _wt_select_tables(
            rrr.levels, lambda l, k, inv: rrr_select_merged(rrr, l, k, inv),
            tables, symbol, offset, dt).astype(jnp.int64)
    return _wt_select_generic(
        rrr.n, rrr.levels,
        lambda l, pos: rrr_rank1(rrr, l, pos),
        lambda l, k: rrr_select0(rrr, l, k),
        lambda l, k: rrr_select1(rrr, l, k),
        symbol, offset,
    )


def wt_planes(symbols: np.ndarray, sigma: int) -> np.ndarray:
    """The raw bit planes u8[L, n] of the levelwise tree (for RRR storage)."""
    symbols = np.asarray(symbols, dtype=np.uint32)
    n = len(symbols)
    L = wt_levels(sigma)
    planes = np.zeros((L, n), dtype=np.uint8)
    for l in range(L):
        seq = symbols if l == 0 else symbols[
            np.argsort(symbols >> (L - l), kind="stable")]
        planes[l] = ((seq >> (L - 1 - l)) & 1).astype(np.uint8)
    return planes

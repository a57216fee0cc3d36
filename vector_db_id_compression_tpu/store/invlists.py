"""Inverted-list containers with compressed IDs.

API parity with the reference's invlist hierarchy
(custom_invlist_cpp/custom_invlists_impl.h:22-124):

  InvertedLists                 — the uncompressed source container
  PackedBitsInvertedLists       — C9: fixed-width ids, O(1) random access
  RocInvertedLists              — C10: per-list ANS states, full-list decode
  EliasFanoInvertedLists        — C11: sorted ids + EF, O(1) select
  WaveletTreeInvertedLists      — C12: one wavelet tree over list_nos

plus the reference's contracts: ROC reorders payload codes into sampling
order, EF into ascending-id order, wavelet tree requires ascending ids per
list and leaves codes untouched; ``compressed_ids_size_in_bytes`` accounting
matches each reference constructor.

Device layout: lists are grouped into geometric size buckets (store.ragged)
and each bucket's ids live *on device* in the batched codec layout. Decoding
k lists is one lanes-in-lockstep program over a gathered sub-batch, not k
independent pointer walks; random access is one vectorized query batch. These
two batched entry points (``decode_lists``, ``get_single_ids_batch``) are what
the deferred-decoding search path calls (search.ivf).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..codecs import roc_device as rd
from ..codecs.elias_fano import (
    EliasFanoBatch,
    batch_ef_lists,
    ef_decode_all,
    ef_encode_list,
    ef_select,
)
from ..codecs.packed_bits import (
    PackedBitsBatch,
    get_single as pb_get_single,
    pack_lists,
    packed_width,
    unpack_all,
)
from ..codecs.roc import precision_for_max_id_safe
from ..codecs.wavelet_tree import build_wavelet_tree, wt_select
from ..core.bits import directory_entries
from ..ops import route
from ..ops.roc_pallas import RocPallasDecoder, run_kernel
from .ragged import Bucket, bucketize, pad_lists


class InvertedLists:
    """Uncompressed ragged inverted lists (ids + payload codes)."""

    def __init__(self, nlist: int, code_size: int):
        self.nlist = nlist
        self.code_size = code_size
        self.ids: List[np.ndarray] = [np.empty(0, dtype=np.uint64) for _ in range(nlist)]
        self.codes: List[np.ndarray] = [np.empty(0, dtype=np.uint8) for _ in range(nlist)]

    def add_entries(self, list_no: int, ids: np.ndarray, codes: Optional[np.ndarray] = None):
        ids = np.asarray(ids, dtype=np.uint64)
        if codes is None:
            codes = np.zeros(len(ids) * self.code_size, dtype=np.uint8)
        self.ids[list_no] = np.concatenate([self.ids[list_no], ids])
        self.codes[list_no] = np.concatenate([self.codes[list_no], np.asarray(codes, np.uint8)])

    def list_size(self, list_no: int) -> int:
        return len(self.ids[list_no])

    def compute_ntotal(self) -> int:
        return sum(len(v) for v in self.ids)

    @property
    def lengths(self) -> np.ndarray:
        return np.array([len(v) for v in self.ids], dtype=np.int64)


def _codes_matrix(il: InvertedLists, list_no: int) -> np.ndarray:
    return il.codes[list_no].reshape(-1, il.code_size)


def _gather_lanes(tree, lane_idx: np.ndarray):
    idx = jnp.asarray(lane_idx)
    return jax.tree_util.tree_map(lambda a: a[idx], tree)


class CompressedInvertedLists:
    """Base: common bookkeeping + host-convenience wrappers over batch APIs."""

    supports_random_access = False

    def __init__(self, il: InvertedLists):
        self.nlist = il.nlist
        self.code_size = il.code_size
        self._lengths = il.lengths.copy()
        self.compressed_ids_size_in_bytes = 0
        self.overhead_in_bytes = 0
        self.codes_all: List[np.ndarray] = []

    def list_size(self, list_no: int) -> int:
        return int(self._lengths[list_no])

    @property
    def lengths(self) -> np.ndarray:
        return self._lengths

    def get_codes(self, list_no: int) -> np.ndarray:
        return self.codes_all[list_no]

    # --- batched device API (overridden) ---------------------------------

    def decode_lists(self, list_nos: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Decode several lists → (ids [Q, max_len] u64 zero-padded, lengths)."""
        raise NotImplementedError

    def get_single_ids_batch(self, list_nos: np.ndarray, offsets: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def decode_select(self, list_nos: np.ndarray, offsets: np.ndarray) -> np.ndarray:
        """Grouped deferred translate: decode each TOUCHED list once
        (reference custom_invlists_impl.cpp:477-525), but gather the label
        offsets ON DEVICE so only the [n_labels] selected ids transfer —
        pulling the full decoded rows (e.g. [touched, n_pad] u64 ≈ 29 MB at
        1M ids) costs more than the decode itself."""
        list_nos = np.asarray(list_nos, dtype=np.int64)
        offsets = np.asarray(offsets, dtype=np.int64)
        decode_fn = getattr(self, "_decode_fn", None)
        if decode_fn is None:  # containers without a per-bucket decode
            if self.supports_random_access:
                return self.get_single_ids_batch(list_nos, offsets)
            uniq, inv = np.unique(list_nos, return_inverse=True)
            decoded, _ = self.decode_lists(uniq)
            return decoded[inv, offsets]
        b_of, l_of = _bucket_maps(self)
        b = np.where(self._lengths[list_nos] > 0, b_of[list_nos], -1)
        out = np.zeros(len(list_nos), dtype=np.uint64)
        sels, vals = [], []
        for bi in np.unique(b[b >= 0]):
            sel = np.nonzero(b == bi)[0]
            uniq, inv = np.unique(list_nos[sel], return_inverse=True)
            lanes = l_of[uniq].astype(np.int64)
            dec = decode_fn(int(bi), lanes, self._buckets[bi].n_pad)
            vals.append(jnp.asarray(dec)[jnp.asarray(inv),
                                         jnp.asarray(offsets[sel])])
            sels.append(sel)
        if sels:
            cat = np.asarray(jnp.concatenate(vals)) if len(vals) > 1 else (
                np.asarray(vals[0]))
            out[np.concatenate(sels)] = cat
        return out

    # --- host-convenience parity API --------------------------------------

    def get_ids(self, list_no: int) -> np.ndarray:
        ids, lens = self.decode_lists(np.array([list_no]))
        return ids[0, : lens[0]]

    def get_single_id(self, list_no: int, offset: int) -> int:
        if not self.supports_random_access:
            raise NotImplementedError(f"{type(self).__name__} has no O(1) random access")
        return int(self.get_single_ids_batch(np.array([list_no]), np.array([offset]))[0])


# ---------------------------------------------------------------------------
# Packed bits (reference C9, custom_invlists_impl.cpp:64-118)
# ---------------------------------------------------------------------------


class PackedBitsInvertedLists(CompressedInvertedLists):
    supports_random_access = True

    def __init__(self, il: InvertedLists):
        super().__init__(il)
        ntotal = il.compute_ntotal()
        self.bits = packed_width(ntotal)
        for list_no in range(il.nlist):
            ids = il.ids[list_no]
            if len(ids) and not (ids < ntotal).all():
                raise ValueError("ids must be < ntotal")  # reference FAISS_THROW
        self.codes_all = [il.codes[ln].copy() for ln in range(il.nlist)]
        self._buckets = bucketize(self._lengths)
        self._packed: List[PackedBitsBatch] = []
        self._list_to_bucket: Dict[int, Tuple[int, int]] = {}
        for bi, bucket in enumerate(self._buckets):
            pb = pack_lists([il.ids[i] for i in bucket.list_ids], self.bits)
            self._packed.append(pb)
            for lane, ln in enumerate(bucket.list_ids):
                self._list_to_bucket[int(ln)] = (bi, lane)
            self.compressed_ids_size_in_bytes += int(
                pb.size_in_bytes_per_list.sum()
            )

    def _decode_fn(self, bi, lanes, n_pad):
        pb = self._packed[bi]
        sub = PackedBitsBatch(
            words=pb.words[jnp.asarray(lanes)],
            lengths=pb.lengths[jnp.asarray(lanes)],
            width=pb.width,
        )
        return unpack_all(sub, n_pad)

    def decode_lists(self, list_nos):
        return _decode_by_bucket(self, list_nos, self._decode_fn)

    def get_single_ids_batch(self, list_nos, offsets):
        return _select_by_bucket(
            self, list_nos, offsets,
            lambda bi, lanes, offs: _pb_get_single_jit(self._packed[bi],
                                                        lanes, offs))


# jitted select wrappers: the batch structs are NamedTuple pytrees, so one
# program covers the whole select — called eagerly, every jnp op inside is
# its own device dispatch (~20 ops x per-dispatch latency ate ~1 s of the
# 1M EF translate). PackedBitsBatch.width must stay a static (it selects
# the field-extraction unroll), so the packed wrapper is cached per width.
_ef_select_jit = jax.jit(ef_select)
_PB_SINGLE_JITS: Dict[int, object] = {}


def _pb_get_single_jit(pb: PackedBitsBatch, lanes, offs):
    fn = _PB_SINGLE_JITS.get(pb.width)
    if fn is None:
        w = pb.width
        fn = _PB_SINGLE_JITS[w] = jax.jit(
            lambda words, lengths, lanes, offs: pb_get_single(
                PackedBitsBatch(words, lengths, w), lanes, offs))
    return fn(pb.words, pb.lengths, lanes, offs)


def _bucket_maps(container):
    """Vectorized view of ``_list_to_bucket``: arrays (bucket_of i32[nlist],
    lane_of i32[nlist]); bucket_of == -1 for lists in no bucket. Cached on
    the container — the per-label dict lookups in the translate path cost
    more than the device work at 20k labels."""
    m = getattr(container, "_bucket_maps_cache", None)
    if m is None:
        b = np.full(container.nlist, -1, dtype=np.int32)
        lane = np.zeros(container.nlist, dtype=np.int32)
        for ln, (bi, la) in container._list_to_bucket.items():
            b[ln] = bi
            lane[ln] = la
        m = container._bucket_maps_cache = (b, lane)
    return m


def _select_by_bucket(container, list_nos, offsets, select_fn):
    """Batched O(1) random-access translate: vectorized bucket grouping,
    async dispatch of one select program per touched bucket, results
    concatenated ON DEVICE and pulled in a single transfer (per-bucket
    np.asarray pulls serialize on the device link)."""
    list_nos = np.asarray(list_nos, dtype=np.int64)
    offsets = np.asarray(offsets, dtype=np.int32)
    b_of, l_of = _bucket_maps(container)
    b = b_of[list_nos]
    sels, vals = [], []
    for bi in np.unique(b[b >= 0]):
        sel = np.nonzero(b == bi)[0]
        lanes = l_of[list_nos[sel]]
        vals.append(select_fn(int(bi), jnp.asarray(lanes, jnp.int32),
                              jnp.asarray(offsets[sel])))
        sels.append(sel)
    out = np.zeros(len(list_nos), dtype=np.uint64)
    if sels:
        cat = np.asarray(jnp.concatenate(vals)) if len(vals) > 1 else (
            np.asarray(vals[0]))
        out[np.concatenate(sels)] = cat
    return out


def _decode_by_bucket(container, list_nos, decode_fn):
    """Shared grouped decode: gather requested lanes per bucket, run the
    batched decoder, scatter rows back into query order. All bucket
    programs are dispatched before any result is pulled."""
    list_nos = np.asarray(list_nos, dtype=np.int64)
    lens = container._lengths[list_nos].astype(np.int32)
    max_len = max(int(lens.max()) if len(lens) else 0, 1)
    out = np.zeros((len(list_nos), max_len), dtype=np.uint64)
    b_of, l_of = _bucket_maps(container)
    b = np.where(lens > 0, b_of[list_nos], -1)
    pend = []
    for bi in np.unique(b[b >= 0]):
        qs = np.nonzero(b == bi)[0]
        lanes = l_of[list_nos[qs]].astype(np.int64)
        bucket = container._buckets[bi]
        pend.append((qs, decode_fn(int(bi), lanes, bucket.n_pad),
                     bucket.n_pad))
    for qs, decoded, n_pad in pend:
        w = min(n_pad, max_len)
        out[qs, :w] = np.asarray(decoded)[:, :w]
    return out, lens


# ---------------------------------------------------------------------------
# ROC (reference C10, custom_invlists_impl.cpp:133-223)
# ---------------------------------------------------------------------------


class RocInvertedLists(CompressedInvertedLists):
    """Per-list ANS states; random access requires full-list decode, so this
    container only exposes the grouped path (as the reference: no
    get_single_id ⇒ deferred search must use grouped translation)."""

    supports_random_access = False

    def __init__(self, il: InvertedLists, use_native: Optional[bool] = None):
        super().__init__(il)
        if use_native is None:
            use_native = rd.native_encode_enabled()
        self.codes_all = [np.empty(0, np.uint8)] * il.nlist
        self._buckets = bucketize(self._lengths)
        self._states: List[rd.RocStates] = []
        self._precisions: List[jax.Array] = []
        self._list_to_bucket: Dict[int, Tuple[int, int]] = {}
        self.id_symbol_precision = np.zeros(il.nlist, dtype=np.int64)

        for bi, bucket in enumerate(self._buckets):
            n_pad = bucket.n_pad
            prec = np.array([precision_for_max_id_safe(int(il.ids[ln].max()))
                             for ln in bucket.list_ids], np.int32)
            self.id_symbol_precision[bucket.list_ids] = prec
            cap = rd.stack_capacity(n_pad, int(prec.max()))
            # shared ragged front door: native C++ when available, else
            # the XLA scan encoder (codecs/roc_device.py encode_ragged)
            states, orig_orders = rd.encode_ragged(
                [il.ids[ln] for ln in bucket.list_ids], prec, n_pad, cap,
                use_native=use_native)
            for lane, ln in enumerate(bucket.list_ids):
                # payload codes reordered to sampling order
                self.codes_all[ln] = _reorder_codes(
                    il.codes[ln], orig_orders[lane], il.code_size
                )
                self._list_to_bucket[int(ln)] = (bi, lane)
            self._states.append(states)
            self._precisions.append(jnp.asarray(prec))
            self.compressed_ids_size_in_bytes += int(
                np.asarray(states.size_bytes)[np.asarray(bucket.lengths) > 0].sum()
            )
        self._kernels = {}  # bucket -> RocPallasDecoder or None, built lazily

    def _decode_fn(self, bi, lanes, n_pad):
        return _decode_bucket_lanes(self, bi, lanes)

    def decode_lists(self, list_nos):
        return _decode_by_bucket(self, list_nos, self._decode_fn)

    def decode_select(self, list_nos, offsets):
        return _roc_decode_select(self, list_nos, offsets)


def _reorder_codes(codes_flat: np.ndarray, order: np.ndarray, code_size: int) -> np.ndarray:
    if code_size == 0 or len(codes_flat) == 0:
        return np.empty(0, dtype=np.uint8)
    return codes_flat.reshape(-1, code_size)[order].reshape(-1).copy()


def _max_precision(container) -> int:
    return int(max((int(np.asarray(p).max(initial=1))
                    for p in container._precisions), default=1))


def _decode_bucket_lanes(container, bi, lanes):
    """Decode ``lanes`` of codec bucket ``bi`` (RocInvertedLists and
    InterleavedRocInvertedLists) by the backend's route (ops.route) →
    ids [len(lanes), n_pad] in encode sampling order. The bucket's kernel
    decoder is built and validated once, on first use."""
    bucket = container._buckets[bi]
    prec = container._precisions[bi]
    maxp = int(np.asarray(prec).max())
    if bi not in container._kernels:
        dec = None
        if route.roc_decode_route(maxp) != route.XLA:
            dec = RocPallasDecoder(
                container._states[bi], bucket.lengths, np.asarray(prec),
                rd.default_pool(bucket.n_pad), bucket.n_pad).checked()
        container._kernels[bi] = dec
    dec = container._kernels[bi]
    if dec is not None:
        return dec.decode_lanes(lanes)
    lanes_j = jnp.asarray(lanes)
    ids, _ = rd.roc_decode_batch(
        _gather_lanes(container._states[bi], lanes),
        jnp.asarray(bucket.lengths[lanes]), prec[lanes_j],
        rd.default_pool(bucket.n_pad), bucket.n_pad, rd.n_slices_for(maxp))
    return ids


# ---------------------------------------------------------------------------
# whole-container prepared translate (RocInvertedLists and
# InterleavedRocInvertedLists)
#
# One kernel call decodes EVERY codec lane of the container — a list, or a
# chunk entry of an interleaved list (lanes sorted by length so each
# program's step loop stops at its own block's max) — and the labels are
# gathered in the same program: one dispatch and one pull per search instead
# of one decode program per touched bucket. A plain list is an interleaved
# list of one chunk with no rebase, so both containers share the mapping.
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("n_max", "interpret"))
def _translate_call(buf, head, ptr, lens, prec, inv, ent_lo, lane_start,
                    n_lanes, list_len, lns, offs, *, n_max, interpret=False):
    """Map each (list, offset) label to its chunk lane and within-chunk
    sampling position in closed form — chunk sizes are the deterministic
    near-equal partition (codecs/roc_interleaved.py partition_sizes: the
    first n%S chunks get one extra element)."""
    emit, _ = run_kernel(buf, head, ptr, lens, prec, n_max=n_max,
                         interpret=interpret)
    n = list_len[lns]
    S = jnp.maximum(n_lanes[lns], 1)
    base = n // S
    r = n % S
    t = r * (base + 1)
    in_big = offs < t
    s = jnp.where(in_big, offs // jnp.maximum(base + 1, 1),
                  r + (offs - t) // jnp.maximum(base, 1))
    chunk_start = jnp.where(in_big, s * (base + 1), t + (s - r) * base)
    jj = offs - chunk_start
    row = lane_start[lns] + s
    srow = inv[row]
    # decode-iteration order: element j of a lane is at emit row len-1-j
    pos = jnp.clip(lens[0, srow] - 1 - jj, 0, n_max - 1)
    vals = emit[0, pos, srow].astype(jnp.uint64) + ent_lo[row]
    return jnp.where((offs < n) & (n > 0), vals, jnp.uint64(0))


def _flatten_sorted_decoder(container, row_map, lens_full, n_max, interpret):
    """Flatten bucketized states into flat lanes via ``row_map`` (iterable
    of (row, bucket_idx, lane)), sort lanes by length descending, build and
    validate one decoder over all lanes. Returns (dec, inv) with ``inv``
    mapping a flat row to its sorted lane."""
    E = len(lens_full)
    cap = max((int(np.asarray(st.stack).shape[1])
               for st in container._states), default=1)
    head = np.full(E, rd.RANS_L, np.uint64)
    stack = np.zeros((E, cap), np.uint32)
    stack_len = np.zeros(E, np.int32)
    mt_ctr = np.zeros(E, np.int32)
    prec = np.ones(E, np.int32)
    sts = [jax.tree_util.tree_map(np.asarray, st)
           for st in container._states]
    prs = [np.asarray(p) for p in container._precisions]
    for row, bi, lane in row_map:
        st = sts[bi]
        head[row] = st.head[lane]
        stack[row, : st.stack.shape[1]] = st.stack[lane]
        stack_len[row] = st.stack_len[lane]
        mt_ctr[row] = st.mt_ctr[lane]
        prec[row] = prs[bi][lane]
    order = np.argsort(-lens_full, kind="stable")
    inv = np.empty(E, np.int32)
    inv[order] = np.arange(E, dtype=np.int32)
    states = rd.RocStates(
        head=head[order], stack=stack[order], stack_len=stack_len[order],
        mt_ctr=mt_ctr[order], err=np.zeros(E, bool))
    dec = RocPallasDecoder(states, lens_full[order], prec[order],
                           rd.default_pool(n_max), n_max).checked(interpret)
    return dec, jnp.asarray(inv)


def _pad_labels_pow2(list_nos, offsets):
    """Label padding for the prepared translate: pow2 pad so repeat calls
    with drifting label counts reuse the compiled program."""
    Q0 = len(list_nos)
    Q = max(256, 1 << (Q0 - 1).bit_length())
    lns = np.zeros(Q, np.int32)
    offs = np.zeros(Q, np.int32)
    lns[:Q0] = list_nos
    offs[:Q0] = offsets
    return jnp.asarray(lns), jnp.asarray(offs)


def _prepared_translate(container, interpret: bool = False):
    """Build (and cache on the container, keyed by ``interpret``) the
    whole-container kernel translate. Returns (arrays, (n_max, interpret)),
    or None when the route is the XLA path — callers then take the
    per-bucket chain. ``interpret`` runs the kernel in interpret mode (CPU
    tests)."""
    key = f"_prep_translate_i{int(interpret)}"
    if key in container.__dict__:
        return container.__dict__[key]
    prep = None
    nlist = container.nlist
    if route.roc_decode_route(_max_precision(container),
                              interpret=interpret) != route.XLA:
        if isinstance(container, InterleavedRocInvertedLists):
            ent_len = container._ent_len
            ent_lo = container._ent_lo
            row_map = [(e, bi, lane)
                       for e, (bi, lane) in container._ent_to_bucket.items()]
            keys = [container._entries_of[ln] for ln in range(nlist)]
            lane_start = np.array([k[0] if k else 0 for k in keys], np.int32)
            n_lanes = np.array([len(k) for k in keys], np.int32)
        else:
            ent_len = container._lengths.astype(np.int32)
            ent_lo = np.zeros(nlist, np.uint64)
            row_map = [(int(ln), bi, lane)
                       for bi, bucket in enumerate(container._buckets)
                       for lane, ln in enumerate(bucket.list_ids)]
            lane_start = np.arange(nlist, dtype=np.int32)
            n_lanes = (ent_len > 0).astype(np.int32)
        if len(ent_len):
            n_max = max(int(ent_len.max()), 1)
            dec, inv = _flatten_sorted_decoder(
                container, row_map, np.asarray(ent_len, np.int32), n_max,
                interpret)
            arrs = (dec.buf, dec.head, dec.ptr, dec.lens, dec.prec, inv,
                    jnp.asarray(ent_lo), jnp.asarray(lane_start),
                    jnp.asarray(n_lanes),
                    jnp.asarray(container._lengths.astype(np.int32)))
            prep = arrs, (n_max, interpret)
    container.__dict__[key] = prep
    return prep


def _translate_prepared(prep, list_nos, offsets) -> np.ndarray:
    """Run a prepared translate on (list, offset) labels → ids u64."""
    list_nos = np.asarray(list_nos, dtype=np.int64)
    offsets = np.asarray(offsets, dtype=np.int64)
    Q0 = len(list_nos)
    if Q0 == 0:
        return np.zeros(0, dtype=np.uint64)
    lns, offs = _pad_labels_pow2(list_nos, offsets)
    arrs, (n_max, interpret) = prep
    vals = _translate_call(*arrs, lns, offs, n_max=n_max,
                           interpret=interpret)
    return np.asarray(vals[:Q0]).astype(np.uint64)


def _roc_decode_select(container, list_nos, offsets):
    prep = _prepared_translate(container)
    if prep is None:
        return CompressedInvertedLists.decode_select(container, list_nos,
                                                     offsets)
    return _translate_prepared(prep, list_nos, offsets)


# ---------------------------------------------------------------------------
# Elias-Fano (reference C11, custom_invlists_impl.cpp:229-339)
# ---------------------------------------------------------------------------


class EliasFanoInvertedLists(CompressedInvertedLists):
    supports_random_access = True

    def __init__(self, il: InvertedLists):
        super().__init__(il)
        self.codes_all = [np.empty(0, np.uint8)] * il.nlist
        self._buckets = bucketize(self._lengths)
        self._efs: List[EliasFanoBatch] = []
        self._list_to_bucket: Dict[int, Tuple[int, int]] = {}
        total_bits = 0
        index_words = 0
        for bi, bucket in enumerate(self._buckets):
            encoded = []
            for lane, ln in enumerate(bucket.list_ids):
                v = il.ids[ln]
                perm = np.argsort(v, kind="stable")
                self.codes_all[ln] = _reorder_codes(il.codes[ln], perm, il.code_size)
                e = ef_encode_list(v[perm])
                encoded.append(e)
                total_bits += e.size_in_bits
                # sampled select directory: one i32 per 512 high bits
                index_words += directory_entries(e.high_bits)
                self._list_to_bucket[int(ln)] = (bi, lane)
            self._efs.append(batch_ef_lists(encoded))
        # reference sums bits across lists then divides once (.cpp:282)
        self.compressed_ids_size_in_bytes = total_bits // 8
        # select-index overhead (the reference's darray equivalent; it
        # excludes this from its accounting — we report it honestly)
        self.overhead_in_bytes = index_words * 4

    def _decode_fn(self, bi, lanes, n_pad):
        ef = self._efs[bi]
        sub = EliasFanoBatch(
            high=_gather_lanes(ef.high, lanes),
            low_words=ef.low_words[jnp.asarray(lanes)],
            l=ef.l[jnp.asarray(lanes)],
            m=ef.m[jnp.asarray(lanes)],
        )
        return ef_decode_all(sub, n_pad)

    def decode_lists(self, list_nos):
        return _decode_by_bucket(self, list_nos, self._decode_fn)

    def get_single_ids_batch(self, list_nos, offsets):
        return _select_by_bucket(
            self, list_nos, offsets,
            lambda bi, lanes, offs: _ef_select_jit(self._efs[bi], lanes,
                                                   offs))


# ---------------------------------------------------------------------------
# Wavelet tree (reference C12, custom_invlists_impl.cpp:346-397)
# ---------------------------------------------------------------------------


class WaveletTreeInvertedLists(CompressedInvertedLists):
    """One wavelet tree over list_nos[id]; ids per list must be ascending
    (asserted, as the reference does at .cpp:357-362); codes stay unreordered.

    wt_type 0 = plain bit planes (sdsl wt_int<bit_vector> parity); wt_type 1
    stores the planes RRR(63)-compressed (wt_int<rrr_vector<63>> parity,
    codecs/rrr.py) — smaller, slower select, exactly the reference's
    trade-off (custom_invlists_impl.cpp:367-373)."""

    supports_random_access = True

    def __init__(self, il: InvertedLists, wt_type: int = 0):
        super().__init__(il)
        assert wt_type in (0, 1)
        self.wt_type = wt_type
        ntotal = il.compute_ntotal()
        list_nos = np.zeros(ntotal, dtype=np.uint32)
        for list_no in range(il.nlist):
            ids = il.ids[list_no]
            if len(ids) == 0:
                continue
            assert (np.diff(ids.astype(np.int64)) > 0).all(), "ids must be ascending"
            assert int(ids[-1]) < ntotal
            list_nos[ids] = list_no
        self.codes_all = [il.codes[ln].copy() for ln in range(il.nlist)]
        if wt_type == 0:
            self.wt = build_wavelet_tree(list_nos, il.nlist)
            self.compressed_ids_size_in_bytes = (
                self.wt.size_in_bits + self.wt.index_size_in_bits
            ) // 8
        else:
            from ..codecs.rrr import rrr_encode_planes
            from ..codecs.wavelet_tree import wt_planes

            self.wt = rrr_encode_planes(wt_planes(list_nos, il.nlist))
            self.compressed_ids_size_in_bytes = self.wt.payload_bits // 8
            self.overhead_in_bytes = self.wt.index_bits // 8

    @property
    def wt_tables(self):
        """Precomputed per-symbol walk tables (wt_path_tables): derived from
        the list-length array — the symbol histogram — so they rebuild for
        free after deserialization (nothing new in the artifact)."""
        t = self.__dict__.get("_wt_tables")
        if t is None:
            from ..codecs.wavelet_tree import wt_path_tables

            t = jax.numpy.asarray(
                wt_path_tables(self._lengths, self.wt.levels))
            self.__dict__["_wt_tables"] = t
        return t

    def _select(self, sym, offs):
        # jit the whole multi-level walk once per container: eagerly it is
        # ~70 sequential small dispatches (u64-heavy for RRR), which
        # dominates on dispatch-latency-bound rigs
        fn = self.__dict__.get("_select_jit")
        if fn is None:
            # tree arrays ride as ARGUMENTS (closure constants are baked
            # into the program: huge compile payloads at scale); the static
            # (n, levels) fields stay in the closure
            wt = self.wt
            n, levels = wt.n, wt.levels
            arrs = tuple(wt)[:-2]
            tab = self.wt_tables
            if self.wt_type == 0:
                core = jax.jit(lambda a, t, sy, of: wt_select(
                    type(wt)(*a, n, levels), sy, of, tables=t))
            else:
                from ..codecs.wavelet_tree import wt_select_rrr

                core = jax.jit(lambda a, t, sy, of: wt_select_rrr(
                    type(wt)(*a, n, levels), sy, of, tables=t))
            fn = lambda sy, of: core(arrs, tab, sy, of)
            self.__dict__["_select_jit"] = fn
        return fn(sym, offs)

    def decode_lists(self, list_nos):
        list_nos = np.asarray(list_nos, dtype=np.int64)
        lens = self._lengths[list_nos].astype(np.int32)
        max_len = max(int(lens.max()) if len(lens) else 0, 1)
        sym = np.repeat(list_nos, max_len).reshape(len(list_nos), max_len)
        offs = np.tile(np.arange(max_len, dtype=np.int64), (len(list_nos), 1))
        vals = np.asarray(
            self._select(jnp.asarray(sym), jnp.asarray(np.minimum(offs, np.maximum(lens[:, None] - 1, 0))))
        ).astype(np.uint64)
        mask = offs < lens[:, None]
        return np.where(mask, vals, 0), lens

    def get_single_ids_batch(self, list_nos, offsets):
        return np.asarray(
            self._select(jnp.asarray(np.asarray(list_nos, np.int64)),
                         jnp.asarray(np.asarray(offsets, np.int64)))
        ).astype(np.uint64)


# (the exact RRR payload accounting now lives in codecs/rrr.py
# RRRPlanes.payload_bits; wt_type=1 stores real RRR planes)


# ---------------------------------------------------------------------------
# Interleaved ROC (framework extension — SURVEY.md §5 "long-context" answer)
# ---------------------------------------------------------------------------


class InterleavedRocInvertedLists(CompressedInvertedLists):
    """ROC container with S-lane interleaving for long lists.

    Long lists are split into contiguous sorted-value chunks, each rebased
    to its minimum and coded as an independent ROC stream
    (codecs/roc_interleaved.py rationale: the per-chunk precision drop
    cancels the multiset-splitting loss to first order, and the S chains
    decode in lockstep — ~S x the per-list decode latency of the strictly
    sequential reference format). Short lists keep the bit-exact
    single-stream format. Envelope per extra lane: 8B lo + 4B length + 1B
    precision, counted in ``overhead_in_bytes``.

    ``interleave="auto"`` (default) chunks each list past
    1.5x AUTO_CHUNK_TARGET into S = ceil(n / AUTO_CHUNK_TARGET) lanes —
    the measured per-id decode optimum. An integer ``interleave`` with
    ``interleave_min`` reproduces the fixed policy (lists >=
    interleave_min split into exactly ``interleave`` chunks).
    """

    supports_random_access = False

    # auto policy: chunk lists past 1.5x this target into ~target-length
    # lanes — per-id decode cost is U-shaped in lane length (fixed per-step
    # codec cost short, O(i) rank pass + O(capp) stack ops long); the
    # codec_scale sweep put the optimum near 512 (300M: 401 Mids/s,
    # 1B: 418 Mids/s at target 512 vs 150 Mids/s with whole-list lanes)
    AUTO_CHUNK_TARGET = 512

    def __init__(self, il: InvertedLists, interleave="auto",
                 interleave_min: int = 4096):
        super().__init__(il)
        from ..codecs.roc_interleaved import chunk_plan

        auto = interleave == "auto"
        assert auto or interleave >= 1
        self.interleave = interleave
        self.codes_all = [np.empty(0, np.uint8)] * il.nlist
        self.id_symbol_precision = np.zeros(il.nlist, dtype=np.int64)

        # expand lists into chunk entries; the chunking contract (sizes,
        # minima, rebase, per-chunk precision) is the codec's chunk_plan —
        # one definition shared with the standalone interleaved codec
        entries = []  # (ln, chunk_idx, rebased u64[], lo, prec, orig_idx[])
        self._entries_of: Dict[int, List[int]] = {}
        for ln in range(il.nlist):
            v = il.ids[ln]
            if len(v) == 0:
                self._entries_of[ln] = []
                continue
            perm = np.argsort(v, kind="stable")
            sv = v[perm]
            if auto:
                t = self.AUTO_CHUNK_TARGET
                S = -(-len(v) // t) if len(v) > (3 * t) // 2 else 1
            else:
                S = (interleave
                     if len(v) >= max(interleave_min, interleave) else 1)
            self.id_symbol_precision[ln] = precision_for_max_id_safe(
                int(sv[-1]))
            if S == 1:
                # bit-exact single-stream reference format: no rebase,
                # full-id precision
                sizes = np.array([len(v)], dtype=np.int64)
                bounds = np.array([0, len(v)], dtype=np.int64)
                lo_arr = np.zeros(1, dtype=np.uint64)
                prec_arr = np.array([self.id_symbol_precision[ln]], np.int32)
                rebased_chunks = [sv]
            else:
                sizes, bounds, lo_arr, prec_arr, rebased_chunks = chunk_plan(
                    sv, S)
            keys = []
            for s in range(S):
                keys.append(len(entries))
                entries.append((ln, s, rebased_chunks[s], lo_arr[s],
                                int(prec_arr[s]),
                                perm[bounds[s]:bounds[s + 1]]))
            self._entries_of[ln] = keys

        ent_lengths = np.array([len(e[2]) for e in entries], dtype=np.int64)
        self._ent_lo = np.array([e[3] for e in entries], dtype=np.uint64)
        self._ent_len = ent_lengths.astype(np.int32)
        self._buckets = bucketize(ent_lengths)
        self._kernels = {}  # bucket -> RocPallasDecoder or None
        self._states: List[rd.RocStates] = []
        self._precisions: List[jax.Array] = []
        self._ent_to_bucket: Dict[int, Tuple[int, int]] = {}

        order_of: Dict[int, np.ndarray] = {}
        for bi, bucket in enumerate(self._buckets):
            B, n_pad = len(bucket.list_ids), bucket.n_pad
            prec = np.array([entries[int(e)][4] for e in bucket.list_ids],
                            np.int32)
            cap = rd.stack_capacity(n_pad, int(prec.max()))
            states, chunk_orders = rd.encode_ragged(
                [entries[int(e)][2] for e in bucket.list_ids], prec, n_pad,
                cap)
            for lane, e in enumerate(bucket.list_ids):
                ln, s, rebased, lo, p, orig_base = entries[int(e)]
                order_of[int(e)] = orig_base[chunk_orders[lane]]
                self._ent_to_bucket[int(e)] = (bi, lane)
            self._states.append(states)
            self._precisions.append(jnp.asarray(prec))
            self.compressed_ids_size_in_bytes += int(
                np.asarray(states.size_bytes)[np.asarray(bucket.lengths) > 0]
                .sum())

        # per-list code reorder: concat of chunk sampling orders
        for ln in range(il.nlist):
            keys = self._entries_of[ln]
            if not keys:
                continue
            global_order = np.concatenate([order_of[e] for e in keys])
            self.codes_all[ln] = _reorder_codes(il.codes[ln], global_order,
                                                il.code_size)
            # envelope overhead for S>1 lists: lo + length + precision / lane
            if len(keys) > 1:
                self.overhead_in_bytes += len(keys) * (8 + 4 + 1)

    def decode_lists(self, list_nos):
        list_nos = np.asarray(list_nos, dtype=np.int64)
        lens = self._lengths[list_nos].astype(np.int32)
        max_len = max(int(lens.max()) if len(lens) else 0, 1)
        out = np.zeros((len(list_nos), max_len), dtype=np.uint64)

        # group all needed chunk entries by bucket
        by_bucket: Dict[int, List[int]] = {}
        for ln in list_nos:
            for e in self._entries_of[int(ln)]:
                bi, _ = self._ent_to_bucket[e]
                by_bucket.setdefault(bi, []).append(e)
        decoded: Dict[int, np.ndarray] = {}
        pend = []  # dispatch every bucket program before pulling any result
        for bi, ents in by_bucket.items():
            lanes = np.array([self._ent_to_bucket[e][1] for e in ents],
                             dtype=np.int64)
            ids = _decode_bucket_lanes(self, bi, lanes)
            pend.append((ents, ids))
        for ents, ids in pend:
            ids_np = np.asarray(ids)
            for row, e in enumerate(ents):
                n = int(self._ent_len[e])
                decoded[e] = ids_np[row, :n].astype(np.uint64) + self._ent_lo[e]

        for q, ln in enumerate(list_nos):
            keys = self._entries_of[int(ln)]
            if not keys:
                continue
            vals = np.concatenate([decoded[e] for e in keys])
            out[q, : len(vals)] = vals
        return out, lens

    def decode_select(self, list_nos, offsets):
        return _roc_decode_select(self, list_nos, offsets)


# method-name → container factory, the one registry behind the experiment
# drivers (parity with AVAILABLE_COMPRESSED_IVFS, reference
# bench_invlists.py:19-25, plus the RRR and interleaved variants)
AVAILABLE_COMPRESSED_IVFS = {
    "packed-bits": PackedBitsInvertedLists,
    "roc": RocInvertedLists,
    "elias-fano": EliasFanoInvertedLists,
    "wavelet-tree": lambda il: WaveletTreeInvertedLists(il, wt_type=0),
    "wavelet-tree-1": lambda il: WaveletTreeInvertedLists(il, wt_type=1),
    "roc-interleaved": InterleavedRocInvertedLists,
}

"""IVF index with deferred ID decoding — the search-path integration.

Reference parity (custom_invlists_impl.cpp:407-526 `search_IVF_defer_id_decoding`
and the SWIG wrapper custom_invlists.swig:86-127):
  - coarse quantization → probe lists → scan codes positionally (labels are
    (list_no, offset) pairs, ids never touched during the scan),
  - after the shortlist is final, translate labels to ids either 1-by-1
    (random-access codecs) or grouped per touched list (full-list decoders
    like ROC),
  - optionally harvest the shortlist's payload codes (+ listno prefix).

Device design: the scan is batched matmul/LUT arithmetic over
size-bucketed padded list storage —
  coarse:    [nq, d] x [d, nlist] matmul + top-nprobe
  flat scan: per bucket, batched matvec dist over gathered
             (query, lane) probe pairs + masked top-k
  pq scan:   per-query LUTs [nq, M, ksub] + per-pair gather-sum
  translate: ONE batched container call (get_single_ids_batch or
             decode_lists) instead of an OpenMP loop.

Positional labels are packed like the reference's lo_build: label =
(list_no << 32) | offset, -1 for empty slots.

Scan storage is always (re)built from the *active* container's code order, so
offsets stay consistent after codecs reorder payload codes (ROC: sampling
order, EF: ascending ids) — same invariant the reference maintains by
physically reordering codes at compression time (custom_invlists_impl.cpp:188-193).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field
from functools import partial
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..store.invlists import CompressedInvertedLists, InvertedLists
from ..store.ragged import Bucket, bucketize
from .kmeans import train_kmeans
from .pq import ProductQuantizer


def lo_build(list_no, offset):
    return (np.int64(list_no) << np.int64(32)) | np.int64(offset)


def lo_listno(label):
    return label >> 32


def lo_offset(label):
    return label & ((1 << 32) - 1)


@partial(jax.jit, static_argnums=(2,))
def _coarse_topk(xq, centroids, nprobe):
    dots = jnp.dot(xq, centroids.T, preferred_element_type=jnp.float32,
                                    precision=jax.lax.Precision.HIGHEST)
    c2 = jnp.sum(centroids * centroids, axis=1)
    d2 = c2[None, :] - 2.0 * dots
    neg, idx = jax.lax.top_k(-d2, nprobe)
    x2 = jnp.sum(xq * xq, axis=1, keepdims=True)
    return -neg + x2, idx


def _masked_topk(d2, valid_len, k: int):
    """Shared scan tail: mask padded slots, top-k smallest, +inf padding when
    the bucket is narrower than k."""
    n_pad = d2.shape[1]
    mask = jnp.arange(n_pad, dtype=jnp.int32)[None, :] >= valid_len[:, None]
    d2 = jnp.where(mask, jnp.inf, d2)
    kk = min(k, n_pad)
    neg, offs = jax.lax.top_k(-d2, kk)
    if kk < k:
        neg = jnp.pad(neg, ((0, 0), (0, k - kk)), constant_values=-jnp.inf)
        offs = jnp.pad(offs, ((0, 0), (0, k - kk)), constant_values=0)
    return -neg, offs


@partial(jax.jit, static_argnums=(4,))
def _scan_flat_bucket(xq, vecs, lengths, pairs, k):
    """pairs = (q_idx i32[P], lane i32[P]); vecs f32[B, d, n_pad]
    (channel-major: the minormost dim is the long one, n_pad).
    Returns (dists f32[P, k], offsets i32[P, k]) with +inf padding."""
    q_idx, lane = pairs
    X = xq[q_idx]                      # [P, d]
    Y = vecs[lane]                     # [P, d, n_pad]
    dots = jnp.einsum("pd,pdn->pn", X, Y, preferred_element_type=jnp.float32,
                                          precision=jax.lax.Precision.HIGHEST)
    y2 = jnp.sum(Y * Y, axis=1)
    d2 = y2 - 2.0 * dots               # + ||x||^2 added by caller at merge
    return _masked_topk(d2, lengths[lane], k)


# NOTE on the qinco scan: an additive-quantizer LUT scan (per-pair gather-sum
# over [P, M, ksub] tables) is the CPU-native shape of the reference's IVF-RQ
# scan — on a device the gathers dominate and materialize huge
# intermediates. Instead the scan storage holds the *linear reconstructions*
# c_list + r̂_lin precomputed at replace_invlists, and the scan is the flat
# matmul kernel: mathematically identical distances
# (‖x − (c + r̂)‖² = ‖x−c‖² − 2⟨x−c, r̂⟩ + ‖r̂‖²) at matmul speed.


@partial(jax.jit, static_argnums=(3, 4))
def _scan_flat_allpairs(xq, vecs, lengths, k, slab=0):
    """Dense variant: distances from EVERY query to EVERY lane of the bucket
    as [nq, slab*n_pad] matmuls + per-(q, lane) top-k. When most lanes are
    probed by many queries this beats the per-pair kernel, whose vecs[lane]
    gather duplicates each list's payload once per probing query.

    ``slab`` > 0 processes the lanes in slabs via ``lax.map`` INSIDE the one
    device program — the payload streams through HBM exactly once and the
    peak distance buffer is [nq, slab, n_pad], so reference-scale buckets
    (10M+ entries) scan in a single dispatch."""
    B, d, n_pad = vecs.shape
    nq = xq.shape[0]
    kk = min(k, n_pad)

    def scan_slab(args):
        vecs_s, len_s = args                   # [S, d, n_pad], [S]
        dots = jnp.einsum("qd,sdn->qsn", xq, vecs_s,
                          preferred_element_type=jnp.float32,
                          precision=jax.lax.Precision.HIGHEST)
        y2 = jnp.sum(vecs_s * vecs_s, axis=1)  # [S, n_pad]
        d2 = y2[None] - 2.0 * dots             # [nq, S, n_pad]
        mask = (jnp.arange(n_pad, dtype=jnp.int32)[None, :]
                >= len_s[:, None])[None]
        d2 = jnp.where(mask, jnp.inf, d2)
        return jax.lax.top_k(-d2, kk)          # [nq, S, kk] x2

    if slab and slab < B:
        # slabs via dynamic_slice on the UNPADDED payload: any in-program
        # pad/reshape of vecs copies the whole multi-GB buffer (twice, with
        # the pad temp — the 10M OOM). The tail slab starts clamped to
        # B - slab, recomputing <slab overlapped lanes with identical
        # results before overwriting them in place.
        n_slabs = -(-B // slab)

        def body(i, out):
            start = jnp.minimum(i * slab, B - slab)
            vecs_s = jax.lax.dynamic_slice(vecs, (start, 0, 0),
                                           (slab, d, n_pad))
            len_s = jax.lax.dynamic_slice(lengths, (start,), (slab,))
            neg_s, off_s = scan_slab((vecs_s, len_s))   # [nq, slab, kk]
            return (jax.lax.dynamic_update_slice(out[0], neg_s,
                                                 (0, start, 0)),
                    jax.lax.dynamic_update_slice(out[1], off_s,
                                                 (0, start, 0)))

        neg, offs = jax.lax.fori_loop(
            0, n_slabs, body,
            (jnp.full((nq, B, kk), -jnp.inf, jnp.float32),
             jnp.zeros((nq, B, kk), jnp.int32)),
        )
    else:
        neg, offs = scan_slab((vecs, lengths))
    if kk < k:
        neg = jnp.pad(neg, ((0, 0), (0, 0), (0, k - kk)),
                      constant_values=-jnp.inf)
        offs = jnp.pad(offs, ((0, 0), (0, 0), (0, k - kk)),
                       constant_values=0)
    return -neg, offs


@partial(jax.jit, static_argnums=(4,))
def _scan_pq_bucket(luts, codes, lengths, pairs, k):
    """luts f32[nq, M, ksub]; codes u8[B, M, n_pad] (channel-major — a
    the minormost dim is the long one, n_pad)."""
    q_idx, lane = pairs
    lut_p = luts[q_idx]                            # [P, M, ksub]
    idx = codes[lane].astype(jnp.int32)            # [P, M, n_pad]
    gathered = jnp.take_along_axis(lut_p, idx, axis=2)  # [P, M, n_pad]
    d2 = jnp.sum(gathered, axis=1)                 # [P, n_pad]
    return _masked_topk(d2, lengths[lane], k)


@jax.jit
def _merge_topk(cand_d, cand_l):
    """[nq, C] candidate dists/labels → top-k by distance (k = output C of
    caller slicing); returns sorted ascending."""
    order = jnp.argsort(cand_d, axis=1)
    return jnp.take_along_axis(cand_d, order, axis=1), jnp.take_along_axis(
        cand_l, order, axis=1
    )


@partial(jax.jit, static_argnums=(6, 7, 8))
def _emit_merge_device(q_idx, p_idx, lns, dists, offs, x2, nq, nprobe, k):
    """Scatter every scanned (query, probe) slab into the [nq, nprobe, k]
    candidate tensors ON DEVICE and merge to the final sorted top-k.

    Replaces the host emit + re-upload merge: the per-bucket scan outputs
    never leave the device, so the whole search pays ONE [nq, k] transfer
    instead of 2 transfers per bucket chunk plus a [nq, nprobe*k] upload.
    Padded rows carry q_idx == nq
    and fall out via scatter mode="drop". x2 is the per-query ||x||^2 term
    (zeros for LUT distances, which are already complete)."""
    valid = jnp.isfinite(dists)
    labels = jnp.where(
        valid, (lns[:, None] << 32) | offs.astype(jnp.int64), jnp.int64(-1))
    xq2 = jnp.concatenate([x2, jnp.zeros((1,), jnp.float32)])[
        jnp.minimum(q_idx, nq)]
    d = jnp.where(valid, dists + xq2[:, None], jnp.inf)
    cand_d = jnp.full((nq, nprobe, k), jnp.inf, jnp.float32).at[
        q_idx, p_idx].set(d, mode="drop")
    cand_l = jnp.full((nq, nprobe, k), -1, jnp.int64).at[
        q_idx, p_idx].set(labels, mode="drop")
    cd = cand_d.reshape(nq, nprobe * k)
    cl = cand_l.reshape(nq, nprobe * k)
    order = jnp.argsort(cd, axis=1)[:, :k]
    return (jnp.take_along_axis(cd, order, axis=1),
            jnp.take_along_axis(cl, order, axis=1))


def _pad_pow2(n: int, lo: int = 8) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


@dataclass
class _ScanBucket:
    list_ids: np.ndarray      # i64[B] list numbers
    lengths_dev: jax.Array    # i32[B]
    # channel-major so the minormost dim is n_pad, the long one
    payload: jax.Array        # flat/qinco: f32[B, d, n_pad] | pq: u8[B, M, n_pad]
    n_pad: int


class IndexIVF:
    """IVF index: flat, PQ, or QINCo (neural additive) payload, pluggable
    compressed ID containers.

    The ``qinco`` storage mode is the JAX analogue of the reference's
    large-scale IVF-RQ + torch-QINCo pair (search_ivf_qinco.py:185-315): the
    payload codes are QINCo codes; the *scan* uses the model's linear base
    codebooks as an additive quantizer (LUT gather-sum + stored per-entry
    norm), and the *re-rank* decodes shortlist codes through the full neural
    decoder. Code layout per entry: M uint8 code bytes + 4 bytes f32 norm."""

    def __init__(self, d: int, nlist: int, storage: str = "flat",
                 pq_m: int = 0, nprobe: int = 1, qinco=None,
                 quantizer: str = "flat", quantizer_efSearch: int = 64,
                 quantizer_M: int = 32):
        assert storage in ("flat", "pq", "qinco")
        assert quantizer in ("flat", "hnsw")
        self.d = d
        self.nlist = nlist
        self.storage = storage
        self.nprobe = nprobe
        # coarse quantizer: "flat" = dense [nq, d] x [d, nlist] matmul +
        # top-nprobe (fine through ~100k centroids); "hnsw" = graph search
        # over the centroids — the reference's 1B operating point quantizes
        # 1M centroids through an HNSW with --quantizer_efSearch
        # (/root/reference/README.md:174-176). The HNSW is built lazily from
        # self.centroids (so loaded indices get it transparently) and is
        # also used for add-time assignment, matching Faiss's
        # quantizer->assign behavior for graph quantizers.
        self.quantizer = quantizer
        self.quantizer_efSearch = quantizer_efSearch
        self.quantizer_M = quantizer_M
        self._quantizer_hnsw = None
        self.pq = ProductQuantizer(d, pq_m) if storage == "pq" else None
        self.qinco = qinco  # QincoCodec (models/qinco.py) when storage="qinco"
        self.centroids: Optional[np.ndarray] = None
        self.invlists: Optional[InvertedLists] = None
        self.active: Optional[object] = None  # InvertedLists-like with codes
        self.ntotal = 0
        self._scan: List[_ScanBucket] = []
        self._list_to_scan: Dict[int, Tuple[int, int]] = {}

    @property
    def code_size(self) -> int:
        if self.storage == "flat":
            return self.d * 4
        if self.storage == "qinco":
            return self.qinco.M + 4  # M code bytes + f32 ‖x̂_lin‖²
        return self.pq.code_size

    @property
    def coarse_code_size(self) -> int:
        """Bytes to encode a list number (reference encode_listno convention:
        ceil(log2(nlist) / 8))."""
        nbit = max((self.nlist - 1).bit_length(), 1)
        return (nbit + 7) // 8

    # ------------------------------------------------------------------ build

    def train(self, x: np.ndarray, niter: int = 20, qinco_steps: int = 300):
        self.centroids = train_kmeans(x, self.nlist, niter=niter)
        self.__dict__.pop("_cent_dev", None)  # invalidate the device cache
        if self.pq is not None:
            self.pq.train(x)
        if self.storage == "qinco":
            assert self.qinco is not None, "pass qinco=QincoCodec(...)"
            if self.qinco.params is None:
                # train on coarse residuals — the reference trains its RQ /
                # QINCo on x - centroid too (search_ivf_qinco.py:38-118)
                from .kmeans import assign

                a = np.asarray(assign(jnp.asarray(np.asarray(x, np.float32)),
                                      jnp.asarray(self.centroids)))
                resid = np.asarray(x, np.float32) - self.centroids[a]
                self.qinco.train(resid, steps=qinco_steps)

    def _ensure_quantizer(self):
        """Lazily build the HNSW coarse quantizer over the centroids.
        Rebuilt whenever ``self.centroids`` is a different array object —
        retraining or direct assignment must not leave the graph walking
        stale centroids."""
        if (self._quantizer_hnsw is None
                or self.__dict__.get("_quantizer_src")
                is not self.centroids):
            from .hnsw import HNSW

            self._quantizer_hnsw = HNSW(
                M=self.quantizer_M,
                ef_construction=max(2 * self.quantizer_M, 40),
            ).build(np.asarray(self.centroids, np.float32))
            self.__dict__["_quantizer_src"] = self.centroids
        return self._quantizer_hnsw

    def coarse_assign(self, xq: np.ndarray, nprobe: int) -> np.ndarray:
        """Top-``nprobe`` centroid ids per query through the configured
        coarse quantizer. HNSW may return -1 for slots past what the graph
        search reached (callers must treat those as unprobed)."""
        xq = np.asarray(xq, np.float32)
        if self.quantizer == "hnsw":
            ef = max(self.quantizer_efSearch, nprobe)
            _, I = self._ensure_quantizer().search(xq, nprobe, ef=ef)
            return np.asarray(I, np.int64)
        # device-resident centroids cached across calls (re-uploading a
        # 262k x d table per call costs more than the coarse matmul);
        # keyed by array identity so replacing self.centroids invalidates
        cd = self.__dict__.get("_cent_dev")
        if cd is None or self.__dict__.get("_cent_src") is not self.centroids:
            cd = self.__dict__["_cent_dev"] = jnp.asarray(
                np.asarray(self.centroids, np.float32))
            self.__dict__["_cent_src"] = self.centroids
        _, probes = _coarse_topk(jnp.asarray(xq), cd, nprobe)
        return np.asarray(probes, np.int64)

    def add(self, x: np.ndarray):
        assert self.centroids is not None, "train first"
        x = np.asarray(x, dtype=np.float32)
        if self.quantizer == "hnsw":
            # graph-quantized assignment (Faiss quantizer->assign parity for
            # graph quantizers — the 1B reference config adds through the
            # HNSW too); chunked so the frontier tensors stay bounded
            a = np.empty(len(x), np.int64)
            for s in range(0, len(x), 65536):
                a[s:s + 65536] = self.coarse_assign(x[s:s + 65536], 1)[:, 0]
            missed = np.flatnonzero(a < 0)
            if len(missed):
                # graph search failed to place these points — exact-assign
                # the stragglers instead of silently dumping them in list 0
                from .kmeans import assign as _exact_assign

                a[missed] = np.asarray(_exact_assign(
                    jnp.asarray(x[missed]),
                    jnp.asarray(np.asarray(self.centroids, np.float32))))
        else:
            from .kmeans import assign

            a = np.asarray(assign(jnp.asarray(x),
                                  jnp.asarray(self.centroids)))
        if self.storage == "flat":
            codes = x.view(np.uint8).reshape(len(x), -1)
        elif self.storage == "qinco":
            resid = x - self.centroids[a]
            qc = self.qinco.encode(resid)                   # u8[n, M]
            norms = self.qinco.lin_norms(qc)                # f32[n] ‖r̂_lin‖²
            codes = np.concatenate(
                [qc, norms[:, None].view(np.uint8).reshape(len(x), 4)], axis=1
            )
        else:
            codes = self.pq.encode(x)
        il = InvertedLists(self.nlist, self.code_size)
        base = self.ntotal
        # one stable argsort instead of nlist full scans (O(n log n) vs
        # O(n * nlist) — the difference between seconds and hours at 10M)
        order = np.argsort(a, kind="stable")
        bounds = np.searchsorted(a[order], np.arange(self.nlist + 1))
        for ln in range(self.nlist):
            members = order[bounds[ln]: bounds[ln + 1]]
            il.add_entries(ln, (members + base).astype(np.uint64),
                           codes[members].reshape(-1))
        self.invlists = il
        self.ntotal += len(x)
        self.replace_invlists(il)

    def replace_invlists(self, container):
        """Swap the active ID container (source or compressed) and rebuild
        scan storage in the container's code order."""
        self.active = container
        lengths = (
            container.lengths
            if isinstance(container, (CompressedInvertedLists,))
            else container.lengths
        )
        self._scan = []
        self._list_to_scan = {}
        get_codes = (
            container.get_codes
            if hasattr(container, "get_codes")
            else (lambda ln: container.codes[ln])
        )
        buckets = list(bucketize(lengths))
        # PQ: decode codes to f32 reconstructions at build when they fit
        # the memory budget — the ADC distance IS the exact L2 to the
        # reconstruction (sum_m ||x_m - c_m||^2 = ||x - x_hat||^2), so the
        # scan rides the dense matmul path instead of per-pair LUT gathers
        # over big tables.
        # Opt out with VDBIDC_PQ_DECODE_SCAN=0 (e.g. memory-bound 1B-scale).
        self._scan_is_float = self.storage in ("flat", "qinco")
        if self.storage == "pq":
            import os as _os

            pad_rows = sum(len(b.list_ids) * b.n_pad for b in buckets)
            budget_el = int(_os.environ.get("VDBIDC_PQ_DECODE_BUDGET",
                                            str(2 ** 30)))
            self._scan_is_float = (
                _os.environ.get("VDBIDC_PQ_DECODE_SCAN", "1") != "0"
                and pad_rows * self.d <= budget_el)
        # cap each scan bucket's payload at ~the scan budget: XLA relayouts /
        # remats the payload parameter inside the dense-scan program, so a
        # single multi-GB bucket doubles in HBM and OOMs at 10M ids; chunked
        # buckets are separate (async, pipelined) dispatches whose copies are
        # small. Codec-side bucketing (store/) is unaffected.
        import os as _os

        budget_el = int(_os.environ.get("VDBIDC_SCAN_BUDGET", str(2 ** 28)))
        width = self.d if self._scan_is_float else max(self.pq.M, 1)
        chunked = []
        for b in buckets:
            b_cap = max(1, budget_el // max(b.n_pad * width, 1))
            for lo in range(0, len(b.list_ids), b_cap):
                sl = slice(lo, lo + b_cap)
                ids_c, len_c = b.list_ids[sl], b.lengths[sl]
                if lo and len(ids_c) < b_cap:
                    # pad the tail chunk to the cap (lane id -1, length 0) so
                    # every chunk of a bucket shares ONE compiled scan shape
                    pad = b_cap - len(ids_c)
                    ids_c = np.concatenate(
                        [ids_c, np.full(pad, -1, ids_c.dtype)])
                    len_c = np.concatenate(
                        [len_c, np.zeros(pad, len_c.dtype)])
                chunked.append(Bucket(list_ids=ids_c, lengths=len_c,
                                      n_pad=b.n_pad))
        buckets = chunked
        for si, bucket in enumerate(buckets):
            B, n_pad = len(bucket.list_ids), bucket.n_pad
            # channel-major payloads ([B, d|M, n_pad]) — see _ScanBucket
            if self.storage == "flat":
                payload = np.zeros((B, self.d, n_pad), dtype=np.float32)
                for lane, ln in enumerate(bucket.list_ids):
                    if ln < 0:
                        continue  # tail-chunk padding lane
                    c = get_codes(int(ln))
                    payload[lane, :, : len(c) // self.code_size] = (
                        c.view(np.float32).reshape(-1, self.d).T
                    )
            elif self.storage == "qinco":
                # linear reconstructions c_list + r̂_lin: the scan then runs
                # on the matmul path (see the module NOTE above)
                M = self.qinco.M
                payload = np.zeros((B, self.d, n_pad), dtype=np.float32)
                for lane, ln in enumerate(bucket.list_ids):
                    if ln < 0:
                        continue
                    rows = get_codes(int(ln)).reshape(-1, self.code_size)
                    if len(rows):
                        payload[lane, :, : len(rows)] = (
                            self.qinco.lin_decode(rows[:, :M])
                            + self.centroids[int(ln)]
                        ).T
            elif self._scan_is_float:  # pq decoded to f32 reconstructions
                payload = np.zeros((B, self.d, n_pad), dtype=np.float32)
                for lane, ln in enumerate(bucket.list_ids):
                    if ln < 0:
                        continue
                    c = get_codes(int(ln)).reshape(-1, self.code_size)
                    if len(c):
                        payload[lane, :, : len(c)] = self.pq.decode(c).T
            else:
                payload = np.zeros((B, self.pq.M, n_pad), dtype=np.uint8)
                for lane, ln in enumerate(bucket.list_ids):
                    if ln < 0:
                        continue
                    c = get_codes(int(ln))
                    payload[lane, :, : len(c) // self.code_size] = c.reshape(
                        -1, self.pq.M
                    ).T
            self._scan.append(
                _ScanBucket(
                    list_ids=bucket.list_ids,
                    lengths_dev=jnp.asarray(bucket.lengths),
                    payload=jnp.asarray(payload),
                    n_pad=n_pad,
                )
            )
            for lane, ln in enumerate(bucket.list_ids):
                if ln >= 0:
                    self._list_to_scan[int(ln)] = (si, lane)
        # vectorized list -> (bucket, lane) tables for the grouping step
        self._bucket_of = np.full(self.nlist, -1, dtype=np.int32)
        self._lane_of = np.zeros(self.nlist, dtype=np.int32)
        for ln, (si, lane) in self._list_to_scan.items():
            self._bucket_of[ln] = si
            self._lane_of[ln] = lane
        # flat code table for the vectorized shortlist harvest
        codes_per_list = [
            np.asarray(get_codes(ln), np.uint8) for ln in range(self.nlist)
        ]
        self._codes_offsets = np.zeros(self.nlist + 1, dtype=np.int64)
        np.cumsum([len(c) for c in codes_per_list],
                  out=self._codes_offsets[1:])
        self._codes_flat = (
            np.concatenate(codes_per_list)
            if self._codes_offsets[-1] else np.empty(0, np.uint8)
        )

    # ----------------------------------------------------------------- search

    def search_positional(self, xq: np.ndarray, k: int, nprobe: Optional[int] = None):
        """Scan only: returns (D f32[nq, k], labels i64[nq, k]) with packed
        (list_no << 32 | offset) labels, -1 for empty slots — the equivalent
        of search_preassigned(store_pairs=true) (custom_invlists_impl.cpp:427-428)."""
        nprobe = nprobe or self.nprobe
        xq = np.asarray(xq, dtype=np.float32)
        nq = len(xq)
        xq_dev = jnp.asarray(xq)
        probes = self.coarse_assign(xq, nprobe)  # [nq, nprobe], -1 = unprobed

        luts = (self.pq.compute_luts(xq_dev)
                if self.storage == "pq" and not self._scan_is_float else None)

        # group (query, probe) pairs by scan bucket — all vectorized.
        # Device memory is bounded by chunking: the dense path materializes
        # [nq_c, B * n_pad] distances and the pair path gathers
        # [P_c, n_pad, d] payloads, both capped at ~VDBIDC_SCAN_BUDGET f32
        # elements per dispatch (default 2^28 = 1 GiB) so reference-scale
        # databases (1M-100M entries) stream through in slabs
        import os as _os

        budget = int(_os.environ.get("VDBIDC_SCAN_BUDGET", str(2 ** 28)))
        # -1 probes (HNSW quantizer shortfall) drop out as bucket -1
        b_of = np.where(probes >= 0,
                        self._bucket_of[np.maximum(probes, 0)],
                        np.int32(-1))                  # i32[nq, nprobe]
        # dispatch every bucket/chunk async; scan outputs stay ON DEVICE and
        # feed one scatter+merge program at the end — per-chunk np.asarray
        # pulls and the host cand_d/cand_l round trip each pay a device
        # round trip
        pend_idx = []  # (q_emit i32[Pc] pad=nq, p_emit i32[Pc], lns i64[Pc])
        pend_dev = []  # (dists f32[Pc, k], offs i32[Pc, k]) device arrays
        for si in np.unique(b_of[b_of >= 0]):
            sb = self._scan[si]
            q_arr, p_arr = np.nonzero(b_of == si)
            lns = probes[q_arr, p_arr]
            lanes_np = self._lane_of[lns]
            P = len(q_arr)
            B = len(sb.list_ids)
            # cost model: the pair path pays payload traffic P*n_pad*d and
            # top-k over P*n_pad keys; dense pays B*n_pad*d traffic but
            # top-k over nq*B*n_pad keys. Sorting a key costs ~100x more
            # than streaming a byte, so dense only wins in the near-full-
            # probe regime (P approaching nq*B, e.g. nprobe ~ nlist) — at
            # 10M ids/nprobe=64 the old "P > 2B" rule picked dense and
            # spent 64x the needed top-k work
            dense = self._scan_is_float and 4 * P >= nq * B
            if dense:
                # all lanes x all queries (see _scan_flat_allpairs): the
                # payload streams through HBM once; lane slabs inside the
                # one program keep the distance buffer under the budget
                slab = max(1, budget // max(nq * sb.n_pad, 1))
                d_all, o_all = _scan_flat_allpairs(
                    xq_dev, sb.payload, sb.lengths_dev, k,
                    slab if B > slab else 0)
                # gather the probed pairs ON device — fetching the full
                # [nq, B, k] tensors to host costs far more than the scan
                qa = jnp.asarray(q_arr.astype(np.int32))
                la = jnp.asarray(lanes_np)
                pend_idx.append((q_arr.astype(np.int32),
                                 p_arr.astype(np.int32),
                                 lns.astype(np.int64)))
                pend_dev.append((d_all[qa, la], o_all[qa, la]))
                continue
            P_c = _pad_pow2(min(P, max(1, budget // max(
                sb.n_pad * (self.d if self._scan_is_float else self.pq.M),
                1))))
            for ps in range(0, P, P_c):
                pe = min(ps + P_c, P)
                q_idx = np.zeros(P_c, dtype=np.int32)
                lanes = np.zeros(P_c, dtype=np.int32)
                q_idx[: pe - ps], lanes[: pe - ps] = (q_arr[ps:pe],
                                                      lanes_np[ps:pe])
                pairs = (jnp.asarray(q_idx), jnp.asarray(lanes))
                if self._scan_is_float:
                    dists, offs = _scan_flat_bucket(
                        xq_dev, sb.payload, sb.lengths_dev, pairs, k
                    )
                else:
                    dists, offs = _scan_pq_bucket(
                        luts, sb.payload, sb.lengths_dev, pairs, k
                    )
                # pad rows are marked q_emit == nq → dropped by the scatter
                q_emit = np.full(P_c, nq, dtype=np.int32)
                p_emit = np.zeros(P_c, dtype=np.int32)
                l_emit = np.zeros(P_c, dtype=np.int64)
                q_emit[: pe - ps] = q_arr[ps:pe]
                p_emit[: pe - ps] = p_arr[ps:pe]
                l_emit[: pe - ps] = lns[ps:pe]
                pend_idx.append((q_emit, p_emit, l_emit))
                pend_dev.append((dists, offs))

        if not pend_dev:
            return (np.full((nq, k), np.inf, np.float32),
                    np.full((nq, k), -1, np.int64))

        # one scatter+merge program over all chunks; pad the row count to a
        # power of two so reruns with slightly different probe histograms
        # reuse the compiled program
        Pt = sum(len(q) for q, _, _ in pend_idx)
        Pt_pad = _pad_pow2(Pt)
        q_all = np.full(Pt_pad, nq, dtype=np.int32)
        p_all = np.zeros(Pt_pad, dtype=np.int32)
        l_all = np.zeros(Pt_pad, dtype=np.int64)
        pos = 0
        for q_e, p_e, l_e in pend_idx:
            q_all[pos: pos + len(q_e)] = q_e
            p_all[pos: pos + len(q_e)] = p_e
            l_all[pos: pos + len(q_e)] = l_e
            pos += len(q_e)
        d_cat = jnp.concatenate(
            [d for d, _ in pend_dev]
            + ([jnp.full((Pt_pad - Pt, k), jnp.inf, jnp.float32)]
               if Pt_pad > Pt else []))
        o_cat = jnp.concatenate(
            [o for _, o in pend_dev]
            + ([jnp.zeros((Pt_pad - Pt, k), jnp.int32)]
               if Pt_pad > Pt else []))
        # per-query ||x||^2 completes the L2 distance for the flat/qinco
        # scan; LUT (PQ) distances are already complete
        x2 = ((xq * xq).sum(axis=1) if self._scan_is_float
              else np.zeros(nq, np.float32))
        D, L = _emit_merge_device(
            jnp.asarray(q_all), jnp.asarray(p_all), jnp.asarray(l_all),
            d_cat, o_cat, jnp.asarray(x2, dtype=jnp.float32), nq, nprobe, k)
        D = np.asarray(D)
        L = np.asarray(L)
        D = np.where(L >= 0, D, np.inf)
        return D, L

    def search_defer_id_decoding(
        self,
        xq: np.ndarray,
        k: int,
        nprobe: Optional[int] = None,
        decode_1by1: Optional[bool] = None,
        return_codes: int = 0,
        include_listno: bool = False,
    ):
        """Full deferred-decoding search (reference C13 + swig wrapper B1).

        return_codes: 0 = no codes, nonzero = also return the shortlist's
        payload codes (2 in the reference means include the listno prefix —
        here expressed via include_listno).
        Returns (D, I) or (D, I, codes).
        """
        import os as _os
        import time as _time

        timed = _os.environ.get("VDBIDC_TIME_PHASES") == "1"
        t0 = _time.time()
        D, L = self.search_positional(xq, k, nprobe)
        t1 = _time.time()
        container = self.active
        if decode_1by1 is None:
            decode_1by1 = getattr(container, "supports_random_access", True)

        codes_out = None
        if return_codes:
            codes_out = self._harvest_codes(L, include_listno or return_codes == 2)
        t2 = _time.time()

        I = self._translate(L, decode_1by1)
        if timed:
            print(f"[phases] positional {t1-t0:.3f}s harvest {t2-t1:.3f}s "
                  f"translate {_time.time()-t2:.3f}s", file=sys.stderr,
                  flush=True)
        if codes_out is not None:
            return D, I, codes_out
        return D, I

    def search(self, xq: np.ndarray, k: int, nprobe: Optional[int] = None):
        """Standard search: ids translated for every result."""
        return self.search_defer_id_decoding(xq, k, nprobe)

    # ----------------------------------------------------- translation & codes

    def _translate(self, labels: np.ndarray, decode_1by1: bool) -> np.ndarray:
        container = self.active
        out = labels.copy()
        flat = labels.reshape(-1)
        valid = flat >= 0
        if not valid.any():
            return out
        lns = lo_listno(flat[valid])
        offs = lo_offset(flat[valid])
        if isinstance(container, InvertedLists):
            ids = np.array(
                [container.ids[ln][off] for ln, off in zip(lns, offs)],
                dtype=np.int64,
            )
        elif decode_1by1 and container.supports_random_access:
            ids = container.get_single_ids_batch(lns, offs).astype(np.int64)
        else:
            # grouped: decode each touched list once (reference .cpp:477-525),
            # offsets gathered on device — one [n_labels] pull
            ids = container.decode_select(lns, offs).astype(np.int64)
        res = flat.copy()
        res[valid] = ids
        return res.reshape(labels.shape)

    def _harvest_codes(self, labels: np.ndarray, include_listno: bool) -> np.ndarray:
        """Shortlist payload codes, 0xff-filled for empty slots
        (reference .cpp:433-462). One fancy-indexed gather over the flat code
        table built at replace_invlists — no per-result Python loop."""
        cs = self.code_size
        ccs = self.coarse_code_size if include_listno else 0
        cs1 = cs + ccs
        flat = labels.reshape(-1)
        out = np.full((len(flat), cs1), 0xFF, dtype=np.uint8)
        valid = flat >= 0
        if valid.any() and cs:
            lns = lo_listno(flat[valid])
            offs = lo_offset(flat[valid])
            starts = self._codes_offsets[lns] + offs * cs
            out[np.flatnonzero(valid), ccs:] = self._codes_flat[
                starts[:, None] + np.arange(cs, dtype=np.int64)
            ]
        if include_listno and valid.any():
            # little-endian listno prefix (reference encode_listno)
            lns = lo_listno(flat[valid])
            out[np.flatnonzero(valid), :ccs] = (
                (lns[:, None] >> (8 * np.arange(ccs, dtype=np.int64))) & 0xFF
            ).astype(np.uint8)
        return out.reshape(*labels.shape, cs1)


# ---------------------------------------------------------------------------
# whole-index persistence (the faiss.write_index/read_index analogue —
# search_ivf_qinco.py:475-499; the reference has no format for the compressed
# containers, store/serialize.py provides that part)
# ---------------------------------------------------------------------------


def save_index(path, index: IndexIVF) -> None:
    """One .npz holding the trained index + source inverted lists. Compressed
    ID containers are saved separately (store.serialize.save_invlists) and
    swapped in after load with replace_invlists."""
    import json

    il = index.invlists
    if il is None:  # trained-only index (the reference also writes these,
        il = InvertedLists(index.nlist, index.code_size)  # :475-476)
    lengths = il.lengths
    ids_flat = (np.concatenate([il.ids[i] for i in range(il.nlist)])
                if lengths.sum() else np.zeros(0, np.uint64))
    codes_flat = (np.concatenate([il.codes[i] for i in range(il.nlist)])
                  if lengths.sum() else np.zeros(0, np.uint8))
    meta = dict(d=index.d, nlist=index.nlist, storage=index.storage,
                nprobe=index.nprobe, ntotal=index.ntotal,
                code_size=index.code_size, quantizer=index.quantizer,
                quantizer_efSearch=index.quantizer_efSearch,
                quantizer_M=index.quantizer_M)
    arrs = dict(
        centroids=index.centroids,
        lengths=lengths,
        ids_flat=ids_flat,
        codes_flat=codes_flat,
        meta=np.array(json.dumps(meta)),
    )
    if index.storage == "pq":
        arrs["pq_centroids"] = index.pq.centroids
        arrs["pq_meta"] = np.array([index.pq.M], dtype=np.int64)
    elif index.storage == "qinco":
        q = index.qinco
        arrs["qinco_meta"] = np.array([q.d, q.M, q.ksub,
                                       q.model.hidden], dtype=np.int64)
        leaves = jax.tree_util.tree_leaves(q.params)
        for i, leaf in enumerate(leaves):
            arrs[f"qinco_leaf{i}"] = np.asarray(leaf)
    np.savez(path, **arrs)


def load_index(path) -> IndexIVF:
    import json

    z = np.load(path, allow_pickle=False)
    meta = json.loads(str(z["meta"]))
    storage = meta["storage"]
    kwargs = {}
    if storage == "pq":
        kwargs["pq_m"] = int(z["pq_meta"][0])
    elif storage == "qinco":
        from ..models.qinco import QincoCodec

        d, M, ksub, hidden = (int(v) for v in z["qinco_meta"])
        qc = QincoCodec(d, M, ksub=ksub, hidden=hidden)
        # same model config => same treedef; unflatten the saved leaves
        sample = jnp.zeros((1, d), jnp.float32)
        ref = qc.model.init(jax.random.PRNGKey(0), sample)
        treedef = jax.tree_util.tree_structure(ref)
        n_leaves = treedef.num_leaves
        leaves = [jnp.asarray(z[f"qinco_leaf{i}"]) for i in range(n_leaves)]
        qc.params = jax.tree_util.tree_unflatten(treedef, leaves)
        kwargs["qinco"] = qc
    index = IndexIVF(meta["d"], meta["nlist"], storage=storage,
                     nprobe=meta["nprobe"],
                     quantizer=meta.get("quantizer", "flat"),
                     quantizer_efSearch=meta.get("quantizer_efSearch", 64),
                     quantizer_M=meta.get("quantizer_M", 32), **kwargs)
    index.centroids = z["centroids"]
    if storage == "pq":
        index.pq.centroids = z["pq_centroids"]
    lengths = z["lengths"]
    offsets = np.zeros(len(lengths) + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    cs = meta["code_size"]
    il = InvertedLists(meta["nlist"], cs)
    # materialize ONCE: indexing the NpzFile re-reads and re-inflates the
    # whole member per subscript — 2*nlist full decompressions otherwise
    # (minutes at 10M ids)
    ids_flat = z["ids_flat"]
    codes_flat = z["codes_flat"]
    for ln in range(meta["nlist"]):
        b, e = offsets[ln], offsets[ln + 1]
        il.add_entries(ln, ids_flat[b:e], codes_flat[b * cs:e * cs])
    index.ntotal = meta["ntotal"]
    if index.ntotal > 0:
        index.invlists = il
        index.replace_invlists(il)
    return index

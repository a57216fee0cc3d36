"""Sharded deferred-ID-decoding IVF search — the whole query path over a
device mesh.

SURVEY.md §2.4 maps the reference's per-list OpenMP parallelism
(custom_invlists_impl.cpp:420-525) onto a 1-D "lists" mesh axis; round 1
sharded only the codec. This module shards the *search* end-to-end in ONE
shard_map program per query batch:

  coarse:    each shard scores its centroid slice ([nq, d] x [d, B_loc]
             matmul), takes a local top-nprobe, and the per-shard
             candidates ride ``all_gather`` into a replicated global
             top-nprobe merge (lexicographic (distance, id) tie-break, so
             the probe set is independent of the shard count);
  scan:      each shard scans only ITS probed lists (positional labels,
             ids untouched), local masked top-k;
  merge:     ``all_gather`` of per-shard shortlists + replicated
             (distance, label) merge — the collective replacing the
             reference's single-threaded heap merge;
  translate: grouped deferred decoding, sharded — each shard gathers the
             *touched* subset of its own compressed lists into a static
             T_cap-lane buffer, runs the batched ANS decode chain on just
             those lanes, translates the labels it owns, and the shards'
             partial translations combine with a ``psum`` (every label is
             owned by exactly one shard).

Lists are sharded contiguously (shard s owns rows [s*B_loc, (s+1)*B_loc)),
so artifact/list order is deterministic and N-device results match 1-device
results (asserted in tests/test_parallel.py).

Multi-process: the constructor is process-local by default — each process
materializes ONLY the rows its addressable devices own and feeds them
through ``jax.make_array_from_process_local_data`` (never ``device_put`` of
a full host array, which raises for non-addressable shardings). Under
``jax.distributed.initialize`` (parallel.multihost) the same ctor + program
span hosts, with the coarse/merge all_gathers and the translation psum
riding the interconnect (NCCL on GPUs). Per-list metadata (lengths, bucket
capacities) stays global on every process — it is O(nlist) ints; the
O(ntotal) payload/codec tables are only ever materialized for local rows.
The single-kernel ROC translate path is process-local too: each process
builds decoder lane buffers for its rows padded to GLOBAL maxima (identical
kernel shapes on every process). ``interpret=True`` runs that kernel in
Pallas interpret mode, for CPU (incl. multi-process) test coverage.
"""

from __future__ import annotations

import os
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..codecs import roc_device as rd
from ..codecs.elias_fano import EliasFanoBatch, ef_select
from ..codecs.rrr import RRRPlanes
from ..codecs.wavelet_tree import WaveletTree, wt_select, wt_select_rrr
from ..core.bits import BitVectorBatch as _BVB, build_bitvector_batch
from ..store.invlists import (
    EliasFanoInvertedLists,
    InvertedLists,
    PackedBitsInvertedLists,
    RocInvertedLists,
    WaveletTreeInvertedLists,
)

_OFF_MASK = jnp.int64((1 << 32) - 1)
# f32 distance products: a GPU may otherwise run them in TF32
HIGHEST = jax.lax.Precision.HIGHEST


# canonical process-local bounds helper lives in parallel.multihost (the
# multi-host runtime module); keep the old private name as an alias
from .multihost import addressable_row_bounds as _addressable_row_bounds


class ShardedIVF:
    """IVF flat/pq/qinco search sharded over a 'lists' mesh.

    ``index`` is a trained search.ivf.IndexIVF; ``container`` selects the ID
    translation path: None / InvertedLists → raw sharded id table;
    RocInvertedLists → sharded grouped ANS decode of the touched lists (the
    deferred-decoding flagship). PQ storage scans the *decoded* f32
    reconstructions when they fit VDBIDC_PQ_DECODE_BUDGET — the ADC distance
    equals the exact L2 to the reconstruction (see search/ivf.py), so the
    scan stays on the matmul path; past the budget (or with
    VDBIDC_PQ_DECODE_SCAN=0) it falls back to the byte-payload LUT scan,
    mirroring the host path's policy.

    ``process_local=True`` (default): each process builds only the rows its
    addressable devices own (multi-process ready). ``False`` keeps the
    legacy full-host-array ``device_put`` construction — single-process
    only, retained so tests can assert both paths produce identical D/I.

    ``interpret=True`` runs the ROC decode kernel in Pallas interpret mode
    (CPU tests); otherwise ops.route picks the kernel on a GPU mesh and the
    XLA path elsewhere.
    """

    def __init__(self, mesh: Mesh, index, container=None,
                 process_local: bool = True, interpret: bool = False):
        assert index.storage in ("flat", "qinco", "pq"), "unknown storage"
        self.mesh = mesh
        self.n_shards = mesh.size
        self.nlist = index.nlist
        self.d = index.d
        container = container if container is not None else index.invlists
        self.container = container
        self._process_local = process_local

        N = self.n_shards
        self.nlist_pad = ((self.nlist + N - 1) // N) * N
        self.b_loc = self.nlist_pad // N
        # per-list metadata stays GLOBAL on every process (O(nlist) ints);
        # only O(ntotal) payload below is restricted to local rows
        lengths = np.zeros(self.nlist_pad, dtype=np.int32)
        lengths[: self.nlist] = np.asarray(container.lengths, np.int32)
        self.n_pad = max(int(lengths.max()), 1)
        lo, hi = ((0, self.nlist_pad) if not process_local
                  else _addressable_row_bounds(mesh, self.nlist_pad))
        self._rows = (lo, hi)
        R = hi - lo
        row_lns = range(lo, min(hi, self.nlist))  # real (non-pad) local rows

        # scan representation: f32 reconstructions (matmul) vs u8 codes + LUT
        # (honors the same budget/env opt-out as search/ivf.py:350-359)
        self._scan_is_float = index.storage in ("flat", "qinco")
        if index.storage == "pq":
            budget_el = int(os.environ.get("VDBIDC_PQ_DECODE_BUDGET",
                                           str(2 ** 30)))
            self._scan_is_float = (
                os.environ.get("VDBIDC_PQ_DECODE_SCAN", "1") != "0"
                and self.nlist_pad * self.n_pad * index.d <= budget_el)
        self._pq_m = index.pq.M if index.storage == "pq" else 0
        self._width = self.d if self._scan_is_float else self._pq_m

        # scan payload in the ACTIVE container's code order (same invariant
        # as IndexIVF.replace_invlists)
        get_codes = (
            container.get_codes if hasattr(container, "get_codes")
            else (lambda ln: container.codes[ln])
        )
        # channel-major [lists, d|M, n_pad]: the minormost dim is the long
        # one (same layout as search/ivf.py)
        vecs = np.zeros((R, self._width, self.n_pad),
                        np.float32 if self._scan_is_float else np.uint8)
        for ln in row_lns:
            c = np.asarray(get_codes(ln), np.uint8)
            n = len(c) // index.code_size
            if n == 0:
                continue
            r = ln - lo
            if index.storage == "flat":
                vecs[r, :, :n] = c.view(np.float32).reshape(n, -1).T
            elif index.storage == "pq":
                rows = c.reshape(n, index.code_size)
                if self._scan_is_float:  # decoded reconstructions (matmul)
                    vecs[r, :, :n] = index.pq.decode(rows).T
                else:  # raw u8 codes, channel-major (LUT scan)
                    vecs[r, :, :n] = rows.T
            else:  # qinco: linear reconstructions (see search/ivf.py NOTE)
                rows = c.reshape(n, index.code_size)
                vecs[r, :, :n] = (
                    index.qinco.lin_decode(rows[:, : index.qinco.M])
                    + index.centroids[ln]
                ).T

        cents = np.zeros((R, index.d), np.float32)
        cents[: max(min(hi, self.nlist) - lo, 0)] = index.centroids[
            lo: min(hi, self.nlist)]

        self._cents = self._put(cents, P("lists", None))
        self._vecs = self._put(vecs, P("lists", None, None))
        self._lengths = self._put(lengths[lo:hi], P("lists"))
        if not self._scan_is_float:
            # subspace centroids ride replicated; each shard builds the
            # [nq, M, ksub] LUTs itself (tiny, replicated compute)
            self._pq_cents = self._put(
                np.asarray(index.pq.centroids, np.float32), P())

        # ---- translation tables ------------------------------------------
        # each container maps onto the translate stage differently: ROC is
        # grouped full-list decode of the touched lanes; packed/EF are O(1)
        # random access on lane-sharded words; the wavelet tree is one
        # global structure (replicated, each shard translates the labels it
        # owns); raw is a sharded id table
        self._kernel = None  # ROC decode-kernel inputs (roc mode only)
        if isinstance(container, RocInvertedLists):
            self._mode = "roc"
            st, prec = _roc_states_in_list_order(container, lo, hi)
            self._states = jax.tree_util.tree_map(
                lambda a: self._put(a, P("lists")), st)
            self._prec = self._put(prec, P("lists"))
            self._n_slices = rd.n_slices_for(
                int(max((int(np.asarray(p).max(initial=1))
                         for p in container._precisions), default=1)))
            # process-local kernel decoder: each process builds lane
            # buffers for ITS rows only, padded to GLOBAL maxima
            self._kernel = self._kernel_translate(st, lengths, prec,
                                                  interpret)
        elif isinstance(container, PackedBitsInvertedLists):
            self._mode = "packed"
            self._pb_width = container.bits
            W = max(
                int(np.asarray(pb.words).shape[1]) for pb in container._packed)
            words = np.zeros((R, W), np.uint32)
            for ln in row_lns:
                if ln not in container._list_to_bucket:
                    continue  # empty list: no packed words, never queried
                bi, lane = container._list_to_bucket[ln]
                w = np.asarray(container._packed[bi].words)[lane]
                words[ln - lo, : len(w)] = w
            self._pb_words = self._put(words, P("lists", None))
        elif isinstance(container, EliasFanoInvertedLists):
            self._mode = "ef"
            self._ef_arrays = _ef_in_list_order(container, lo, hi, self._put)
        elif isinstance(container, WaveletTreeInvertedLists):
            self._mode = "wt" if container.wt_type == 0 else "wt1"
            # global structure over ntotal — replicated across the mesh;
            # static fields (n, levels) ride the closure, arrays the args
            wt = container.wt
            self._wt_static = (wt.n, wt.levels)
            fields = (wt[:2] if self._mode == "wt"
                      else (wt.classes, wt.off_words, wt.sb_off_start,
                            wt.sb_rank))
            # + the precomputed per-symbol walk tables (wt_path_tables):
            # they drop the whole top-down rank sweep from the translate
            fields = fields + (np.asarray(container.wt_tables),)
            self._wt_arrays = tuple(
                self._put(np.asarray(a), P()) for a in fields)
        else:
            self._mode = "raw"
            ids = np.zeros((R, self.n_pad), np.uint64)
            for ln in row_lns:
                v = (container.ids[ln] if isinstance(container, InvertedLists)
                     else container.get_ids(ln))
                ids[ln - lo, : len(v)] = v
            self._ids = self._put(ids, P("lists", None))
        self._compiled = {}

    # ------------------------------------------------- global array assembly

    def _put(self, local: np.ndarray, spec: P) -> jax.Array:
        """Assemble a global mesh-sharded array from this process's local
        rows (make_array_from_process_local_data — works under any process
        count) or, in legacy mode, device_put the full host array."""
        sh = NamedSharding(self.mesh, spec)
        local = np.asarray(local)
        if not self._process_local:
            return jax.device_put(jnp.asarray(local), sh)
        if spec and len(spec) > 0 and spec[0] == "lists":
            gshape = (self.nlist_pad,) + local.shape[1:]
        elif spec and len(spec) > 1 and spec[1] == "lists":
            # lane-minor (column) sharding — the Pallas translate buffers
            gshape = (local.shape[0], self.nlist_pad) + local.shape[2:]
        else:  # replicated: every process holds the full array
            gshape = local.shape
        return jax.make_array_from_process_local_data(sh, local, gshape)

    # -------------------------------------------------- kernel translation

    def _kernel_translate(self, st, lengths, prec, interpret):
        """Prepare the decode kernel for the fused translate stage: decode
        ALL local lanes in one kernel call instead of the XLA scan chain
        over the touched lanes. Returns the mesh-sharded kernel inputs, or
        None when the route (ops.route, from the mesh's platform and the
        container's precision) is the XLA path.

        PROCESS-LOCAL: ``st``/``prec`` cover only this process's rows
        [lo, hi); the decoder is built over those lanes padded to GLOBAL
        maxima (n_pad from the global length table, stack height from the
        container's global bucket metadata), so every process compiles the
        identical kernel shape and the buffers assemble into one
        mesh-sharded array via ``_put``.

        Lanes are sorted by length (descending) WITHIN each shard's block:
        the kernel's step loop runs to each program's max length, so sorting
        turns the global-max padding into per-block bounds that track the
        real length distribution. The program maps original local lanes
        through the inverse permutation.

        One full decode of the local lanes validates the err flag here:
        per-lane decode is deterministic and the fused program always
        decodes every local lane, so the in-program flag stays clear."""
        from ..ops import roc_pallas as rp
        from ..ops import route

        platform = np.asarray(self.mesh.devices).reshape(-1)[0].platform
        # global precision (container metadata, same on every process) —
        # NOT the local-row max, which could differ per process
        maxp_g = int(max((int(np.asarray(p).max(initial=1))
                          for p in self.container._precisions), default=1))
        if route.roc_decode_route(maxp_g, platform=platform,
                                  interpret=interpret) == route.XLA:
            return None
        lo, hi = self._rows
        B_loc = self.b_loc
        R = hi - lo
        lens_loc = np.asarray(lengths)[lo:hi]
        order = np.concatenate([
            s * B_loc + np.argsort(-lens_loc[s * B_loc:(s + 1) * B_loc],
                                   kind="stable")
            for s in range(R // B_loc)])
        inv = np.empty_like(order)
        inv[order] = np.arange(len(order))
        inv_loc = (inv % B_loc).astype(np.int32)  # local sorted position
        st_p = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a)[order]), st)
        # global stack-height maximum so every process pads identically
        capp_g = max((int(np.asarray(s_.stack_len).max(initial=0))
                      for s_ in self.container._states), default=0)
        dec = rp.RocPallasDecoder(
            st_p, lens_loc[order], np.asarray(prec)[order],
            rd.default_pool(self.n_pad), self.n_pad, capp=capp_g)
        ok = dec.decode(interpret=interpret)[1]
        if jax.process_count() > 1:  # every process raises together
            from jax.experimental import multihost_utils

            ok = bool(multihost_utils.process_allgather(
                np.asarray(ok, np.int32)).min())
        if not ok:
            raise RuntimeError("ROC decode kernel flagged stack/pool "
                               "exhaustion: the container's streams are "
                               "corrupt")
        row, col = P("lists"), P(None, "lists")
        arrs = (self._put(np.asarray(dec.buf), col),
                self._put(np.asarray(dec.head), row),
                self._put(np.asarray(dec.ptr), row),
                self._put(np.asarray(dec.lens), col),
                self._put(np.asarray(dec.prec), col),
                self._put(inv_loc, row))
        return arrs, (self.n_pad, interpret)

    # ------------------------------------------------------------------ API

    def search(self, xq: np.ndarray, k: int, nprobe: int):
        """Deferred-decoding search → (D f32[nq, k], I i64[nq, k]); ids are
        fully translated, -1 for empty slots. One device program per query
        chunk, sized so per-shard scan memory stays under
        ~VDBIDC_SCAN_BUDGET f32 elements: the dense path materializes a
        [nq_c, B_loc*n_pad] distance slab; the pair path's big buffers are
        slab-bounded internally, so its nq-scaling footprint is just the
        [nq_c*nprobe, k]-class shortlist tensors."""
        xq = np.asarray(xq, np.float32)
        nq = len(xq)
        budget = int(os.environ.get("VDBIDC_SCAN_BUDGET", str(2 ** 28)))
        nq_c = max(1, min(nq, budget // max(self.b_loc * self.n_pad, 1)))
        return self._search_all(xq, nq, nq_c, k, nprobe)

    def _pair_scan(self, nprobe: int) -> bool:
        """Scan-path choice, independent of mesh size (the 1-device rule):
        flipping paths with device count would change tie-break order in
        shard-local top-k under exact distance ties (ADVICE r2)."""
        return 4 * nprobe < self.nlist_pad

    def _search_all(self, xq, nq, nq_c, k, nprobe):
        if self._pair_scan(nprobe):
            # pair-path footprint per query is ~4 shortlist tensors of
            # nprobe*k entries (payload gathers are slab-bounded inside the
            # program) — don't let the dense-slab formula force tiny chunks
            budget = int(os.environ.get("VDBIDC_SCAN_BUDGET", str(2 ** 28)))
            nq_c = max(nq_c, min(nq, budget // max(4 * nprobe * k, 1)))
        if nq_c >= nq:
            return self._search_chunk(xq, k, nprobe)
        D = np.empty((nq, k), np.float32)
        I = np.empty((nq, k), np.int64)
        for qs in range(0, nq, nq_c):
            qe = min(qs + nq_c, nq)
            chunk = xq[qs:qe]
            if qe - qs < nq_c:  # pad the ragged tail to reuse the program
                chunk = np.concatenate(
                    [chunk, np.zeros((nq_c - (qe - qs), xq.shape[1]),
                                     np.float32)])
            Dc, Ic = self._search_chunk(chunk, k, nprobe)
            D[qs:qe] = Dc[: qe - qs]
            I[qs:qe] = Ic[: qe - qs]
        return D, I

    def _search_chunk(self, xq: np.ndarray, k: int, nprobe: int):
        nq = len(xq)
        key = (nq, k, nprobe)
        if key not in self._compiled:
            self._compiled[key] = self._build(nq, k, nprobe)
        D, I = self._compiled[key](jnp.asarray(xq))
        return np.asarray(D), np.asarray(I)

    # ------------------------------------------------------------ the program

    def _build(self, nq: int, k: int, nprobe: int):
        B_loc, n_pad, d = self.b_loc, self.n_pad, self.d
        nlist, mode = self.nlist, self._mode
        scan_float, pq_m = self._scan_is_float, self._pq_m
        width = self._width
        pl_nmax, pl_interp = 0, False
        if mode == "roc" and self._kernel is not None:
            mode = "roc_pl"
            pl_nmax, pl_interp = self._kernel[1]
        T_cap = max(1, min(B_loc, nq * nprobe))
        np_loc = min(nprobe, B_loc)
        n_slices = self._n_slices if mode == "roc" else 0
        pool = rd.default_pool(n_pad) if mode == "roc" else None
        pb_width = self._pb_width if mode == "packed" else 0
        wt_static = self._wt_static if mode in ("wt", "wt1") else None
        # scan cost model (same as search/ivf.py): the dense all-lanes scan
        # streams the payload once but pays top-k over EVERY (query, lane)
        # slot — nq * B_loc * n_pad keys, ~100x/key the cost of streaming
        # (NOTES.md) — so it only wins near full probe. The pair path
        # gathers each probed lane per probing query (more HBM traffic) but
        # sorts only nq * nprobe * n_pad keys. The choice is made on GLOBAL
        # shape (nlist_pad, not B_loc) so results don't change with device
        # count under exact distance ties (ADVICE r2).
        pair_scan = self._pair_scan(nprobe)
        P_cap = nq * nprobe
        budget = int(os.environ.get("VDBIDC_SCAN_BUDGET", str(2 ** 28)))
        # profiling hooks: stop the program after a stage and return
        # shape-compatible dummies — the scaling bench times the cumulative
        # programs and differences them into per-phase costs
        # (coarse / scan / merge / translate). VDBIDC_ABLATE_TRANSLATE=1 is
        # the legacy alias for stage=merge (positional labels as I).
        ablate_stage = os.environ.get("VDBIDC_ABLATE_STAGE", "")
        if os.environ.get("VDBIDC_ABLATE_TRANSLATE") == "1":
            ablate_stage = ablate_stage or "merge"
        ablate_translate = ablate_stage == "merge"

        def lut_from(xq, pq_c):
            """Replicated per-query ADC LUTs f32[nq, M, ksub] (complete
            squared L2 — no +||x||^2 term needed at merge)."""
            dsub = d // pq_m
            xs = xq.reshape(nq, pq_m, dsub)
            dots = jnp.einsum("qmd,mkd->qmk", xs, pq_c,
                              preferred_element_type=jnp.float32,
                              precision=HIGHEST)
            c2 = jnp.sum(pq_c * pq_c, axis=2)
            x2s = jnp.sum(xs * xs, axis=2)
            return x2s[:, :, None] - 2.0 * dots + c2[None, :, :]

        def local(xq, cents_l, vecs_l, lengths_l, *rest):
            if scan_float:
                trans = rest
                luts = None
            else:
                pq_c, *trans = rest
                luts = lut_from(xq, pq_c)
            s = jax.lax.axis_index("lists")
            base = (s * B_loc).astype(jnp.int64)
            gl = base + jnp.arange(B_loc, dtype=jnp.int64)   # global list ids

            # ---- coarse: local slice scores + replicated global merge ----
            dots = jnp.dot(xq, cents_l.T, preferred_element_type=jnp.float32,
                           precision=HIGHEST)
            c2 = jnp.sum(cents_l * cents_l, axis=1)
            cd2 = jnp.where((gl < nlist)[None, :], c2[None, :] - 2.0 * dots,
                            jnp.inf)
            loc_d, loc_i = jax.lax.top_k(-cd2, np_loc)       # [nq, np_loc]
            loc_id = base + loc_i.astype(jnp.int64)
            all_d = jax.lax.all_gather(-loc_d, "lists")      # [N, nq, np_loc]
            all_id = jax.lax.all_gather(loc_id, "lists")
            Ng = all_d.shape[0]
            cand_d = jnp.moveaxis(all_d, 0, 1).reshape(nq, Ng * np_loc)
            cand_i = jnp.moveaxis(all_id, 0, 1).reshape(nq, Ng * np_loc)
            order = jnp.lexsort((cand_i, cand_d), axis=1)[:, :nprobe]
            probes = jnp.take_along_axis(cand_i, order, axis=1)  # [nq, nprobe]
            if ablate_stage == "coarse":  # phase profiling: stop here
                Dd = jnp.zeros((nq, k), jnp.float32) + jnp.sum(
                    probes, axis=1, keepdims=True).astype(jnp.float32)
                return Dd, jnp.zeros((nq, k), jnp.int64)

            # ---- scan: only my probed lists ------------------------------
            lp = probes - base                                # local or out
            in_range = (lp >= 0) & (lp < B_loc)
            if pair_scan:
                # gather the probed (query, lane) pairs; top-k per pair only
                flat_lp = jnp.where(in_range, lp, B_loc).astype(
                    jnp.int32).reshape(-1)                    # [nq*nprobe]
                sel = jnp.nonzero(flat_lp < B_loc, size=P_cap,
                                  fill_value=P_cap)[0]
                valid_pair = sel < P_cap
                sel_safe = jnp.minimum(sel, P_cap - 1).astype(jnp.int32)
                q_idx = sel_safe // nprobe
                p_idx = sel_safe % nprobe
                lane = flat_lp[sel_safe]       # may be B_loc on pad rows
                k_p = min(k, n_pad)
                # slab the pair gather so the [C, width, n_pad] payload
                # stays under the scan budget (same chunking as host path)
                C = max(1, min(P_cap, budget // max(width * n_pad, 1)))
                n_slabs = -(-P_cap // C)
                Ppad = n_slabs * C
                lane_p, q_p = lane, q_idx
                if Ppad > P_cap:
                    lane_p = jnp.concatenate(
                        [lane, jnp.zeros(Ppad - P_cap, jnp.int32)])
                    q_p = jnp.concatenate(
                        [q_idx, jnp.zeros(Ppad - P_cap, jnp.int32)])

                def slab(i, out):
                    st = i * C
                    ln_s = jax.lax.dynamic_slice(lane_p, (st,), (C,))
                    q_s = jax.lax.dynamic_slice(q_p, (st,), (C,))
                    rows = vecs_l[jnp.minimum(ln_s, B_loc - 1)]
                    if scan_float:
                        dots_p = jnp.einsum(
                            "cd,cdn->cn", xq[q_s], rows,
                            preferred_element_type=jnp.float32,
                            precision=HIGHEST)
                        y2_p = jnp.sum(rows * rows, axis=1)
                        d2_p = y2_p - 2.0 * dots_p
                    else:  # LUT gather-sum over the pair's code bytes
                        lut_p = luts[q_s]                     # [C, M, ksub]
                        d2_p = jnp.sum(jnp.take_along_axis(
                            lut_p, rows.astype(jnp.int32), axis=2), axis=1)
                    ok = (jnp.arange(n_pad, dtype=jnp.int32)[None, :]
                          < lengths_l[jnp.minimum(ln_s, B_loc - 1)][:, None])
                    d2_p = jnp.where(ok, d2_p, jnp.inf)
                    nk, oi = jax.lax.top_k(-d2_p, k_p)
                    return (jax.lax.dynamic_update_slice(out[0], nk, (st, 0)),
                            jax.lax.dynamic_update_slice(out[1], oi, (st, 0)))

                negp, offp = jax.lax.fori_loop(
                    0, n_slabs, slab,
                    (jnp.full((Ppad, k_p), -jnp.inf, jnp.float32),
                     jnp.zeros((Ppad, k_p), jnp.int32)))
                negp, offp = negp[:P_cap], offp[:P_cap]
                labp = (((base + lane.astype(jnp.int64))[:, None] << 32)
                        | offp.astype(jnp.int64))
                okl = valid_pair[:, None] & jnp.isfinite(-negp)
                labp = jnp.where(okl, labp, jnp.int64(-1))
                negp = jnp.where(okl, negp, -jnp.inf)
                # scatter pair shortlists to their (query, probe) slot —
                # unique per pair — then local top-k across the probes
                q_tgt = jnp.where(valid_pair, q_idx, nq)  # nq = dropped
                cd = jnp.full((nq, nprobe, k_p), -jnp.inf, jnp.float32).at[
                    q_tgt, p_idx].set(negp, mode="drop")
                cl = jnp.full((nq, nprobe, k_p), -1, jnp.int64).at[
                    q_tgt, p_idx].set(labp, mode="drop")
                kk = min(k, nprobe * k_p)
                neg, pos = jax.lax.top_k(cd.reshape(nq, nprobe * k_p), kk)
                lab = jnp.take_along_axis(
                    cl.reshape(nq, nprobe * k_p), pos, axis=1)
                if kk < k:
                    neg = jnp.pad(neg, ((0, 0), (0, k - kk)),
                                  constant_values=-jnp.inf)
                    lab = jnp.pad(lab, ((0, 0), (0, k - kk)),
                                  constant_values=-1)
                lab = jnp.where(jnp.isfinite(-neg), lab, jnp.int64(-1))
            else:
                probed = jnp.zeros((nq, B_loc), bool).at[
                    jnp.arange(nq)[:, None],
                    jnp.where(in_range, lp, B_loc).astype(jnp.int32),
                ].set(True, mode="drop")
                if scan_float:
                    # vecs_l is channel-major [B_loc, d, n_pad]
                    dots2 = jnp.einsum("qd,bdn->qbn", xq, vecs_l,
                                       preferred_element_type=jnp.float32,
                                       precision=HIGHEST)
                    y2 = jnp.sum(vecs_l * vecs_l, axis=1)  # [B_loc, n_pad]
                    d2 = y2[None] - 2.0 * dots2            # [nq, B_loc, n_pad]
                else:
                    # LUT sum per subspace: [nq, ksub] x idx[B_loc, n_pad]
                    d2 = jnp.zeros((nq, B_loc, n_pad), jnp.float32)
                    for m in range(pq_m):
                        d2 = d2 + jnp.take(
                            luts[:, m], vecs_l[:, m].astype(jnp.int32),
                            axis=1)
                slot_ok = (jnp.arange(n_pad, dtype=jnp.int32)[None, :]
                           < lengths_l[:, None])
                d2 = jnp.where(probed[:, :, None] & slot_ok[None], d2,
                               jnp.inf)
                flat_d = d2.reshape(nq, B_loc * n_pad)
                kk = min(k, B_loc * n_pad)
                neg, pos = jax.lax.top_k(-flat_d, kk)
                if kk < k:
                    neg = jnp.pad(neg, ((0, 0), (0, k - kk)),
                                  constant_values=-jnp.inf)
                    pos = jnp.pad(pos, ((0, 0), (0, k - kk)))
                b_idx = (pos // n_pad).astype(jnp.int64)
                off = (pos % n_pad).astype(jnp.int64)
                lab = ((base + b_idx) << 32) | off
                lab = jnp.where(jnp.isfinite(-neg), lab, jnp.int64(-1))

            if ablate_stage == "scan":  # phase profiling: stop pre-merge
                # shard-local shortlists returned as-is (outputs unused —
                # the bench only times; check_vma=False tolerates it)
                return neg[:, :k], lab[:, :k]

            # ---- merge: replicated global top-k --------------------------
            g_d = jnp.moveaxis(jax.lax.all_gather(-neg, "lists"), 0, 1
                               ).reshape(nq, Ng * k)
            g_l = jnp.moveaxis(jax.lax.all_gather(lab, "lists"), 0, 1
                               ).reshape(nq, Ng * k)
            key_l = jnp.where(g_l < 0, jnp.int64(2**62), g_l)
            order = jnp.lexsort((key_l, g_d), axis=1)[:, :k]
            D = jnp.take_along_axis(g_d, order, axis=1)
            L = jnp.take_along_axis(g_l, order, axis=1)       # [nq, k]

            # ---- translate: each shard resolves the labels it owns -------
            if ablate_translate:  # profiling hook: positional labels as I
                if scan_float:
                    D = D + jnp.sum(xq * xq, axis=1, keepdims=True)
                return jnp.where(L >= 0, D, jnp.inf), L
            lns = L >> 32
            offs = (L & _OFF_MASK).astype(jnp.int32)
            lloc = lns - base
            mine = (L >= 0) & (lloc >= 0) & (lloc < B_loc)
            lane = jnp.where(mine, lloc, 0).astype(jnp.int32)
            if mode == "roc_pl":
                # one kernel call decodes EVERY local lane (cheaper at scale
                # than touched-lane bookkeeping); the err flag was validated
                # at construction. Lanes ride length-sorted and the kernel
                # emits in decode-iteration order: element j of a lane is
                # at emit row length-1-j.
                from ..ops.roc_pallas import run_kernel

                buf_l, head_l, ptr_l, lens_l, prec_l, inv_l = trans
                emit, _ = run_kernel(buf_l, head_l, ptr_l, lens_l, prec_l,
                                     n_max=pl_nmax, interpret=pl_interp)
                slane = inv_l[lane]
                pos = jnp.clip(lens_l[0, slane] - 1 - offs, 0, pl_nmax - 1)
                vals = emit[0, pos, slane]
                found = mine
            elif mode in ("roc", "raw"):
                # grouped: gather the touched lanes into a static T_cap
                # buffer, full-list decode (ROC) or table lookup (raw)
                touched = jnp.zeros(B_loc, bool).at[
                    jnp.where(mine, lloc, B_loc).astype(jnp.int32)
                ].set(True, mode="drop")
                rows = jnp.nonzero(touched, size=T_cap, fill_value=B_loc)[0]
                row_valid = rows < B_loc
                rsafe = jnp.minimum(rows, B_loc - 1).astype(jnp.int32)
                rlen = jnp.where(row_valid, lengths_l[rsafe], 0
                                 ).astype(jnp.int32)
                if mode == "roc":
                    states, prec = trans
                    sub = jax.tree_util.tree_map(lambda a: a[rsafe], states)
                    dec, _ = rd.roc_decode_batch(sub, rlen, prec[rsafe],
                                                 pool, n_pad, n_slices)
                else:
                    (ids_l,) = trans
                    dec = ids_l[rsafe]
                # local-list -> touched-row inverse map
                row_of = jnp.full(B_loc + 1, T_cap, jnp.int32).at[
                    jnp.where(row_valid, rsafe, B_loc)
                ].set(jnp.arange(T_cap, dtype=jnp.int32), mode="drop")
                r = row_of[lane]
                found = mine & (r < T_cap)
                dec_pad = jnp.concatenate(
                    [dec, jnp.zeros((1, n_pad), dec.dtype)], axis=0)
                vals = dec_pad[jnp.where(found, r, T_cap), offs]
            elif mode == "packed":
                # O(1) random access on lane-sharded packed words
                (words_l,) = trans
                start = offs.astype(jnp.int64) * pb_width
                w0 = (start >> 5).astype(jnp.int32)
                sh_b = (start & 31).astype(jnp.uint64)
                Wp = words_l.shape[1]
                lo = words_l[lane, jnp.minimum(w0, Wp - 1)].astype(jnp.uint64)
                hi = words_l[lane, jnp.minimum(w0 + 1, Wp - 1)
                             ].astype(jnp.uint64)
                vals = ((lo | (hi << jnp.uint64(32))) >> sh_b) & jnp.uint64(
                    (1 << pb_width) - 1)
                found = mine
            elif mode == "ef":
                hw, hsb, hnb, lw, el, em = trans
                ef_l = EliasFanoBatch(
                    high=_BVB(hw, hsb, hnb), low_words=lw, l=el, m=em)
                vals = ef_select(ef_l, lane, offs)
                found = mine
            else:  # wt / wt1: replicated global tree, select per label
                sym = jnp.where(mine, lns, 0)
                if mode == "wt":
                    words_w, sbp_w, tab_w = trans
                    wt = WaveletTree(words_w, sbp_w, *wt_static)
                    vals = wt_select(wt, sym, offs, tables=tab_w)
                else:
                    cls_w, ow_w, sos_w, sbr_w, tab_w = trans
                    rrr = RRRPlanes(cls_w, ow_w, sos_w, sbr_w, *wt_static)
                    vals = wt_select_rrr(rrr, sym, offs, tables=tab_w)
                found = mine
            part = jnp.where(found, vals.astype(jnp.int64), 0)
            I = jax.lax.psum(part, "lists")
            I = jnp.where(L >= 0, I, jnp.int64(-1))

            if scan_float:
                # flat/qinco distances omit the query norm; LUT distances
                # are already the complete squared L2
                x2 = jnp.sum(xq * xq, axis=1, keepdims=True)
                D = D + x2
            D = jnp.where(L >= 0, D, jnp.inf)
            return D, I

        if mode == "roc_pl":
            trans_specs = (P(None, "lists"), P("lists"), P("lists"),
                           P(None, "lists"), P(None, "lists"), P("lists"))
            trans_args = self._kernel[0]
        elif mode == "roc":
            trans_specs = (rd.RocStates(*(P("lists"),) * 5), P("lists"))
            trans_args = (self._states, self._prec)
        elif mode == "packed":
            trans_specs = (P("lists"),)
            trans_args = (self._pb_words,)
        elif mode == "ef":
            trans_specs = (P("lists"),) * 6
            trans_args = self._ef_arrays
        elif mode in ("wt", "wt1"):
            trans_specs = (P(),) * len(self._wt_arrays)
            trans_args = self._wt_arrays
        else:
            trans_specs = (P("lists"),)
            trans_args = (self._ids,)
        if not scan_float:
            trans_specs = (P(), *trans_specs)
            trans_args = (self._pq_cents, *trans_args)

        fn = shard_map(
            local, mesh=self.mesh,
            in_specs=(P(), P("lists"), P("lists"), P("lists"), *trans_specs),
            out_specs=(P(), P()),
            check_vma=False,  # replicated outputs are identical by
            #                   construction (post-all_gather compute)
        )
        # the tables ride as ARGUMENTS, not closure constants: closed-over
        # arrays are baked into the program (huge compile payloads, and
        # every compile re-embeds the index)
        jitted = jax.jit(fn)
        args = (self._cents, self._vecs, self._lengths, *trans_args)
        return lambda xq: jitted(xq, *args)


def _ef_in_list_order(c: EliasFanoInvertedLists, lo: int, hi: int, put):
    """Flatten bucketized EF batches into one global-list-order batch of
    lane-sharded plain arrays (hw, hsb, hnb, low, l, m), building only rows
    [lo, hi) and assembling globals via ``put``. Word widths are global
    maxima over ALL buckets so every process pads identically."""
    HW = max(int(np.asarray(ef.high.words).shape[1]) for ef in c._efs)
    LW = max(int(np.asarray(ef.low_words).shape[1]) for ef in c._efs)
    R = hi - lo
    high = np.zeros((R, HW), np.uint32)
    nbits = np.zeros(R, np.int32)
    low = np.zeros((R, LW), np.uint32)
    l = np.zeros(R, np.int32)
    m = np.zeros(R, np.int32)
    for ln in range(lo, min(hi, c.nlist)):
        if ln not in c._list_to_bucket:
            continue  # empty list: m=0 lanes are never select()ed
        bi, lane = c._list_to_bucket[ln]
        ef = c._efs[bi]
        hw = np.asarray(ef.high.words)[lane]
        lw = np.asarray(ef.low_words)[lane]
        r = ln - lo
        high[r, : len(hw)] = hw
        low[r, : len(lw)] = lw
        nbits[r] = int(np.asarray(ef.high.nbits)[lane])
        l[r] = int(np.asarray(ef.l)[lane])
        m[r] = int(np.asarray(ef.m)[lane])
    # select directory built over LOCAL rows (process-local compute); its
    # width is a pure function of HW, identical on every process
    bvb = build_bitvector_batch(jnp.asarray(high), jnp.asarray(nbits))
    return (
        put(np.asarray(bvb.words), P("lists", None)),
        put(np.asarray(bvb.sb_prefix), P("lists", None)),
        put(np.asarray(bvb.nbits), P("lists")),
        put(low, P("lists", None)),
        put(l, P("lists")),
        put(m, P("lists")),
    )


def _roc_states_in_list_order(c: RocInvertedLists, lo: int, hi: int):
    """Flatten a RocInvertedLists' bucketized states into global-list-order
    RocStates rows [lo, hi) (stacks padded to the max bucket capacity —
    a global maximum, so every process pads identically)."""
    cap = max(int(np.asarray(st.stack).shape[1]) for st in c._states)
    R = hi - lo
    head = np.full(R, rd.RANS_L, np.uint64)
    stack = np.zeros((R, cap), np.uint32)
    stack_len = np.zeros(R, np.int32)
    mt_ctr = np.zeros(R, np.int32)
    prec = np.ones(R, np.int32)
    for bi, bucket in enumerate(c._buckets):
        st = jax.tree_util.tree_map(np.asarray, c._states[bi])
        pr = np.asarray(c._precisions[bi])
        for lane, ln in enumerate(bucket.list_ids):
            ln = int(ln)
            if not (lo <= ln < hi):
                continue
            r = ln - lo
            head[r] = st.head[lane]
            w = st.stack.shape[1]
            stack[r, :w] = st.stack[lane]
            stack_len[r] = st.stack_len[lane]
            mt_ctr[r] = st.mt_ctr[lane]
            prec[r] = pr[lane]
    states = rd.RocStates(
        head=head, stack=stack, stack_len=stack_len, mt_ctr=mt_ctr,
        err=np.zeros(R, bool),
    )
    return states, prec

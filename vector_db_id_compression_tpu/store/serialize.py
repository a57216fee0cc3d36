"""On-disk artifact format for compressed indexes.

The reference has NO serialization for its compressed structures — they are
rebuilt from the Faiss index on every run (search_ivf_qinco.py:502-524;
SURVEY.md §5 flags this as the gap to fix). This module defines a durable
artifact: one ``.npz`` per container holding the codec state arrays exactly
as the device layout uses them (ANS heads/stacks + lengths + precisions, EF
packed words + parameters, packed-bits words, wavelet-tree bit planes), plus
payload codes. Loading reconstructs a fully functional container without the
original uncompressed index.

Determinism contract: arrays are written in list order, so artifacts are
byte-stable across runs and across device counts (parallel.mesh gathers in
lane order).
"""

from __future__ import annotations

from pathlib import Path
from typing import Union

import jax.numpy as jnp
import numpy as np

from ..codecs import roc_device as rd
from ..codecs.elias_fano import EliasFanoBatch
from ..codecs.packed_bits import PackedBitsBatch
from ..codecs.wavelet_tree import WaveletTree
from ..core.bits import build_bitvector_batch
from .graph import (CompactBitGraph, EliasFanoGraph, Graph, RocBlockGraph,
                    RocGraph)
from .invlists import (
    CompressedInvertedLists,
    EliasFanoInvertedLists,
    InterleavedRocInvertedLists,
    PackedBitsInvertedLists,
    RocInvertedLists,
    WaveletTreeInvertedLists,
)
from .ragged import Bucket

MAGIC = "vdbidc-v1"

_KIND = {
    RocInvertedLists: "roc",
    EliasFanoInvertedLists: "elias_fano",
    PackedBitsInvertedLists: "packed_bits",
    WaveletTreeInvertedLists: "wavelet_tree",
    InterleavedRocInvertedLists: "roc_interleaved",
}
_BY_KIND = {v: k for k, v in _KIND.items()}


def _codes_to_flat(codes_all):
    offsets = np.zeros(len(codes_all) + 1, dtype=np.int64)
    for i, c in enumerate(codes_all):
        offsets[i + 1] = offsets[i] + len(c)
    flat = (
        np.concatenate([c for c in codes_all])
        if offsets[-1] > 0 else np.empty(0, np.uint8)
    )
    return flat, offsets


def _codes_from_flat(flat, offsets):
    return [flat[offsets[i]: offsets[i + 1]].copy() for i in range(len(offsets) - 1)]


def save_invlists(path: Union[str, Path], c: CompressedInvertedLists) -> None:
    kind = _KIND[type(c)]
    codes_flat, codes_offsets = _codes_to_flat(c.codes_all)
    arrs = {
        "lengths": c._lengths,
        "codes_flat": codes_flat,
        "codes_offsets": codes_offsets,
        "sizes": np.array(
            [c.compressed_ids_size_in_bytes, c.overhead_in_bytes, c.nlist,
             c.code_size], dtype=np.int64,
        ),
    }
    meta = dict(magic=MAGIC, kind=kind)

    if kind in ("roc", "roc_interleaved"):
        if kind == "roc_interleaved":
            # entries are created list-major (chunks consecutive per list),
            # so per-list entry counts reconstruct _entries_of
            arrs["ent_counts"] = np.array(
                [len(c._entries_of[ln]) for ln in range(c.nlist)], np.int64)
            arrs["ent_lo"] = c._ent_lo
            arrs["ent_len"] = c._ent_len
            # -1 encodes the "auto" per-list chunk policy
            arrs["interleave"] = np.array(
                [-1 if c.interleave == "auto" else c.interleave], np.int64)
        arrs["id_symbol_precision"] = c.id_symbol_precision
        for bi, (bucket, st, prec) in enumerate(
            zip(c._buckets, c._states, c._precisions)
        ):
            arrs[f"b{bi}_list_ids"] = bucket.list_ids
            arrs[f"b{bi}_lengths"] = bucket.lengths
            arrs[f"b{bi}_npad"] = np.array([bucket.n_pad])
            arrs[f"b{bi}_head"] = np.asarray(st.head)
            arrs[f"b{bi}_stack"] = np.asarray(st.stack)
            arrs[f"b{bi}_stack_len"] = np.asarray(st.stack_len)
            arrs[f"b{bi}_mt_ctr"] = np.asarray(st.mt_ctr)
            arrs[f"b{bi}_prec"] = np.asarray(prec)
        meta["n_buckets"] = len(c._buckets)
    elif kind == "elias_fano":
        for bi, (bucket, ef) in enumerate(zip(c._buckets, c._efs)):
            arrs[f"b{bi}_list_ids"] = bucket.list_ids
            arrs[f"b{bi}_lengths"] = bucket.lengths
            arrs[f"b{bi}_npad"] = np.array([bucket.n_pad])
            arrs[f"b{bi}_high"] = np.asarray(ef.high.words)
            arrs[f"b{bi}_nbits"] = np.asarray(ef.high.nbits)
            arrs[f"b{bi}_low"] = np.asarray(ef.low_words)
            arrs[f"b{bi}_l"] = np.asarray(ef.l)
            arrs[f"b{bi}_m"] = np.asarray(ef.m)
        meta["n_buckets"] = len(c._buckets)
    elif kind == "packed_bits":
        arrs["bits"] = np.array([c.bits])
        for bi, (bucket, pb) in enumerate(zip(c._buckets, c._packed)):
            arrs[f"b{bi}_list_ids"] = bucket.list_ids
            arrs[f"b{bi}_lengths"] = bucket.lengths
            arrs[f"b{bi}_npad"] = np.array([bucket.n_pad])
            arrs[f"b{bi}_words"] = np.asarray(pb.words)
        meta["n_buckets"] = len(c._buckets)
    elif kind == "wavelet_tree":
        if c.wt_type == 0:
            arrs["wt_words"] = np.asarray(c.wt.words)
        else:  # RRR(63)-compressed planes (codecs/rrr.py)
            arrs["rrr_classes"] = np.asarray(c.wt.classes)
            arrs["rrr_off_words"] = np.asarray(c.wt.off_words)
            arrs["rrr_sb_off_start"] = np.asarray(c.wt.sb_off_start)
            arrs["rrr_sb_rank"] = np.asarray(c.wt.sb_rank)
        arrs["wt_meta"] = np.array([c.wt.n, c.wt.levels, c.wt_type])

    np.savez(path, **arrs, **{f"meta_{k}": np.array(str(v)) for k, v in meta.items()})


def load_invlists(path: Union[str, Path]) -> CompressedInvertedLists:
    z = np.load(path, allow_pickle=False)
    assert str(z["meta_magic"]) == MAGIC, "bad artifact magic"
    kind = str(z["meta_kind"])
    cls = _BY_KIND[kind]
    c = cls.__new__(cls)
    sizes = z["sizes"]
    c.compressed_ids_size_in_bytes = int(sizes[0])
    c.overhead_in_bytes = int(sizes[1])
    c.nlist = int(sizes[2])
    c.code_size = int(sizes[3])
    c._lengths = z["lengths"]
    c.codes_all = _codes_from_flat(z["codes_flat"], z["codes_offsets"])

    def load_buckets():
        n_buckets = int(str(z["meta_n_buckets"]))
        buckets, l2b = [], {}
        for bi in range(n_buckets):
            b = Bucket(
                list_ids=z[f"b{bi}_list_ids"],
                lengths=z[f"b{bi}_lengths"],
                n_pad=int(z[f"b{bi}_npad"][0]),
            )
            buckets.append(b)
            for lane, ln in enumerate(b.list_ids):
                l2b[int(ln)] = (bi, lane)
        return buckets, l2b

    if kind in ("roc", "roc_interleaved"):
        c.id_symbol_precision = z["id_symbol_precision"]
        buckets, l2b = load_buckets()
        c._buckets = buckets
        c._kernels = {}
        if kind == "roc":
            c._list_to_bucket = l2b
        else:
            c._ent_to_bucket = l2b
            c._ent_lo = z["ent_lo"]
            c._ent_len = z["ent_len"]
            iv = int(z["interleave"][0])
            c.interleave = "auto" if iv == -1 else iv
            bounds = np.zeros(c.nlist + 1, dtype=np.int64)
            np.cumsum(z["ent_counts"], out=bounds[1:])
            c._entries_of = {
                ln: list(range(int(bounds[ln]), int(bounds[ln + 1])))
                for ln in range(c.nlist)
            }
        c._states, c._precisions = [], []
        for bi in range(len(c._buckets)):
            c._states.append(
                rd.RocStates(
                    head=jnp.asarray(z[f"b{bi}_head"]),
                    stack=jnp.asarray(z[f"b{bi}_stack"]),
                    stack_len=jnp.asarray(z[f"b{bi}_stack_len"]),
                    mt_ctr=jnp.asarray(z[f"b{bi}_mt_ctr"]),
                    err=jnp.zeros(len(z[f"b{bi}_head"]), dtype=bool),
                )
            )
            c._precisions.append(jnp.asarray(z[f"b{bi}_prec"]))
    elif kind == "elias_fano":
        c._buckets, c._list_to_bucket = load_buckets()
        c._efs = []
        for bi in range(len(c._buckets)):
            c._efs.append(
                EliasFanoBatch(
                    high=build_bitvector_batch(
                        jnp.asarray(z[f"b{bi}_high"]), jnp.asarray(z[f"b{bi}_nbits"])
                    ),
                    low_words=jnp.asarray(z[f"b{bi}_low"]),
                    l=jnp.asarray(z[f"b{bi}_l"]),
                    m=jnp.asarray(z[f"b{bi}_m"]),
                )
            )
    elif kind == "packed_bits":
        c.bits = int(z["bits"][0])
        c._buckets, c._list_to_bucket = load_buckets()
        c._packed = []
        for bi, b in enumerate(c._buckets):
            c._packed.append(
                PackedBitsBatch(
                    words=jnp.asarray(z[f"b{bi}_words"]),
                    lengths=jnp.asarray(b.lengths),
                    width=c.bits,
                )
            )
    elif kind == "wavelet_tree":
        n, levels, wt_type = (int(v) for v in z["wt_meta"])
        c.wt_type = wt_type
        if wt_type == 0:
            from ..codecs.wavelet_tree import wt_index_from_words

            words = z["wt_words"].astype(np.uint32)
            c.wt = WaveletTree(
                jnp.asarray(words), jnp.asarray(wt_index_from_words(words)),
                n, levels,
            )
        else:
            from ..codecs.rrr import RRRPlanes

            c.wt = RRRPlanes(
                classes=jnp.asarray(z["rrr_classes"]),
                off_words=jnp.asarray(z["rrr_off_words"]),
                sb_off_start=jnp.asarray(z["rrr_sb_off_start"]),
                sb_rank=jnp.asarray(z["rrr_sb_rank"]),
                n=n, levels=levels,
            )
    return c


# ---------------------------------------------------------------------------
# Graph containers (reference builds these transiently too — same gap fixed)
# ---------------------------------------------------------------------------

_GRAPH_KIND = {
    Graph: "raw",
    CompactBitGraph: "compact",
    EliasFanoGraph: "elias_fano",
    RocGraph: "roc",
    RocBlockGraph: "roc_block",
}
_GRAPH_BY_KIND = {v: k for k, v in _GRAPH_KIND.items()}


def save_graph(path: Union[str, Path], g) -> None:
    """Durable artifact for an adjacency container (any of Graph /
    CompactBitGraph / EliasFanoGraph / RocGraph)."""
    kind = _GRAPH_KIND[type(g)]
    arrs = {
        "degrees": np.asarray(g.degrees),
        "shape": np.array([g.N, g.K], dtype=np.int64),
        "sizes": np.array(
            [getattr(g, "compressed_ids_size_in_bytes", 0),
             getattr(g, "overhead_in_bytes", 0)], dtype=np.int64,
        ),
    }
    meta = dict(magic=MAGIC, kind=kind)
    if kind == "raw":
        arrs["adjacency"] = g.adjacency
    elif kind == "compact":
        arrs["bits"] = np.array([g.bits, g.stride], dtype=np.int64)
        arrs["words"] = np.asarray(g._words)
    elif kind == "elias_fano":
        arrs["high_words"] = np.asarray(g._ef.high.words)
        arrs["high_nbits"] = np.asarray(g._ef.high.nbits)
        arrs["low_words"] = np.asarray(g._ef.low_words)
        arrs["l"] = np.asarray(g._ef.l)
        arrs["m"] = np.asarray(g._ef.m)
    elif kind == "roc":
        st = g._states
        arrs["head"] = np.asarray(st.head)
        arrs["stack"] = np.asarray(st.stack)
        arrs["stack_len"] = np.asarray(st.stack_len)
        arrs["mt_ctr"] = np.asarray(st.mt_ctr)
        arrs["prec"] = np.asarray(g._prec_dev)
        arrs["id_symbol_precision"] = np.asarray(g.id_symbol_precision)
    elif kind == "roc_block":
        st = g._states
        arrs["head"] = np.asarray(st.head)
        arrs["stack"] = np.asarray(st.stack)
        arrs["stack_len"] = np.asarray(st.stack_len)
        arrs["mt_ctr"] = np.asarray(st.mt_ctr)
        arrs["prec"] = np.asarray(g._prec)
        arrs["degs"] = np.asarray(g._degs)
        arrs["block"] = np.array([g.block], dtype=np.int64)
    np.savez(path, **arrs, **{f"meta_{k}": np.array(str(v)) for k, v in meta.items()})


def load_graph(path: Union[str, Path]):
    z = np.load(path, allow_pickle=False)
    assert str(z["meta_magic"]) == MAGIC, "bad artifact magic"
    kind = str(z["meta_kind"])
    cls = _GRAPH_BY_KIND[kind]
    if kind == "raw":
        return Graph(z["adjacency"])
    g = cls.__new__(cls)
    g.N, g.K = (int(v) for v in z["shape"])
    g.degrees = z["degrees"]
    g.compressed_ids_size_in_bytes = int(z["sizes"][0])
    g.overhead_in_bytes = int(z["sizes"][1])
    if kind == "compact":
        g.bits, g.stride = (int(v) for v in z["bits"])
        g._words = jnp.asarray(z["words"])
    elif kind == "elias_fano":
        from ..codecs.elias_fano import EliasFanoBatch

        g._ef = EliasFanoBatch(
            high=build_bitvector_batch(
                jnp.asarray(z["high_words"]), jnp.asarray(z["high_nbits"])
            ),
            low_words=jnp.asarray(z["low_words"]),
            l=jnp.asarray(z["l"]),
            m=jnp.asarray(z["m"]),
        )
    elif kind == "roc":
        g._states = rd.RocStates(
            head=jnp.asarray(z["head"]),
            stack=jnp.asarray(z["stack"]),
            stack_len=jnp.asarray(z["stack_len"]),
            mt_ctr=jnp.asarray(z["mt_ctr"]),
            err=jnp.zeros(g.N, dtype=bool),
        )
        g._prec_dev = jnp.asarray(z["prec"])
        g.id_symbol_precision = z["id_symbol_precision"]
        g.num_outgoing_edges = g.degrees
        g._n_slices = rd.n_slices_for(int(z["prec"].max(initial=1)))
    elif kind == "roc_block":
        g.block = int(z["block"][0])
        g._n_blocks = -(-g.N // g.block)
        g._states = rd.RocStates(
            head=jnp.asarray(z["head"]),
            stack=jnp.asarray(z["stack"]),
            stack_len=jnp.asarray(z["stack_len"]),
            mt_ctr=jnp.asarray(z["mt_ctr"]),
            err=jnp.zeros(g._n_blocks, dtype=bool),
        )
        g._prec = jnp.asarray(z["prec"])
        g._degs = jnp.asarray(z["degs"])
        g.num_outgoing_edges = g.degrees
        g._n_slices = rd.n_slices_for(int(z["prec"].max(initial=1)))
    return g


# ---------------------------------------------------------------------------
# HNSW index (all layers + metadata)
# ---------------------------------------------------------------------------


def save_hnsw(path: Union[str, Path], h) -> None:
    """Durable artifact for a search.hnsw.HNSW index (adjacency layers,
    level assignment, entry point; vectors are the caller's to store)."""
    arrs = {
        "levels": np.asarray(h.levels),
        "meta": np.array([h.M, h.Mmax0, h.entry, h.max_level,
                          int(h.ef_construction), h.seed], dtype=np.int64),
    }
    for l, layer in enumerate(h.layers):
        arrs[f"layer{l}"] = layer
    np.savez(path, **arrs,
             **{"meta_magic": np.array(MAGIC), "meta_kind": np.array("hnsw")})


def load_hnsw(path: Union[str, Path], xb: np.ndarray):
    """Reconstruct an HNSW over the caller-provided database vectors."""
    from ..search.hnsw import HNSW

    z = np.load(path, allow_pickle=False)
    assert str(z["meta_magic"]) == MAGIC and str(z["meta_kind"]) == "hnsw"
    M, Mmax0, entry, max_level, efc, seed = (int(v) for v in z["meta"])
    h = HNSW(M=M, ef_construction=efc, seed=seed)
    h.levels = z["levels"]
    h.entry = entry
    h.max_level = max_level
    h.layers = [z[f"layer{l}"].copy() for l in range(max_level + 1)]
    h._xb = np.asarray(xb, np.float32)
    return h

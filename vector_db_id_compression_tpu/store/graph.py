"""Graph (NSG-style) adjacency containers with compressed neighbor lists.

API parity with the reference's graph hierarchy (alt-graph-index/altid_impl.h):
  Graph              — dense int32[N, K] adjacency, -1 terminated (the data
                       model of faiss::nsg::Graph<int32_t>)
  CompactBitGraph    — C14: fixed-width edges, terminator value N
                       (altid_impl.cpp:20-51)
  EliasFanoGraph     — C15: per-node sorted + EF (altid_impl.cpp:53-101);
                       sorts neighbor lists (order change is search-neutral)
  RocGraph           — C16: per-node ROC/bits-back (altid_impl.cpp:103-165)

The hot operation is ``get_neighbors_batch(nodes)`` — the whole query
frontier's adjacency decoded as ONE lanes-in-lockstep device program, which is
what the batched graph traversal (search.nsg) calls each expansion step. The
reference instead decodes one node per ``get_neighbors`` call inside the
traversal loop (altid_impl.cpp:153-165); batching the frontier is the
device-side answer to that latency-critical integration point.

Size accounting matches the reference formulas:
  compact:  N * stride bytes, stride = (K*bits+7)/8, bits from
            `while((1 << bits) < N+1)`
  EF:       sum(high+low bits)/8, overhead 2*N*ceil(log2 N)/8 (degrees+max_id)
  ROC:      sum(8 + 4*stack_len), overhead N*ceil(log2 N)/8 (degrees)
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..codecs import roc_device as rd
from ..codecs.elias_fano import (
    EliasFanoBatch,
    batch_ef_lists,
    ef_decode_all,
    ef_encode_list,
)
from ..codecs.packed_bits import packed_width
from ..codecs.roc import precision_for_max_id_safe
from ..core.bits import get_fixed_fields, np_pack_fixed


class Graph:
    """Dense adjacency: int32[N, K], rows -1-terminated."""

    def __init__(self, adjacency: np.ndarray):
        adj = np.asarray(adjacency, dtype=np.int32)
        self.N, self.K = adj.shape
        self.adjacency = adj
        self.degrees = (adj >= 0).sum(axis=1).astype(np.int32)
        self._dev = jnp.asarray(adj)

    def get_neighbors(self, i: int) -> np.ndarray:
        row = self.adjacency[i]
        return row[row >= 0]

    def get_neighbors_batch(self, nodes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(neighbors i32[Q, K] padded with -1, counts i32[Q])."""
        rows = np.asarray(self._dev[jnp.asarray(nodes, jnp.int32)])
        return rows, self.degrees[nodes]


class CompressedGraph:
    """Base for compressed adjacency containers."""

    def __init__(self, graph: Graph):
        self.N, self.K = graph.N, graph.K
        self.degrees = graph.degrees.copy()
        self.compressed_ids_size_in_bytes = 0
        self.overhead_in_bytes = 0

    def get_neighbors(self, i: int) -> np.ndarray:
        nb, cnt = self.get_neighbors_batch(np.array([i]))
        return nb[0, : cnt[0]]

    def get_neighbors_batch(self, nodes):
        raise NotImplementedError


class CompactBitGraph(CompressedGraph):
    """Fixed-width edges; per-node field count K with terminator N
    (altid_impl.cpp:20-51). We store exactly ceil(K*bits/32) words per node
    so the byte accounting matches the reference stride."""

    def __init__(self, graph: Graph):
        super().__init__(graph)
        self.bits = packed_width(self.N)  # while((1<<bits) < N+1)
        self.stride = (self.K * self.bits + 7) // 8
        W = max((self.K * self.bits + 31) // 32, 1)
        words = np.zeros((self.N, W), dtype=np.uint32)
        for i in range(self.N):
            row = graph.adjacency[i]
            deg = int(self.degrees[i])
            vals = np.zeros(self.K, dtype=np.uint64)
            vals[:deg] = row[:deg]
            if deg < self.K:
                vals[deg] = self.N  # terminator (altid_impl.cpp:31-33)
            words[i] = np_pack_fixed(vals, self.bits, total_bits=W * 32)
        self._words = jnp.asarray(words)
        self.compressed_ids_size_in_bytes = self.N * self.stride

    def get_neighbors_batch(self, nodes):
        nodes = np.asarray(nodes, dtype=np.int64)
        words = self._words[jnp.asarray(nodes)]
        idx = jnp.broadcast_to(
            jnp.arange(self.K, dtype=jnp.int32)[None, :], (len(nodes), self.K)
        )
        vals = np.asarray(get_fixed_fields(words, self.bits, idx)).astype(np.int64)
        counts = self.degrees[nodes]
        mask = np.arange(self.K)[None, :] < counts[:, None]
        return np.where(mask, vals, -1).astype(np.int32), counts


class EliasFanoGraph(CompressedGraph):
    def __init__(self, graph: Graph):
        super().__init__(graph)
        encoded = []
        total_bits = 0
        for i in range(self.N):
            nb = np.sort(graph.get_neighbors(i)).astype(np.uint64)
            e = ef_encode_list(nb)
            encoded.append(e)
            total_bits += e.size_in_bits
        self._ef = batch_ef_lists(encoded)
        self.compressed_ids_size_in_bytes = total_bits // 8
        logn = math.ceil(math.log2(self.N)) if self.N > 1 else 0
        # degrees + per-node max_id (altid_impl.cpp:56-57)
        self.overhead_in_bytes = int(2 * self.N * logn / 8)

    def get_neighbors_batch(self, nodes):
        nodes = np.asarray(nodes, dtype=np.int64)
        sub = EliasFanoBatch(
            high=jax.tree_util.tree_map(lambda a: a[jnp.asarray(nodes)], self._ef.high),
            low_words=self._ef.low_words[jnp.asarray(nodes)],
            l=self._ef.l[jnp.asarray(nodes)],
            m=self._ef.m[jnp.asarray(nodes)],
        )
        vals = np.asarray(ef_decode_all(sub, self.K)).astype(np.int64)
        counts = self.degrees[nodes]
        mask = np.arange(self.K)[None, :] < counts[:, None]
        return np.where(mask, vals, -1).astype(np.int32), counts


class RocGraph(CompressedGraph):
    """Per-node ROC states over the neighbor sets; decode reproduces the
    encode sampling order (altid_impl.cpp:103-165). All N nodes are one
    lane batch padded to K."""

    def __init__(self, graph: Graph):
        super().__init__(graph)
        sorted_nb = np.zeros((self.N, self.K), dtype=np.uint64)
        prec = np.zeros(self.N, dtype=np.int32)
        self.num_outgoing_edges = self.degrees
        for i in range(self.N):
            nb = graph.get_neighbors(i)
            if len(nb) == 0:
                continue
            s = np.sort(nb.astype(np.uint64))
            if len(s) > 1 and (s[1:] == s[:-1]).any():
                # ROC is lossless only for distinct symbols (codec.cpp:123-152
                # has the same constraint); fail loudly instead of silently
                # decoding corrupted neighbor ids
                raise ValueError(
                    f"duplicate neighbor ids in adjacency row {i}; "
                    "deduplicate the graph before ROC compression")
            sorted_nb[i, : len(s)] = s
            prec[i] = precision_for_max_id_safe(int(nb.max()))
        self.id_symbol_precision = prec.astype(np.int64)
        maxp = int(prec.max()) if self.N else 1
        self._n_slices = rd.n_slices_for(maxp)
        cap = rd.stack_capacity(self.K, maxp)
        # shared ragged front door (codecs/roc_device.py encode_ragged);
        # zero-degree lanes keep the fresh state; sampling order is
        # irrelevant for graphs (no payload codes to co-reorder)
        states, _ = rd.encode_ragged(
            [sorted_nb[i, : self.degrees[i]] for i in range(self.N)],
            prec, self.K, cap)
        self._states = states
        self._prec_dev = jnp.asarray(prec)
        sizes = np.asarray(states.size_bytes)
        self.compressed_ids_size_in_bytes = int(sizes.sum())
        logn = math.ceil(math.log2(self.N)) if self.N > 1 else 0
        self.overhead_in_bytes = int(self.N * logn / 8)  # degrees

    def get_neighbors_batch(self, nodes):
        nodes_j = jnp.asarray(np.asarray(nodes, dtype=np.int64))
        sub = jax.tree_util.tree_map(lambda a: a[nodes_j], self._states)
        lengths = jnp.asarray(self.degrees[np.asarray(nodes)])
        prec = self._prec_dev[nodes_j]
        pool = rd.default_pool(self.K)
        ids, _ = rd.roc_decode_batch(sub, lengths, prec, pool, self.K,
                                     self._n_slices)
        vals = np.asarray(ids).astype(np.int64)
        counts = self.degrees[np.asarray(nodes)]
        mask = np.arange(self.K)[None, :] < counts[:, None]
        return np.where(mask, vals, -1).astype(np.int32), counts


class RocBlockGraph(CompressedGraph):
    """Framework extension beyond C16: ONE ANS state per *block* of
    ``block`` consecutive nodes, chained through the state (slot ``block-1``
    pushed first so decode emits slot 0 first).

    The reference's per-node ROC (altid_impl.cpp:103-165) pays an 8-byte ANS
    head plus u32 stack rounding per node; at NSG degrees (~13-32 edges) that
    head alone costs 2-5 bits/edge and makes ROC the *largest* method in the
    dynamic graph bench. Chaining amortizes both across the block:
    head overhead drops to 64/(block*degree) bits/edge, and the multiset
    payload is unchanged (per-node precisions are preserved — the chain pops
    each slot with its own width). The trade is random access: fetching one
    node decodes its whole block (the decode is still one lanes-in-lockstep
    device program; ``search.graph_device`` runs it inside the traversal
    loop). ``block=1`` reproduces the per-node stream bit-for-bit.
    """

    def __init__(self, graph: Graph, block: int = 16):
        super().__init__(graph)
        if block < 1:
            raise ValueError(f"block must be >= 1, got {block}")
        self.block = int(block)
        L = -(-self.N // self.block)
        self._n_blocks = L
        sorted_nb = np.zeros((L, self.block, self.K), dtype=np.uint64)
        degs = np.zeros((L, self.block), dtype=np.int32)
        prec = np.ones((L, self.block), dtype=np.int32)
        self.num_outgoing_edges = self.degrees
        for i in range(self.N):
            nb = graph.get_neighbors(i)
            b, s = divmod(i, self.block)
            degs[b, s] = len(nb)
            if len(nb) == 0:
                continue
            srt = np.sort(nb.astype(np.uint64))
            if len(srt) > 1 and (srt[1:] == srt[:-1]).any():
                raise ValueError(
                    f"duplicate neighbor ids in adjacency row {i}; "
                    "deduplicate the graph before ROC compression")
            sorted_nb[b, s, : len(srt)] = srt
            prec[b, s] = precision_for_max_id_safe(int(nb.max()))
        maxp = int(prec.max())
        self._n_slices = rd.n_slices_for(maxp)
        cap = rd.stack_capacity(self.block * self.K, maxp)
        pool = rd.default_pool(self.block * self.K)
        states = rd.roc_encode_chained(
            jnp.asarray(sorted_nb), jnp.asarray(degs), jnp.asarray(prec),
            pool, rd.fresh_states(L, cap), self._n_slices)
        if bool(np.asarray(states.err).any()):
            raise RuntimeError("stack overflow / pool exhaustion in chained "
                               "ROC graph encode")
        self._states = states
        self._degs = jnp.asarray(degs)
        self._prec = jnp.asarray(prec)
        sizes = np.asarray(states.size_bytes)
        self.compressed_ids_size_in_bytes = int(sizes.sum())
        logn = math.ceil(math.log2(self.N)) if self.N > 1 else 0
        self.overhead_in_bytes = int(self.N * logn / 8)  # degrees

    def get_neighbors_batch(self, nodes):
        nodes = np.asarray(nodes)
        blk = nodes // self.block
        uniq, inv = np.unique(blk, return_inverse=True)
        sub = jax.tree_util.tree_map(
            lambda a: a[jnp.asarray(uniq)], self._states)
        pool = rd.default_pool(self.block * self.K)
        ids, _ = rd.roc_decode_chained(
            sub, self._degs[jnp.asarray(uniq)], self._prec[jnp.asarray(uniq)],
            pool, self.K, self._n_slices)
        vals = np.asarray(ids)[inv, nodes % self.block].astype(np.int64)
        counts = self.degrees[nodes]
        mask = np.arange(self.K)[None, :] < counts[:, None]
        return np.where(mask, vals, -1).astype(np.int32), counts

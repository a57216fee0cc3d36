"""HNSW graph build + search, batched for the device compute path.

Reference parity: the offline bench extracts HNSW level-0 links from a Faiss
``HNSW{M},Flat`` index (``graph_static_bench_invlists.py:33-50,88-95``) and
codes them with REC/zuckerli; the ID-compression containers apply to HNSW
adjacency exactly as to NSG. This module provides the HNSW family natively:

  - hierarchical layers with geometric level assignment (mL = 1/ln M),
  - **chunked parallel insertion**: points are inserted in batches; each
    batch greedy-descends the upper layers and ef-searches the lower layers
    *against the current graph*, with all candidate distances computed as
    one batched matmul on device (same kernel as search/nsg.py). Intra-batch
    edges are recovered by a symmetric pass at the end of each batch. This is
    the standard accelerator-friendly HNSW build (sequential per-point
    insertion would serialize a million host round-trips).
  - level-0 adjacency exposed as a plain [N, 2M] -1-padded array, drop-in
    for Graph/CompactBit/EliasFano/Roc containers (store/graph.py) and for
    :func:`get_level0_links` (parity with get_hnsw_links(...)[0]).

Search descends layer by layer (greedy, ef=1) then runs the shared
best-first pool search (search/nsg.py:search_graph) on layer 0.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np

from .nsg import _batch_dists, search_graph
from ..store.graph import Graph

import jax.numpy as jnp


def _dists(xq_dev, xb_dev, nodes: np.ndarray) -> np.ndarray:
    return np.asarray(_batch_dists(xq_dev, xb_dev, jnp.asarray(nodes)))


def _dists_host(xq: np.ndarray, xb: np.ndarray, nodes: np.ndarray
                ) -> np.ndarray:
    """Host (numpy) batched distances for BUILD-time candidate slabs.

    The build's best-first loops need one distance evaluation per
    expansion step, and a device round trip per step made graph builds
    sync-bound. The slabs are tiny ([B, K, d] ~ 1M elements), so
    numpy on host is orders of magnitude faster than the per-step sync.
    SEARCH keeps the fully-jitted device path (search/graph_device.py)."""
    y = xb[np.maximum(nodes, 0)]
    d = ((y - xq[:, None, :]) ** 2).sum(axis=-1, dtype=np.float32)
    return np.where(nodes >= 0, d, np.float32(np.inf))


class HNSW:
    def __init__(self, M: int = 16, ef_construction: int = 40,
                 seed: int = 1234):
        if M < 2:
            raise ValueError(f"HNSW needs M >= 2 (mL = 1/ln(M)); got M={M}")
        self.M = M
        self.Mmax0 = 2 * M
        self.mL = 1.0 / math.log(M)
        self.ef_construction = max(ef_construction, M)
        self.seed = seed
        self.levels: Optional[np.ndarray] = None     # level per point
        self.layers: List[np.ndarray] = []           # [N, cap] adjacency per level
        self.entry: int = 0
        self.max_level: int = -1
        self._xb: Optional[np.ndarray] = None

    # ------------------------------------------------------------------ build

    def build(self, xb: np.ndarray, batch: int = 512) -> "HNSW":
        xb = np.asarray(xb, np.float32)
        N = len(xb)
        self._xb = xb
        rng = np.random.default_rng(self.seed)
        self.levels = np.minimum(
            np.floor(-np.log(rng.random(N)) * self.mL).astype(np.int32), 31)
        self.max_level = int(self.levels.max())
        self.layers = [
            np.full((N, self.Mmax0 if l == 0 else self.M), -1, dtype=np.int32)
            for l in range(self.max_level + 1)
        ]
        self.entry = int(np.argmax(self.levels))

        xb_dev = jnp.asarray(xb)
        order = np.arange(N)
        # seed the graph with the entry point, then insert in chunks
        inserted = np.zeros(N, dtype=bool)
        inserted[self.entry] = True
        rest = order[order != self.entry]
        for s in range(0, len(rest), batch):
            pts = rest[s:s + batch]
            self._insert_batch(pts, xb_dev, inserted)
            inserted[pts] = True
            # symmetric pass: the first insertion couldn't see same-batch
            # points (they weren't `inserted` yet), so re-link the batch now
            # that they are — this recovers intra-batch edges and keeps
            # early batches from degenerating into a star around the entry
            self._insert_batch(pts, xb_dev, inserted, relink=True)
        return self

    def _greedy_descend(self, pts: np.ndarray, xb_dev, start: np.ndarray,
                        level: int, inserted: np.ndarray,
                        xq: np.ndarray = None) -> np.ndarray:
        """One greedy (ef=1) walk per point on `level`; batched distances.
        ``xq`` optionally supplies explicit query vectors (tests/oracles);
        default: the points being inserted."""
        cur = start.copy()
        if xq is None:
            xq = self._xb[pts]
        cur_d = _dists_host(xq, self._xb, cur[:, None])[:, 0]
        adj = self.layers[level]
        while True:
            nbrs = adj[cur]                               # [B, cap]
            valid = (nbrs >= 0) & inserted[np.maximum(nbrs, 0)]
            cand = np.where(valid, nbrs, 0)
            d = _dists_host(xq, self._xb, cand)
            d = np.where(valid, d, np.inf)
            best = np.argmin(d, axis=1)
            bd = d[np.arange(len(pts)), best]
            improve = bd < cur_d
            if not improve.any():
                return cur
            cur = np.where(improve, nbrs[np.arange(len(pts)), best], cur)
            cur_d = np.where(improve, bd, cur_d)

    # peak-host-memory cap for the per-call visited bitset (B x ceil(N/32)
    # u32): past this, _ef_search splits the batch — at 1M nodes an
    # unchunked 4k-point insert batch would allocate ~0.5 GB per layer call
    _VISITED_BUDGET_BYTES = 1 << 28

    def _ef_search(self, pts: np.ndarray, xb_dev, start: np.ndarray,
                   level: int, ef: int, inserted: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """Batched best-first pool search on one layer restricted to inserted
        nodes. Returns (ids [B, ef], dists [B, ef]) -1/inf padded."""
        B = len(pts)
        N = len(self._xb)
        words = (N + 31) // 32
        chunk = max(1, self._VISITED_BUDGET_BYTES // (4 * words))
        if B > chunk:
            parts = [
                self._ef_search(pts[i:i + chunk], xb_dev, start[i:i + chunk],
                                level, ef, inserted)
                for i in range(0, B, chunk)
            ]
            return (np.concatenate([p[0] for p in parts]),
                    np.concatenate([p[1] for p in parts]))
        xq = self._xb[pts]
        pool_ids = np.full((B, ef), -1, dtype=np.int64)
        pool_d = np.full((B, ef), np.inf, dtype=np.float32)
        pool_exp = np.zeros((B, ef), dtype=bool)
        # visited bitset per query row (the python-set bookkeeping was the
        # build bottleneck past ~50k nodes: B*K set probes per expansion)
        visited = np.zeros((B, (N + 31) // 32), dtype=np.uint32)
        rows = np.arange(B)
        visited[rows, start // 32] |= (
            np.uint32(1) << (start % 32).astype(np.uint32))
        pool_ids[:, 0] = start
        pool_d[:, 0] = _dists_host(xq, self._xb,
                                   start[:, None].astype(np.int32))[:, 0]
        adj = self.layers[level]
        K = adj.shape[1]
        while True:
            cand = np.where(pool_exp | (pool_ids < 0), np.inf, pool_d)
            sel = np.argmin(cand, axis=1)
            active = np.isfinite(cand[rows, sel])
            if not active.any():
                break
            sel_nodes = np.where(active, pool_ids[rows, sel], 0).astype(np.int32)
            pool_exp[rows, sel] |= active
            nbrs = adj[sel_nodes]
            v = np.maximum(nbrs, 0)
            w = v >> 5
            bit = np.uint32(1) << (v & 31).astype(np.uint32)
            seen = (visited[rows[:, None], w] & bit) != 0
            mask = ((nbrs >= 0) & inserted[v] & ~seen & active[:, None])
            # in-row duplicate suppression: keep only the first occurrence
            eq = nbrs[:, :, None] == nbrs[:, None, :]
            first = np.argmax(eq, axis=2) == np.arange(K)[None, :]
            mask &= first
            np.bitwise_or.at(
                visited, (rows[:, None], w),
                np.where(mask, bit, np.uint32(0)))
            nodes = np.where(mask, nbrs, -1)
            d2 = _dists_host(xq, self._xb, nodes)
            all_ids = np.concatenate([pool_ids, np.where(mask, nbrs, -1)], axis=1)
            all_d = np.concatenate([pool_d, np.where(mask, d2, np.inf)], axis=1)
            all_exp = np.concatenate([pool_exp, np.zeros_like(mask)], axis=1)
            ordr = np.lexsort((np.where(all_ids < 0, np.iinfo(np.int64).max,
                                        all_ids), all_d), axis=1)[:, :ef]
            r = np.arange(B)[:, None]
            pool_ids, pool_d, pool_exp = all_ids[r, ordr], all_d[r, ordr], all_exp[r, ordr]
        return pool_ids, pool_d

    def _select_neighbors(self, cand_ids: np.ndarray, cand_d: np.ndarray,
                          M: int) -> np.ndarray:
        """Closest-M selection (cand arrays are distance-sorted already)."""
        return cand_ids[:, :M]

    def _insert_batch(self, pts: np.ndarray, xb_dev, inserted: np.ndarray,
                      relink: bool = False):
        B = len(pts)
        lvls = self.levels[pts]
        cur = np.full(B, self.entry, dtype=np.int32)
        # descend from the top: greedy on levels above each point's level
        for l in range(self.max_level, -1, -1):
            above = lvls < l
            if above.any():
                sub = np.flatnonzero(above)
                cur[sub] = self._greedy_descend(pts[sub], xb_dev, cur[sub], l,
                                                inserted)
            at = lvls >= l
            if not at.any():
                continue
            sub = np.flatnonzero(at)
            ids, d = self._ef_search(pts[sub], xb_dev, cur[sub], l,
                                     self.ef_construction, inserted)
            Mcap = self.Mmax0 if l == 0 else self.M
            out_deg = min(self.M, Mcap)
            sel = self._select_neighbors(ids, d, out_deg)
            adj = self.layers[l]
            # link assignment + reverse links with degree-cap pruning
            for row, bi in enumerate(sub):
                p = int(pts[bi])
                friends = [int(v) for v in sel[row] if v >= 0 and int(v) != p]
                if relink:
                    # merge with the first pass's links, keep the closest
                    existing = [int(v) for v in adj[p] if v >= 0]
                    merged = np.array(
                        list(dict.fromkeys(existing + friends)), dtype=np.int64)
                    if len(merged):
                        dv = self._pair_d(p, merged)
                        merged = merged[np.argsort(dv)][:out_deg]
                    new_links = [v for v in merged.tolist()
                                 if v not in existing]
                    adj[p, :] = -1
                    adj[p, : len(merged)] = merged
                    friends = new_links  # only add fresh reverse edges below
                else:
                    adj[p, : len(friends)] = friends
                for v in friends:
                    if p in adj[v]:
                        continue
                    slot = np.flatnonzero(adj[v] < 0)
                    if len(slot):
                        adj[v, slot[0]] = p
                    else:
                        # prune: keep the Mcap closest of current ∪ {p}
                        cand = np.append(adj[v], p)
                        dv = self._pair_d(v, cand)
                        keep = np.argsort(dv)[:Mcap]
                        adj[v] = cand[keep]
                cur[bi] = friends[0] if friends else cur[bi]

    def _pair_d(self, v: int, cand: np.ndarray) -> np.ndarray:
        x = self._xb[v]
        y = self._xb[np.maximum(cand, 0)]
        d = ((y - x) ** 2).sum(axis=1)
        return np.where(cand >= 0, d, np.inf)

    # ----------------------------------------------------------------- search

    def level0_graph(self) -> Graph:
        return Graph(self.layers[0])

    def search(self, xq: np.ndarray, k: int, ef: Optional[int] = None,
               graph0=None):
        """Descend upper layers greedily, then pool-search layer 0. ``graph0``
        optionally substitutes a compressed container for the level-0
        adjacency (the replace_final_graph analogue)."""
        xq = np.asarray(xq, np.float32)
        # upper-layer descent + level-0 pool search are each ONE jitted
        # device dispatch (search/graph_device.py) — identical results to
        # the host loops (oracle-tested in tests/test_hnsw.py)
        from .graph_device import hnsw_descend_device, search_graph_device

        cur = hnsw_descend_device(self, xq)
        g0 = graph0 if graph0 is not None else self.level0_graph()
        return search_graph_device(g0, self._xb, xq, k, L=ef or 2 * k,
                                   entry=cur)


def get_level0_links(index: HNSW, vno: int) -> np.ndarray:
    """Parity helper: level-0 friend list of one vertex
    (graph_static_bench_invlists.py:33-50 restricted to level 0)."""
    row = index.layers[0][vno]
    return row[row >= 0]

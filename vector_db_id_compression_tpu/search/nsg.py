"""NSG-style graph construction and batched best-first search.

The reference delegates graph building and traversal to Faiss IndexNSG and
swaps compressed `Graph` subclasses into `nsg.final_graph`
(altid.swig:88-92, test_altid.py:38-39). Here both sides are first-class:

  build_nsg:   brute-force kNN graph (blocked matmuls) + MRNG occlusion
               pruning (the NSG edge-selection rule) + medoid-rooted
               connectivity fix — the standard NSG recipe, computed with
               batched device distance kernels instead of per-node CPU loops.

  search_graph: greedy best-first with a size-L pool, batched across the
               whole query set: each iteration expands one frontier node per
               query, decodes all frontier adjacency lists in ONE
               get_neighbors_batch call (the decode-inside-traversal hot path,
               altid_impl.cpp:153-165) and computes all nq*K candidate
               distances in one einsum. Deterministic tie-breaking by
               (distance, id).

  search_and_trace: same loop, also returning every node id whose distance
               was evaluated, per the reference's TracingDistanceComputer
               (altid_impl.cpp:170-231).
"""

from __future__ import annotations

from functools import partial
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..store.graph import Graph


# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnums=(2,))
def _block_topk(xblock, xb, k):
    dots = jnp.dot(xblock, xb.T, preferred_element_type=jnp.float32,
                                 precision=jax.lax.Precision.HIGHEST)
    b2 = jnp.sum(xb * xb, axis=1)
    d2 = b2[None, :] - 2.0 * dots
    neg, idx = jax.lax.top_k(-d2, k)
    return -neg, idx


@partial(jax.jit, static_argnums=(3,))
def _block_topk_noself(xblock, xb, row0, k):
    """Top-k nearest with the self column masked in-program (row0 + r),
    so no host-side per-row self-drop loop is needed."""
    dots = jnp.dot(xblock, xb.T, preferred_element_type=jnp.float32,
                                 precision=jax.lax.Precision.HIGHEST)
    b2 = jnp.sum(xb * xb, axis=1)
    d2 = b2[None, :] - 2.0 * dots
    B = xblock.shape[0]
    rows = jnp.arange(B, dtype=jnp.int32)
    d2 = d2.at[rows, jnp.minimum(row0 + rows, d2.shape[1] - 1)].set(jnp.inf)
    _, idx = jax.lax.top_k(-d2, k)
    return idx.astype(jnp.int32)


def build_knn_graph(xb: np.ndarray, knn: int, block: int = 1024) -> np.ndarray:
    """Exact kNN graph (self excluded) via blocked matmuls → i32[N, knn].

    All blocks dispatch async (device [block, knn] outputs are tiny); one
    host pull at the end — per-block syncs would serialize ~N/block round
    trips."""
    xb_dev = jnp.asarray(np.asarray(xb, np.float32))
    N = xb_dev.shape[0]
    parts = []
    for lo in range(0, N, block):
        hi = min(lo + block, N)
        blk = xb_dev[lo:hi]
        if hi - lo < block:
            blk = jnp.pad(blk, ((0, block - (hi - lo)), (0, 0)))
        parts.append(_block_topk_noself(blk, xb_dev, jnp.int32(lo), knn))
    out = np.concatenate([np.asarray(p) for p in parts], axis=0)
    return out[:N]


@partial(jax.jit, static_argnums=(3,))
def _mrng_prune_block(cand_vecs, cand_d, valid, R):
    """MRNG occlusion rule over a block of nodes.

    cand_vecs f32[B, C, d] candidate vectors in ascending distance order,
    cand_d f32[B, C] distances to the node, valid bool[B, C].
    Keep candidate j iff no already-kept k has d(k, j) < d(node, j).
    Returns keep mask bool[B, C] with at most R kept per node.
    """
    B, C, _ = cand_vecs.shape
    # pairwise candidate distances [B, C, C]
    dots = jnp.einsum("bcd,bed->bce", cand_vecs, cand_vecs,
                      preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)
    n2 = jnp.sum(cand_vecs * cand_vecs, axis=2)
    pair = n2[:, :, None] + n2[:, None, :] - 2.0 * dots  # d2(c, e)

    def step(carry, j):
        keep, count = carry
        # occluded if any kept k with pair[k, j] < cand_d[j]
        occ = jnp.any(keep & (pair[:, :, j] < cand_d[:, j][:, None]), axis=1)
        ok = valid[:, j] & ~occ & (count < R)
        keep = keep.at[:, j].set(ok)
        return (keep, count + ok.astype(jnp.int32)), None

    keep0 = jnp.zeros((B, C), dtype=bool)
    (keep, _), _ = jax.lax.scan(step, (keep0, jnp.zeros(B, jnp.int32)),
                                jnp.arange(C))
    return keep


def build_nsg(xb: np.ndarray, R: int, knn: Optional[int] = None,
              block: int = 512, progress: bool = None) -> Tuple[Graph, int]:
    """NSG-style graph with max degree R; returns (Graph, medoid entry)."""
    import time as _t

    xb = np.asarray(xb, np.float32)
    N = len(xb)
    if progress is None:
        progress = N >= 200_000
    log = (lambda m: print(f"  [build_nsg] {m}", flush=True)) if progress \
        else (lambda m: None)
    knn = knn or min(max(2 * R, 32), N - 1)
    t0 = _t.time()
    knng = build_knn_graph(xb, knn)
    log(f"knn graph ({knn}-NN) in {_t.time()-t0:.1f}s")

    t0 = _t.time()
    adjacency = np.full((N, R), -1, dtype=np.int32)
    for lo in range(0, N, block):
        hi = min(lo + block, N)
        B = hi - lo
        cand_idx = knng[lo:hi]                       # [B, C]
        cand_vecs = xb[cand_idx]                     # [B, C, d]
        diff = cand_vecs - xb[lo:hi][:, None, :]
        cand_d = (diff * diff).sum(-1).astype(np.float32)
        order = np.argsort(cand_d, axis=1, kind="stable")
        cand_idx = np.take_along_axis(cand_idx, order, axis=1)
        cand_d = np.take_along_axis(cand_d, order, axis=1)
        cand_vecs = xb[cand_idx]
        keep = np.asarray(
            _mrng_prune_block(jnp.asarray(cand_vecs), jnp.asarray(cand_d),
                              jnp.ones((B, knn), bool), R)
        )
        # vectorized scatter of kept candidates into adjacency slots
        # (prune keeps at most R per row); slot R is a discard column
        kcum = np.cumsum(keep, axis=1)
        slot = np.where(keep & (kcum <= R), kcum - 1, R)
        adj_b = np.full((B, R + 1), -1, dtype=np.int32)
        np.put_along_axis(adj_b, slot, np.where(slot < R, cand_idx, -1),
                          axis=1)
        adjacency[lo:hi] = adj_b[:, :R]
    log(f"MRNG prune in {_t.time()-t0:.1f}s")

    # medoid entry + connectivity fix (NSG spanning-tree repair)
    medoid = int(np.argmin(((xb - xb.mean(0)) ** 2).sum(1)))
    t0 = _t.time()
    adjacency = _ensure_connected(adjacency, xb, medoid)
    log(f"connectivity repair in {_t.time()-t0:.1f}s")
    return Graph(adjacency), medoid


def _ensure_connected(adjacency: np.ndarray, xb: np.ndarray, root: int) -> np.ndarray:
    N, R = adjacency.shape
    # BFS by whole frontiers (vectorized) instead of a per-node stack
    seen = np.zeros(N, dtype=bool)
    seen[root] = True
    frontier = np.array([root], dtype=np.int64)
    while len(frontier):
        nxt = adjacency[frontier].ravel()
        nxt = nxt[nxt >= 0]
        nxt = nxt[~seen[nxt]]
        if len(nxt) == 0:
            break
        nxt = np.unique(nxt)
        seen[nxt] = True
        frontier = nxt
    unreached = np.flatnonzero(~seen)
    if len(unreached) == 0:
        return adjacency
    reached = np.flatnonzero(seen)
    # nearest INITIALLY-reached parent per unreached node, computed in one
    # blocked device pass (an incremental python loop re-scanned the whole
    # reached set per node — O(U*N*d) host work at 1M nodes). Attaching to
    # an already-reached parent preserves connectivity exactly the same.
    xr = jnp.asarray(xb[reached])
    parents = np.empty(len(unreached), dtype=np.int64)
    blk = 4096
    for s in range(0, len(unreached), blk):
        e = min(s + blk, len(unreached))
        xu = jnp.asarray(xb[unreached[s:e]])
        d2 = (jnp.sum(xu * xu, axis=1)[:, None]
              - 2.0 * jnp.dot(xu, xr.T, preferred_element_type=jnp.float32,
                                        precision=jax.lax.Precision.HIGHEST)
              + jnp.sum(xr * xr, axis=1)[None, :])
        parents[s:e] = reached[np.asarray(jnp.argmin(d2, axis=1))]
    # slot assignment stays a (cheap) host loop: parents can repeat, and a
    # parent's row may already contain u — a duplicate neighbor would break
    # the ROC container (lossless only for distinct symbols)
    for u, parent in zip(unreached, parents):
        row = adjacency[parent]
        if u not in row:
            free = np.flatnonzero(row < 0)
            slot = int(free[0]) if len(free) else R - 1
            adjacency[parent, slot] = u
    return adjacency


# ---------------------------------------------------------------------------
# batched best-first search
# ---------------------------------------------------------------------------


@jax.jit
def _batch_dists(xq, xb, nodes):
    """d2 f32[nq, K] from each query to its gathered candidate nodes."""
    vecs = xb[jnp.maximum(nodes, 0)]                 # [nq, K, d]
    diff = vecs - xq[:, None, :]
    d2 = jnp.sum(diff * diff, axis=2)
    return jnp.where(nodes >= 0, d2, jnp.inf)


def search_graph(
    graph, xb: np.ndarray, xq: np.ndarray, k: int,
    L: Optional[int] = None, entry: int = 0, trace: bool = False,
) -> Tuple[np.ndarray, np.ndarray, Optional[List[int]]]:
    """Greedy best-first over ``graph`` (any container with
    get_neighbors_batch). Returns (D f32[nq, k], I i64[nq, k], visited or
    None). Pool size L (>= k)."""
    xq = np.asarray(xq, np.float32)
    nq = len(xq)
    L = max(L or 2 * k, k)
    xb_dev = jnp.asarray(np.asarray(xb, np.float32))
    xq_dev = jnp.asarray(xq)

    # per-query pool: ids (int64, -1 empty), dists, expanded flags
    pool_ids = np.full((nq, L), -1, dtype=np.int64)
    pool_d = np.full((nq, L), np.inf, dtype=np.float32)
    pool_exp = np.zeros((nq, L), dtype=bool)
    visited: List[set] = [set() for _ in range(nq)]
    trace_log: List[int] = []

    d0 = np.asarray(_batch_dists(xq_dev, xb_dev,
                                 jnp.full((nq, 1), entry, jnp.int32)))[:, 0]
    if trace:
        trace_log.extend([entry] * nq)
    pool_ids[:, 0] = entry
    pool_d[:, 0] = d0
    for q in range(nq):
        visited[q].add(entry)

    while True:
        # frontier: nearest unexpanded pool entry per query
        cand = np.where(pool_exp | (pool_ids < 0), np.inf, pool_d)
        sel = np.argmin(cand, axis=1)
        active = np.isfinite(cand[np.arange(nq), sel])
        if not active.any():
            break
        sel_nodes = np.where(active, pool_ids[np.arange(nq), sel], 0).astype(np.int32)
        pool_exp[np.arange(nq), sel] |= active

        nbrs, counts = graph.get_neighbors_batch(sel_nodes)  # [nq, K]
        K = nbrs.shape[1]
        # mask: inactive queries and already-visited nodes
        mask = np.zeros((nq, K), dtype=bool)
        for q in range(nq):
            if not active[q]:
                continue
            for j in range(int(counts[q])):
                v = int(nbrs[q, j])
                if v not in visited[q]:
                    visited[q].add(v)
                    mask[q, j] = True
        nodes = np.where(mask, nbrs, -1)
        d2 = np.asarray(_batch_dists(xq_dev, xb_dev, jnp.asarray(nodes)))
        if trace:
            for q in range(nq):
                trace_log.extend(int(v) for v in nodes[q][mask[q]])

        # merge new candidates into pools, keep best L by (dist, id)
        all_ids = np.concatenate([pool_ids, np.where(mask, nbrs, -1)], axis=1)
        all_d = np.concatenate([pool_d, np.where(mask, d2, np.inf)], axis=1)
        all_exp = np.concatenate([pool_exp, np.zeros_like(mask)], axis=1)
        order = np.lexsort((np.where(all_ids < 0, np.iinfo(np.int64).max, all_ids),
                            all_d), axis=1)
        take = order[:, :L]
        r = np.arange(nq)[:, None]
        pool_ids = all_ids[r, take]
        pool_d = all_d[r, take]
        pool_exp = all_exp[r, take]

    D = pool_d[:, :k].copy()
    I = pool_ids[:, :k].copy()
    return D, I, (trace_log if trace else None)


def search_and_trace(graph, xb, xq, k, L=None, entry=0):
    """Reference parity: search_NSG_and_trace (altid_impl.cpp:203-231) —
    returns (labels, distances, visited_nodes)."""
    D, I, visited = search_graph(graph, xb, xq, k, L=L, entry=entry, trace=True)
    return I, D, np.asarray(visited, dtype=np.int64)

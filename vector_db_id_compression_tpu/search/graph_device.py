"""Fully-jitted best-first graph search — the whole traversal in ONE device
program.

The host-driven loop (search/nsg.py:search_graph) pays a host↔device round
trip per hop: per-visit neighbor decode is exactly the reference's
latency-critical integration point (SURVEY.md §3.3). This module keeps the
entire search resident:

  - candidate pools, visited bitsets, and the frontier all live in device
    arrays; the loop is a `lax.while_loop` that runs until no query has an
    unexpanded finite candidate (capped at `max_iters`);
  - the per-hop neighbor fetch is a pluggable *provider*: a pytree of device
    arrays plus a static function `(tree, nodes i32[Q]) -> (nbrs i32[Q, K],
    counts i32[Q])`. Providers exist for the dense Graph and all three
    compressed adjacency containers — the ROC provider runs the batched ANS
    decode *inside* the traversal loop, the device-resident form of the
    reference's decode-inside-get_neighbors hot path (altid_impl.cpp:153-165);
  - results match the host implementation exactly: same pool discipline,
    same (distance, id) lexicographic tie-breaking.

Visited-set: one bitset row per query (u32[Q, ceil(N/32)]); the K per-slot
scatter-ORs are row-unique so the update is deterministic.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..codecs import roc_device as rd
from ..core.bits import get_fixed_fields
from . import nsg as _nsg


# ------------------------------------------------------------- providers

def graph_provider(graph):
    """Dense adjacency (store.graph.Graph)."""
    tree = (jnp.asarray(graph.adjacency), jnp.asarray(graph.degrees))

    def fetch(tree, nodes):
        adj, deg = tree
        return adj[nodes], deg[nodes]

    return tree, fetch, graph.K


def compact_provider(g):
    """CompactBitGraph: fixed-width field decode."""
    tree = (g._words, jnp.asarray(g.degrees))
    K, bits = g.K, g.bits

    def fetch(tree, nodes):
        words, deg = tree
        w = words[nodes]
        idx = jnp.broadcast_to(
            jnp.arange(K, dtype=jnp.int32)[None, :], (nodes.shape[0], K))
        vals = get_fixed_fields(w, bits, idx).astype(jnp.int32)
        return vals, deg[nodes]

    return tree, fetch, K


def ef_provider(g):
    """EliasFanoGraph: per-node EF sweep decode inside the traversal loop.

    One fused row per node — [high_words | low_words | l | m] concatenated
    into a single u32 matrix — so the in-loop fetch is ONE row gather
    instead of six (words, sb directory, nbits, low, l, m each paid a
    separate gather per hop before; the gathers, not the decode math, were
    the EF-vs-ROC traversal gap at 1M). The decode itself is the
    scatter-free count-select sweep: position of the (k+1)-th set bit =
    #positions with inclusive popcount-prefix <= k — the batched
    equivalent of the reference's select_enumerator walk
    (altid_impl.cpp:92-101, elias_fano.hpp:210-261)."""
    from ..codecs.elias_fano import _low_fields_dyn

    ef = g._ef
    K = g.K
    HW = ef.high.words.shape[1]
    LW = ef.low_words.shape[1]
    packed = jnp.concatenate([
        ef.high.words,
        ef.low_words,
        ef.l[:, None].astype(jnp.uint32),
        ef.m[:, None].astype(jnp.uint32),
    ], axis=1)
    tree = (packed, jnp.asarray(g.degrees))

    def fetch(tree, nodes):
        packed, deg = tree
        rows = packed[nodes]                              # ONE gather
        hw = rows[:, :HW]
        lw = rows[:, HW:HW + LW]
        l = rows[:, HW + LW].astype(jnp.int64)
        m = rows[:, HW + LW + 1].astype(jnp.int32)
        Q = nodes.shape[0]
        shifts = jnp.arange(32, dtype=jnp.uint32)
        bits = ((hw[:, :, None] >> shifts) & jnp.uint32(1)).reshape(
            Q, HW * 32)
        counts = jnp.cumsum(bits.astype(jnp.int32), axis=1)
        k = jnp.broadcast_to(jnp.arange(K, dtype=jnp.int32)[None, :], (Q, K))
        high_pos = jnp.sum(
            (counts[:, :, None] <= k[:, None, :]).astype(jnp.int32), axis=1)
        lane = jnp.broadcast_to(
            jnp.arange(Q, dtype=jnp.int32)[:, None], (Q, K))
        low = _low_fields_dyn(lw, l, lane, k)
        vals = ((high_pos - k).astype(jnp.uint64)
                << l[:, None].astype(jnp.uint64)) | low
        vals = jnp.where(k < m[:, None], vals, 0).astype(jnp.int32)
        return vals, deg[nodes]

    return tree, fetch, K


def _kernel_fetch(dec, deg_flat, Bn: int, K: int):
    """Neighbor fetch through the ROC decode kernel (ops.roc_pallas): the
    decoder's prepared lane buffers ride the provider tree as ARGUMENTS (a
    closure constant would bake them into the program). ``Bn`` nodes share
    one chained lane (1 = RocGraph, one lane per node)."""
    from ..ops import roc_pallas as rp

    tree = (dec.buf, dec.head, dec.ptr, dec.lens, dec.prec,
            jnp.asarray(deg_flat))

    def fetch(tree, nodes):
        buf, head, ptr, lens, prec, deg = tree
        lane = (nodes // Bn).astype(jnp.int32)
        sub_lens = lens[:, lane]
        emit, _ = rp.run_kernel(buf[:, lane], head[lane], ptr[lane],
                                sub_lens, prec[:, lane], n_max=K)
        ids = rp.to_sampling_order(emit, sub_lens)       # [Q, S, K]
        rows = ids[jnp.arange(nodes.shape[0]), nodes % Bn]
        return rows.astype(jnp.int32), deg[nodes]

    return tree, fetch, K


def _graph_decoder(states, degs, prec, pool, K):
    """Validated kernel decoder for a ROC adjacency container, or None when
    the route (ops.route) is the XLA path."""
    from ..ops import roc_pallas as rp
    from ..ops import route

    prec = np.asarray(prec, np.int32)
    if route.roc_decode_route(int(prec.max(initial=1))) == route.XLA:
        return None
    return rp.RocPallasDecoder(states, degs, prec, pool, K).checked()


def roc_provider(g):
    """RocGraph: full ANS decode of each visited node's neighbor set, inside
    the traversal loop (the reference's decode-in-get_neighbors hot path).
    On a GPU the fetch is one decode-kernel launch over the frontier lanes;
    elsewhere it runs the XLA scan chain (ops.route picks)."""
    K = g.K
    dec = _graph_decoder(g._states, g.degrees, g.id_symbol_precision,
                         rd.default_pool(K), K)
    if dec is not None:
        return _kernel_fetch(dec, g.degrees, 1, K)

    tree = (g._states, g._prec_dev, jnp.asarray(g.degrees),
            rd.default_pool(K))
    n_slices = g._n_slices

    def fetch(tree, nodes):
        states, prec, deg, pool = tree
        sub = jax.tree_util.tree_map(lambda a: a[nodes], states)
        ids, _ = rd.roc_decode_batch(sub, deg[nodes], prec[nodes], pool, K,
                                     n_slices)
        return ids.astype(jnp.int32), deg[nodes]

    return tree, fetch, K


def roc_block_provider(g):
    """RocBlockGraph: chained ANS decode of each visited node's whole block,
    then select the node's slot. block x the decode work of roc_provider in
    exchange for the amortized head (the container's rate/access trade).
    On a GPU the whole chain is one decode-kernel launch per fetch."""
    K, Bn = g.K, g.block
    dec = _graph_decoder(g._states, np.asarray(g._degs), np.asarray(g._prec),
                         rd.default_pool(Bn * K), K)
    if dec is not None:
        return _kernel_fetch(dec, g.degrees, Bn, K)

    tree = (g._states, g._prec, g._degs, jnp.asarray(g.degrees),
            rd.default_pool(Bn * K))
    n_slices = g._n_slices

    def fetch(tree, nodes):
        states, prec, degs, deg_flat, pool = tree
        blk = nodes // Bn
        sub = jax.tree_util.tree_map(lambda a: a[blk], states)
        ids, _ = rd.roc_decode_chained(sub, degs[blk], prec[blk], pool, K,
                                       n_slices)
        rows = ids[jnp.arange(nodes.shape[0]), nodes % Bn]
        return rows.astype(jnp.int32), deg_flat[nodes]

    return tree, fetch, K


def provider_for(graph):
    """Pick (and memoize on the instance — the fetch closure is a static jit
    argument, so a fresh one per call would force a retrace) the provider
    matching a graph container."""
    cached = graph.__dict__.get("_device_provider")
    if cached is not None:
        return cached
    from ..store.graph import (CompactBitGraph, EliasFanoGraph, Graph,
                               RocBlockGraph, RocGraph)

    if isinstance(graph, Graph):
        p = graph_provider(graph)
    elif isinstance(graph, CompactBitGraph):
        p = compact_provider(graph)
    elif isinstance(graph, EliasFanoGraph):
        p = ef_provider(graph)
    elif isinstance(graph, RocGraph):
        p = roc_provider(graph)
    elif isinstance(graph, RocBlockGraph):
        p = roc_block_provider(graph)
    else:
        raise TypeError(type(graph))
    graph.__dict__["_device_provider"] = p
    return p


# ------------------------------------------------------------- the search

_I64_MAX = np.iinfo(np.int64).max


@partial(jax.jit, static_argnums=(0, 4, 5, 6, 7))
def _search(fetch, tree, xb, xq, K, k, L, max_iters, entry):
    # entry: i32[nq] per-query entry nodes
    nq, d = xq.shape
    N = xb.shape[0]
    NW = (N + 31) // 32

    def dists(nodes):
        vecs = xb[jnp.maximum(nodes, 0)]
        dd = jnp.sum((vecs - xq[:, None, :]) ** 2, axis=2)
        return jnp.where(nodes >= 0, dd, jnp.inf)

    pool_ids = jnp.full((nq, L), -1, dtype=jnp.int64)
    pool_d = jnp.full((nq, L), jnp.inf, dtype=jnp.float32)
    pool_exp = jnp.zeros((nq, L), dtype=bool)
    visited = jnp.zeros((nq, NW), dtype=jnp.uint32)

    rows = jnp.arange(nq)
    e = entry.astype(jnp.int32)                  # i32[nq] per-query entries
    d0 = dists(e[:, None])[:, 0]
    pool_ids = pool_ids.at[:, 0].set(e.astype(jnp.int64))
    pool_d = pool_d.at[:, 0].set(d0)
    visited = visited.at[rows, e // 32].set(
        jnp.uint32(1) << (e % 32).astype(jnp.uint32))

    def cond(carry):
        pool_ids, pool_d, pool_exp, visited, it = carry
        cand = jnp.where(pool_exp | (pool_ids < 0), jnp.inf, pool_d)
        return (it < max_iters) & jnp.any(jnp.isfinite(cand))

    def body(carry):
        pool_ids, pool_d, pool_exp, visited, it = carry
        cand = jnp.where(pool_exp | (pool_ids < 0), jnp.inf, pool_d)
        sel = jnp.argmin(cand, axis=1)
        active = jnp.isfinite(cand[rows, sel])
        sel_nodes = jnp.where(active, pool_ids[rows, sel], 0).astype(jnp.int32)
        pool_exp = pool_exp.at[rows, sel].set(pool_exp[rows, sel] | active)

        nbrs, counts = fetch(tree, sel_nodes)          # [nq, K]
        slot_ok = (jnp.arange(K, dtype=jnp.int32)[None, :] < counts[:, None])
        nbrs = jnp.where(slot_ok & active[:, None], nbrs, -1)

        # visited filter + mark (per-slot scatter-OR; one index per row)
        v = jnp.maximum(nbrs, 0)
        w_idx = (v // 32).astype(jnp.int32)
        bit = jnp.uint32(1) << (v % 32).astype(jnp.uint32)
        seen = (visited[rows[:, None], w_idx] & bit) != 0
        fresh = (nbrs >= 0) & ~seen
        # in-row duplicate suppression: keep only the first occurrence
        eq = nbrs[:, :, None] == nbrs[:, None, :]
        first = jnp.argmax(eq, axis=2) == jnp.arange(K)[None, :]
        fresh = fresh & first
        for j in range(K):
            visited = visited.at[rows, w_idx[:, j]].set(
                visited[rows, w_idx[:, j]]
                | jnp.where(fresh[:, j], bit[:, j], jnp.uint32(0)))

        new_ids = jnp.where(fresh, nbrs, -1).astype(jnp.int64)
        new_d = jnp.where(fresh, dists(new_ids.astype(jnp.int32)), jnp.inf)

        all_ids = jnp.concatenate([pool_ids, new_ids], axis=1)
        all_d = jnp.concatenate([pool_d, new_d], axis=1)
        all_exp = jnp.concatenate([pool_exp, jnp.zeros_like(fresh)], axis=1)
        # host-parity tie-breaking: (distance, id) lexicographic
        id_key = jnp.where(all_ids < 0, _I64_MAX, all_ids)
        order = jnp.lexsort((id_key, all_d), axis=1)[:, :L]
        pool_ids = jnp.take_along_axis(all_ids, order, axis=1)
        pool_d = jnp.take_along_axis(all_d, order, axis=1)
        pool_exp = jnp.take_along_axis(all_exp, order, axis=1)
        return pool_ids, pool_d, pool_exp, visited, it + 1

    pool_ids, pool_d, pool_exp, visited, it = jax.lax.while_loop(
        cond, body, (pool_ids, pool_d, pool_exp, visited, jnp.int32(0)))
    return pool_d[:, :k], pool_ids[:, :k], it


@jax.jit
def _descend(levels_tree, xb, xq, entry):
    """Greedy (ef=1) walk through a stack of upper HNSW layers, top → 1, in
    ONE device program. ``levels_tree`` is a tuple of (nodes_l i32[N_l],
    adj_l i32[N_l, M]) compact per-level adjacency, ordered top level first;
    nodes_l is sorted so the global-id → row mapping is a searchsorted.

    Host parity: identical to HNSW._greedy_descend per level (the walk only
    ever stands on nodes present at that level, so the row lookup always
    hits)."""
    nq = xq.shape[0]
    cur = jnp.broadcast_to(jnp.asarray(entry, jnp.int32), (nq,))
    cur_d = jnp.sum((xb[cur] - xq) ** 2, axis=1)

    for nodes_l, adj_l in levels_tree:
        def body(carry):
            cur, cur_d, _ = carry
            row = jnp.searchsorted(nodes_l, cur).astype(jnp.int32)
            nbrs = adj_l[jnp.clip(row, 0, adj_l.shape[0] - 1)]   # [nq, M]
            vecs = xb[jnp.maximum(nbrs, 0)]
            d = jnp.sum((vecs - xq[:, None, :]) ** 2, axis=2)
            d = jnp.where(nbrs >= 0, d, jnp.inf)
            best = jnp.argmin(d, axis=1)
            bd = d[jnp.arange(nq), best]
            improve = bd < cur_d
            cur = jnp.where(improve, nbrs[jnp.arange(nq), best], cur)
            cur_d = jnp.where(improve, bd, cur_d)
            return cur, cur_d, jnp.any(improve)

        cur, cur_d, _ = jax.lax.while_loop(
            lambda c: c[2], body, (cur, cur_d, jnp.bool_(True)))
    return cur


def hnsw_descend_device(hnsw, xq) -> np.ndarray:
    """Per-query level-0 entry points for an HNSW index: the upper-layer
    greedy descent (reference hnsw-equivalent of altid's NSG entry) as one
    jitted dispatch instead of a host loop per level (round 1 this dominated
    HNSW wall time — NOTES.md). Returns i32[nq]."""
    xq = np.asarray(xq, np.float32)
    if hnsw.max_level <= 0:
        return np.full(len(xq), hnsw.entry, dtype=np.int32)
    tree = hnsw.__dict__.get("_descend_tree")
    if tree is None:
        # compact per-level adjacency: rows only for nodes at that level,
        # sorted by id (node population decays geometrically with level, so
        # this costs ~N/(M-1) rows total instead of Lev*N dense)
        tree = tuple(
            (jnp.asarray(np.flatnonzero(hnsw.levels >= l).astype(np.int32)),
             jnp.asarray(hnsw.layers[l][hnsw.levels >= l]))
            for l in range(hnsw.max_level, 0, -1)
        )
        hnsw.__dict__["_descend_tree"] = tree
    cur = _descend(tree, jnp.asarray(hnsw._xb), jnp.asarray(xq),
                   np.int32(hnsw.entry))
    return np.asarray(cur)


def search_graph_device(graph, xb, xq, k: int, L: int = None, entry=0,
                        max_iters: int = 0):
    """Drop-in device-resident counterpart of search_graph (host loop):
    returns (D f32[nq, k], I i64[nq, k]). ``graph`` is any adjacency
    container; ``entry`` is one node or a per-query i32[nq] vector (the HNSW
    descent hands every query its own level-0 entry); ``max_iters`` caps the
    while_loop (0 → a safe default of 4 * L + 32 expansions per query)."""
    xq = np.asarray(xq, np.float32)
    L = max(L or 2 * k, k)
    max_iters = max_iters or (4 * L + 32)
    tree, fetch, K = provider_for(graph)
    entries = jnp.asarray(
        np.broadcast_to(np.asarray(entry, np.int32), (len(xq),)))
    D, I, it = _search(fetch, tree, jnp.asarray(np.asarray(xb, np.float32)),
                       jnp.asarray(xq), K, k, L, max_iters, entries)
    if int(np.asarray(it)) >= max_iters:
        # the batched frontier hit the iteration cap before every query's
        # pool converged — results may diverge from the host search; raise
        # max_iters (or L) to restore the documented host parity
        import warnings

        warnings.warn(
            f"search_graph_device stopped at the max_iters={max_iters} cap; "
            "results may be truncated — raise max_iters", RuntimeWarning)
    return np.asarray(D), np.asarray(I)

#!/usr/bin/env python
"""Smoke run of the library's main path on an NVIDIA GPU.

    python chip_smoke.py              # phases 0-3 on one card
    python chip_smoke.py --chips 4    # phase 0, then only ShardedIVF over a
                                      # four-card 'lists' mesh vs one card

Phase 0  the machine: devices, versions, ``nvidia-smi`` name and power
         limit, the compile cache in use, XLA_FLAGS, whether flax imports.
Phase 1  the ROC decode kernel at real widths: bench.py's headline container
         (1024 lists over 2^20 ids, seed 7) in the strict format and in
         chunked lanes (target 128), plus the chained decode of a
         RocBlockGraph. Bit-exact against the native C++ decoder and the XLA
         scan decoder, the kernel's memory analysis, kernel vs XLA times,
         and the 1M-id ROC container's build time, native vs XLA.
Phase 2  the IVF main path at the reference's Tables 1-2 operating point
         (SIFT1M shape: d=128, nt=100k, nb=1M, nq=1000) with IVF1024,Flat
         and IVF1024,PQ16: every compressed container, deferred-decoding
         search and ShardedIVF on a one-device mesh at k=20, nprobe=16.
         Results must equal the uncompressed twin's for every container
         (ids exact up to distance ties; deferred-search distances
         bit-identical, fused ones within FUSED_RTOL, see below); the Flat
         twin must match a NumPy float64 scan of the same probed lists. ROC search times with the kernel and with
         the XLA decode path.
Phase 3  graph search over compressed adjacency: NSG R=32 at the Deep1M
         shape (d=96, nb=1M), five adjacency containers with the same
         results; ROC search times with the kernel and with the XLA path.

Every check raises on failure, so any failed phase exits non-zero. The last
stdout line is one JSON object, ``{"ok": true, "device": {...}}``; the line
before it is the card's ``nvidia-smi`` name and power limit. Without a GPU
the script exits non-zero before it prints a result.
"""

import argparse
import contextlib
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np

SEED = 7
# phase 1: bench.py's headline container
CODEC_NLIST, CODEC_NTOTAL, CHUNK_TARGET = 1024, 1 << 20, 128
BLOCK_GRAPH_N, BLOCK, DEGREE = 65536, 16, 32
# phase 2: reference Tables 1-2 (SIFT1M shape)
IVF_SHAPE = dict(d=128, nt=100_000, nb=1_000_000, nq=1_000)
IVF_INDEXES = ("IVF1024,Flat", "IVF1024,PQ16")
K, NPROBE = 20, 16
# phase 3: reference Deep1M graph bench (graph_dynamic_bench_invlists.py);
# nb would be cut below the source's 1M only if the NSG build did not fit
# the run's time limit
GRAPH_D, GRAPH_NB_FULL, GRAPH_NQ, GRAPH_R = 96, 1_000_000, 1_000, 32
GRAPH_NB = GRAPH_NB_FULL
GRAPH_K, GRAPH_L = 10, 64
RUNS = 5
# distances of two different compiled programs (another container's fused
# search, another mesh) may differ in the last bits: XLA autotunes GEMM and
# reduction algorithms per program
FUSED_RTOL = 1e-5


def log(msg):
    print(msg, flush=True)


def nvidia_smi() -> str:
    """Card name and power limit, read by a child that stays off JAX."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def median_time(fn, runs=RUNS):
    """(median seconds, all runs) of ``fn``, each waited for on the device;
    one warm-up call first (compilation)."""
    import jax

    jax.block_until_ready(fn())
    ts = []
    for _ in range(runs):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), ts


def fmt_ms(ts):
    return "[" + ", ".join(f"{t * 1e3:.3f}" for t in ts) + "] ms"


@contextlib.contextmanager
def forced_route(name):
    """Every ROC decode route decision returns ``name`` inside the block
    (measurement of the XLA path on the card, for comparison only)."""
    from vector_db_id_compression_tpu.ops import route

    orig = route.roc_decode_route
    route.roc_decode_route = lambda *a, **k: name
    try:
        yield
    finally:
        route.roc_decode_route = orig


# ------------------------------------------------------------------ phase 0

def phase0():
    import jax
    import jaxlib

    devs = jax.devices()
    log(f"[phase 0] devices: {devs}")
    log(f"[phase 0] device_kind: {devs[0].device_kind}; jax {jax.__version__}"
        f", jaxlib {jaxlib.__version__}")
    smi = nvidia_smi()
    log(f"[phase 0] nvidia-smi: {smi}")
    log(f"[phase 0] compile cache: {jax.config.jax_compilation_cache_dir}; "
        f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}; flax importable: "
        f"{importlib.util.find_spec('flax') is not None}")
    return smi


# ------------------------------------------------------------------ phase 1

def _check_kernel_decode(tag, states, ent_arrays, ent_len, ent_prec,
                         native_lists):
    """Kernel decode of every lane == XLA scan decode (sampling order, the
    whole padded array) == native decode (sampling order) and == the
    encoded multiset. Prints memory analysis and kernel vs XLA times."""
    import jax
    import jax.numpy as jnp

    from vector_db_id_compression_tpu.codecs import roc_device as rd
    from vector_db_id_compression_tpu.ops import roc_pallas as rp
    from vector_db_id_compression_tpu.ops import route

    n_max = int(ent_len.max())
    assert route.roc_decode_route(int(ent_prec.max())) == route.KERNEL
    pool = rd.default_pool(n_max)
    t0 = time.time()
    dec = rp.RocPallasDecoder(states, ent_len, ent_prec, pool, n_max)
    got, ok = dec.decode()
    got = np.asarray(got).astype(np.uint64)
    assert ok, f"{tag}: kernel flagged stack/pool exhaustion"
    log(f"[phase 1] {tag}: {len(ent_len)} lanes, n_max {n_max}, "
        f"{rp.lanes_per_program(len(ent_len))} lanes/program; kernel first "
        f"call (compile) {time.time() - t0:.1f}s")
    lens_j, prec_j = jnp.asarray(ent_len), jnp.asarray(ent_prec)
    n_sl = rd.n_slices_for(int(ent_prec.max()))
    xla = np.asarray(rd.roc_decode_batch(states, lens_j, prec_j, pool, n_max,
                                         n_sl)[0])
    assert np.array_equal(got, xla), f"{tag}: kernel != XLA decode"
    for e, want in enumerate(native_lists):
        n = int(ent_len[e])
        assert np.array_equal(got[e, :n], want), f"{tag}: lane {e} != native"
        assert np.array_equal(np.sort(got[e, :n]), ent_arrays[e]), \
            f"{tag}: lane {e} multiset"
    log(f"[phase 1] {tag}: kernel == XLA scan == native C++ on every lane "
        f"(sampling order and multisets)")

    def kernel():
        return rp.run_kernel(dec.buf, dec.head, dec.ptr, dec.lens, dec.prec,
                             n_max=n_max)

    def plain():
        return rd.roc_decode_batch(states, lens_j, prec_j, pool, n_max, n_sl)

    compiled = jax.jit(kernel).lower().compile()
    log(f"[phase 1] {tag}: decode program memory: "
        f"{compiled.memory_analysis()}")
    tk, tks = median_time(kernel)
    tx, txs = median_time(plain)
    ntotal = int(ent_len.sum())
    log(f"[phase 1] {tag}: kernel {tk * 1e3:.3f} ms ({ntotal / tk / 1e6:.1f} "
        f"Mids/s) {fmt_ms(tks)}; XLA scan {tx * 1e3:.3f} ms "
        f"({ntotal / tx / 1e6:.1f} Mids/s) {fmt_ms(txs)}")


def phase1():
    import jax.numpy as jnp

    from vector_db_id_compression_tpu import native
    from vector_db_id_compression_tpu.bench.codec_scale import (
        build_entries, build_workload)
    from vector_db_id_compression_tpu.codecs import roc_device as rd
    from vector_db_id_compression_tpu.store.invlists import (
        InvertedLists, RocInvertedLists)

    assert native.available(), "the native codec did not build"
    ids, lengths, prec = build_workload(CODEC_NTOTAL, CODEC_NLIST, SEED)
    for tag, mode in (("strict", "off"), ("chunked", "auto")):
        (ent_arrays, ent_len, ent_prec, _lo, _list, _bound,
         extra) = build_entries(ids, lengths, prec, mode, CHUNK_TARGET)
        cap = rd.stack_capacity(int(ent_len.max()), int(ent_prec.max()))
        heads, stacks, lens, _, mt = native.roc_encode_lists(
            ent_arrays, ent_prec, cap=cap)
        bits = 8.0 * (8 * len(ent_len) + 4 * int(lens.sum()) + 13 * extra) \
            / CODEC_NTOTAL
        log(f"[phase 1] {tag}: {bits:.3f} bits/id")
        states = rd.RocStates(
            head=jnp.asarray(heads), stack=jnp.asarray(stacks),
            stack_len=jnp.asarray(lens),
            mt_ctr=jnp.asarray(mt.astype(np.int32)),
            err=jnp.zeros(len(ent_len), dtype=bool))
        native_lists = native.roc_decode_lists(heads, stacks, lens, ent_len,
                                               ent_prec)
        _check_kernel_decode(tag, states, ent_arrays, ent_len, ent_prec,
                             native_lists)

    # build time of the 1M-id ROC container: native C++ vs the XLA scan
    il = InvertedLists(CODEC_NLIST, 0)
    for ln in range(CODEC_NLIST):
        il.add_entries(ln, ids[ln, : lengths[ln]])
    builds = {}
    for tag, use_native in (("native", True), ("xla-cold", False),
                            ("xla-warm", False)):
        t0 = time.time()
        c = RocInvertedLists(il, use_native=use_native)
        for st in c._states:
            st.head.block_until_ready()
        builds[tag] = (time.time() - t0, c)
    assert all(c.compressed_ids_size_in_bytes
               == builds["native"][1].compressed_ids_size_in_bytes
               for _, c in builds.values())
    for a, b in zip(builds["native"][1]._states, builds["xla-warm"][1]._states):
        assert np.array_equal(np.asarray(a.head), np.asarray(b.head))
        assert np.array_equal(np.asarray(a.stack), np.asarray(b.stack))
    log("[phase 1] 1M-id ROC container build: " + ", ".join(
        f"{t}: {s:.3f}s" for t, (s, _) in builds.items())
        + " (identical streams)")

    _phase1_chained()


def _phase1_chained():
    from vector_db_id_compression_tpu.codecs import roc_device as rd
    from vector_db_id_compression_tpu.ops import roc_pallas as rp
    from vector_db_id_compression_tpu.store.graph import Graph, RocBlockGraph

    rng = np.random.default_rng(SEED)
    N = BLOCK_GRAPH_N
    adj = np.full((N, DEGREE), -1, np.int32)
    degs = rng.integers(DEGREE // 2, DEGREE + 1, size=N)
    for i in range(N):
        adj[i, : degs[i]] = rng.choice(N, size=degs[i], replace=False)
    g = RocBlockGraph(Graph(adj), block=BLOCK)
    pool = rd.default_pool(BLOCK * DEGREE)
    dec = rp.RocPallasDecoder(g._states, np.asarray(g._degs),
                              np.asarray(g._prec), pool, DEGREE)
    got, ok = dec.decode()
    assert ok
    got = np.asarray(got).astype(np.uint64)
    n_sl = g._n_slices
    xla = np.asarray(rd.roc_decode_chained(g._states, g._degs, g._prec, pool,
                                           DEGREE, n_sl)[0])
    assert np.array_equal(got, xla), "chained: kernel != XLA"
    flat = got.reshape(-1, DEGREE)[:N]
    for i in range(N):
        assert np.array_equal(np.sort(flat[i, : degs[i]]),
                              np.sort(adj[i, : degs[i]]).astype(np.uint64))
    log(f"[phase 1] chained (RocBlockGraph, {N} nodes, block {BLOCK}): "
        f"kernel == XLA chained decode == adjacency multisets")
    S = BLOCK

    def kernel():
        return rp.run_kernel(dec.buf, dec.head, dec.ptr, dec.lens, dec.prec,
                             n_max=DEGREE)

    def plain():
        return rd.roc_decode_chained(g._states, g._degs, g._prec, pool,
                                     DEGREE, n_sl)

    tk, tks = median_time(kernel)
    tx, txs = median_time(plain)
    log(f"[phase 1] chained ({N // S} lanes x {S} slots): kernel "
        f"{tk * 1e3:.3f} ms {fmt_ms(tks)}; XLA {tx * 1e3:.3f} ms "
        f"{fmt_ms(txs)}")


# ------------------------------------------------------------------ phase 2

def _float64_reference(index, xq, k, nprobe):
    """Plain NumPy float64 scan of the probed lists of the uncompressed
    Flat index → (D, I)."""
    src, d = index.invlists, index.d
    probes = index.coarse_assign(xq, nprobe)
    vecs = [src.codes[ln].view(np.float32).reshape(-1, d).astype(np.float64)
            for ln in range(index.nlist)]
    ids = [src.ids[ln].astype(np.int64) for ln in range(index.nlist)]
    D = np.full((len(xq), k), np.inf)
    I = np.full((len(xq), k), -1, np.int64)
    for q in range(len(xq)):
        V = np.concatenate([vecs[p] for p in probes[q]])
        J = np.concatenate([ids[p] for p in probes[q]])
        dist = ((V - xq[q].astype(np.float64)) ** 2).sum(1)
        o = np.argsort(dist, kind="stable")[:k]
        D[q, : len(o)] = dist[o]
        I[q, : len(o)] = J[o]
    return D, I


def _check_vs_float64(tag, D, I, Dref, Iref, xb, xq):
    """Distances within 1e-4 relative; ids equal except where the returned
    id's float64 distance ties the reference's at that rank within 1e-5."""
    rel = np.abs(D - Dref) / np.maximum(np.abs(Dref), 1e-30)
    assert rel.max() <= 1e-4, f"{tag}: max rel distance error {rel.max()}"
    bad = np.argwhere(I != Iref)
    for q, j in bad:
        dd = ((xb[I[q, j]].astype(np.float64) - xq[q]) ** 2).sum()
        assert abs(dd - Dref[q, j]) <= 1e-5 * Dref[q, j], \
            f"{tag}: query {q} rank {j}: id {I[q, j]} vs {Iref[q, j]}"
    log(f"[phase 2] {tag} == NumPy float64 scan of the probed lists (max rel "
        f"distance error {rel.max():.2e}; {len(bad)} id swaps, all ties)")


def _assert_same(tag, a, b, rtol=0.0):
    """(D, I) pairs. D bit-identical (``rtol`` 0) for results of the same
    compiled programs; within ``rtol`` across different programs, where
    XLA may pick another GEMM or reduction algorithm and move the last bits.
    I identical except among distances equal within that tolerance (PQ
    codes repeat, so reconstructions tie, and a container's code order
    decides which tied id comes first). Returns (swaps, max rel D diff)."""
    (Da, Ia), (Db, Ib) = a, b
    assert np.array_equal(np.isfinite(Da), np.isfinite(Db)), tag
    fin = np.isfinite(Da)
    rel = np.abs(Da[fin] - Db[fin]) / np.maximum(np.abs(Db[fin]), 1e-30)
    rel_max = float(rel.max(initial=0.0))
    assert rel_max <= rtol, f"{tag}: distances differ by {rel_max:.2e}"
    swaps = 0
    for q, j in np.argwhere(Ia != Ib):
        tol = rtol * abs(Da[q, j])
        tied = (np.count_nonzero(np.abs(Da[q] - Da[q, j]) <= tol) > 1
                or abs(Da[q, j] - Da[q, -1]) <= tol)
        assert tied, f"{tag}: query {q} rank {j}: id {Ia[q, j]} vs {Ib[q, j]}"
        swaps += 1
    return swaps, rel_max


def phase2():
    from vector_db_id_compression_tpu.bench.bench_invlists import build_index
    from vector_db_id_compression_tpu.bench.datasets import SyntheticDataset
    from vector_db_id_compression_tpu.parallel.mesh import make_lists_mesh
    from vector_db_id_compression_tpu.parallel.search import ShardedIVF
    from vector_db_id_compression_tpu.store.invlists import (
        AVAILABLE_COMPRESSED_IVFS)

    t0 = time.time()
    ds = SyntheticDataset(seed=SEED, **IVF_SHAPE)
    xb, xq = ds.get_database(), ds.get_queries()
    gt = ds.get_groundtruth(1)
    log(f"[phase 2] {ds} with exact ground truth in {time.time() - t0:.1f}s")
    mesh1 = make_lists_mesh(1)
    for index_str in IVF_INDEXES:
        t0 = time.time()
        index = build_index(ds, index_str)
        src = index.invlists
        log(f"[phase 2] {index_str}: trained + added in "
            f"{time.time() - t0:.1f}s")
        containers = {"none": src}
        for m, fac in AVAILABLE_COMPRESSED_IVFS.items():
            t0 = time.time()
            containers[m] = fac(src)
            log(f"[phase 2] {index_str}: built {m} in {time.time() - t0:.2f}s")
        res = {}
        for m, c in containers.items():
            index.replace_invlists(c)
            by1 = getattr(c, "supports_random_access", True)
            host = index.search_defer_id_decoding(xq, K, nprobe=NPROBE,
                                                  decode_1by1=by1)
            sh = ShardedIVF(mesh1, index, c)
            fused = sh.search(xq, K, NPROBE)
            res[m] = (host, fused, sh, c)
            bits = 8.0 * getattr(c, "compressed_ids_size_in_bytes",
                                 8 * index.ntotal) / index.ntotal
            log(f"[phase 2] {index_str} {m:15s} bits/id {bits:6.3f} "
                f"recall@1 {np.mean(host[1][:, 0] == gt[:, 0]):.4f}")
        host0, fused0 = res["none"][:2]
        swaps_h = swaps_f = 0
        rel_f = 0.0
        for m, (host, fused, _, _) in res.items():
            swaps_h += _assert_same(
                f"{index_str} {m}: deferred search != twin", host, host0)[0]
            sw, rel = _assert_same(f"{index_str} {m}: ShardedIVF != twin",
                                   fused, fused0, rtol=FUSED_RTOL)
            swaps_f, rel_f = swaps_f + sw, max(rel_f, rel)
        np.testing.assert_allclose(fused0[0], host0[0], rtol=1e-4)
        log(f"[phase 2] {index_str}: deferred search: D bit-identical and I "
            f"identical up to exact ties ({swaps_h} tied swaps) across "
            f"{len(res) - 1} containers and the uncompressed twin; "
            f"ShardedIVF (one program per container): D within "
            f"{rel_f:.2e} relative, {swaps_f} tied swaps")
        if index_str.endswith("Flat"):
            Dref, Iref = _float64_reference(index, xq, K, NPROBE)
            _check_vs_float64("deferred search", *host0, Dref, Iref, xb, xq)
            _check_vs_float64("ShardedIVF", *fused0, Dref, Iref, xb, xq)
            _time_roc_routes(index, src, res, xq, mesh1)
        del containers, res


def _time_roc_routes(index, src, res, xq, mesh1):
    """End-to-end search times of the ROC containers with the decode kernel
    and with the XLA decode path (fresh containers under a forced route).
    ShardedIVF decodes on the device only for RocInvertedLists; it holds an
    interleaved container's ids as a plain table."""
    from vector_db_id_compression_tpu.parallel.search import ShardedIVF
    from vector_db_id_compression_tpu.store.invlists import (
        AVAILABLE_COMPRESSED_IVFS)

    def host_search(c):
        index.replace_invlists(c)
        return lambda: index.search_defer_id_decoding(
            xq, K, nprobe=NPROBE, decode_1by1=False)

    for m in ("roc", "roc-interleaved"):
        c = AVAILABLE_COMPRESSED_IVFS[m](src)
        with forced_route("xla"):
            c_xla = AVAILABLE_COMPRESSED_IVFS[m](src)
            th_x, ths_x = median_time(host_search(c_xla))
            out_x = host_search(c_xla)()
        th_k, ths_k = median_time(host_search(c))
        _assert_same(f"{m}: XLA route deferred search", out_x, res[m][0])
        log(f"[phase 2] {m} nprobe {NPROBE}: deferred search with the kernel "
            f"{th_k * 1e3:.2f} ms {fmt_ms(ths_k)}, with the XLA path "
            f"{th_x * 1e3:.2f} ms {fmt_ms(ths_x)}")
    sh = res["roc"][2]
    with forced_route("xla"):
        index.replace_invlists(res["roc"][3])
        sh_xla = ShardedIVF(mesh1, index, res["roc"][3])
        tf_x, tfs_x = median_time(lambda: sh_xla.search(xq, K, NPROBE))
        out_x = sh_xla.search(xq, K, NPROBE)
    assert sh_xla._kernel is None and sh._kernel is not None
    tf_k, tfs_k = median_time(lambda: sh.search(xq, K, NPROBE))
    _assert_same("roc: XLA route ShardedIVF", out_x, res["roc"][1],
                 rtol=FUSED_RTOL)
    log(f"[phase 2] roc nprobe {NPROBE}: ShardedIVF with the kernel "
        f"{tf_k * 1e3:.2f} ms {fmt_ms(tfs_k)}, with the XLA path "
        f"{tf_x * 1e3:.2f} ms {fmt_ms(tfs_x)}")


# ------------------------------------------------------------------ phase 3

def phase3():
    from vector_db_id_compression_tpu.bench.datasets import SyntheticDataset
    from vector_db_id_compression_tpu.search.graph_device import (
        search_graph_device)
    from vector_db_id_compression_tpu.search.nsg import build_nsg
    from vector_db_id_compression_tpu.store.graph import (
        CompactBitGraph, EliasFanoGraph, RocBlockGraph, RocGraph)

    log(f"[phase 3] NSG{GRAPH_R} at d={GRAPH_D}, nb {GRAPH_NB} (the source's "
        f"{GRAPH_NB_FULL}" + (", cut so the build fits the run)"
                              if GRAPH_NB < GRAPH_NB_FULL else ", no cut)"))
    ds = SyntheticDataset(d=GRAPH_D, nt=1000, nb=GRAPH_NB, nq=GRAPH_NQ,
                          seed=SEED)
    xb, xq = ds.get_database(), ds.get_queries()
    gt = ds.get_groundtruth(1)
    t0 = time.time()
    g, medoid = build_nsg(xb, GRAPH_R)
    log(f"[phase 3] NSG built in {time.time() - t0:.1f}s, mean degree "
        f"{g.degrees.mean():.2f}")
    graphs = {"none": g}
    for name, cls in (("compact", CompactBitGraph),
                      ("elias-fano", EliasFanoGraph), ("roc", RocGraph),
                      ("roc-block", RocBlockGraph)):
        t0 = time.time()
        graphs[name] = cls(g)
        log(f"[phase 3] built {name} in {time.time() - t0:.2f}s")

    def search(gr):
        return lambda: search_graph_device(gr, xb, xq, GRAPH_K, L=GRAPH_L,
                                           entry=medoid)

    res = {}
    for name, gr in graphs.items():
        t, ts = median_time(search(gr), runs=3)
        res[name] = search(gr)()
        edges = int(g.degrees.sum())
        bpe = (32.0 if name == "none" else 8.0 * (
            gr.compressed_ids_size_in_bytes + gr.overhead_in_bytes) / edges)
        log(f"[phase 3] {name:10s} bits/edge {bpe:6.3f} recall@1 "
            f"{np.mean(res[name][1][:, 0] == gt[:, 0]):.4f} search "
            f"{t * 1e3:.2f} ms {fmt_ms(ts)}")
    rel_g = max(_assert_same(f"graph {name} != dense adjacency", r,
                             res["none"], rtol=FUSED_RTOL)[1]
                for name, r in res.items())
    log(f"[phase 3] I equal up to distance ties and D within {rel_g:.2e} "
        f"relative across the {len(res)} adjacency containers")
    for name in ("roc", "roc-block"):
        gr = graphs[name]
        with forced_route("xla"):
            gr.__dict__.pop("_device_provider", None)
            t, ts = median_time(search(gr), runs=3)
            out = search(gr)()
        gr.__dict__.pop("_device_provider", None)
        _assert_same(f"graph {name}: XLA route", out, res[name],
                     rtol=FUSED_RTOL)
        log(f"[phase 3] {name} search with the XLA decode path: "
            f"{t * 1e3:.2f} ms {fmt_ms(ts)}")


# ---------------------------------------------------------- four-card path

def four_cards():
    import jax

    from vector_db_id_compression_tpu.bench.bench_invlists import build_index
    from vector_db_id_compression_tpu.bench.datasets import SyntheticDataset
    from vector_db_id_compression_tpu.parallel.mesh import make_lists_mesh
    from vector_db_id_compression_tpu.parallel.search import ShardedIVF
    from vector_db_id_compression_tpu.store.invlists import (
        AVAILABLE_COMPRESSED_IVFS)

    assert len(jax.devices()) == 4, f"--chips 4 needs 4 cards: {jax.devices()}"
    ds = SyntheticDataset(seed=SEED, **IVF_SHAPE)
    xq = ds.get_queries()
    index = build_index(ds, IVF_INDEXES[0])
    src = index.invlists
    containers = {"none": src}
    containers.update({m: fac(src)
                       for m, fac in AVAILABLE_COMPRESSED_IVFS.items()})
    mesh1, mesh4 = make_lists_mesh(1), make_lists_mesh(4)
    for m, c in containers.items():
        index.replace_invlists(c)
        sh1 = ShardedIVF(mesh1, index, c)
        sh4 = ShardedIVF(mesh4, index, c)
        t1, _ = median_time(lambda: sh1.search(xq, K, NPROBE))
        t4, _ = median_time(lambda: sh4.search(xq, K, NPROBE))
        swaps, rel = _assert_same(f"{m}: 4 cards != 1 card",
                                  sh4.search(xq, K, NPROBE),
                                  sh1.search(xq, K, NPROBE), rtol=FUSED_RTOL)
        log(f"[4 cards] {IVF_INDEXES[0]} {m:15s}: D within {rel:.2e} of the "
            f"1-card run, I equal ({swaps} tied swaps); search 1 card "
            f"{t1 * 1e3:.2f} ms, 4 cards {t4 * 1e3:.2f} ms")


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--chips", type=int, choices=(1, 4), default=1,
                   help="4: run only ShardedIVF over a four-card mesh and "
                        "compare it with the one-card run")
    args = p.parse_args()

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke.py needs a GPU; JAX found {devs}",
              file=sys.stderr)
        return 1
    import vector_db_id_compression_tpu  # noqa: F401  (fails fast alone)

    t_start = time.time()
    smi = phase0()
    phases = ([four_cards] if args.chips == 4
              else [phase1, phase2, phase3])
    for ph in phases:
        t0 = time.time()
        ph()
        log(f"[{ph.__name__}] done in {time.time() - t0:.1f}s")
    log(f"total {time.time() - t_start:.1f}s")
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

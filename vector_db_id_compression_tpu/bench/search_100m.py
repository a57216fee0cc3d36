"""100M-id IVF search point — the stepping stone to the reference's 1B
headline (/root/reference/README.md:161-197, bigann1B IVF1M_8x8).

Workload: a generator-assigned synthetic IVF — ``nlist`` Gaussian centers,
each database point drawn FROM its center, so the coarse assignment is
exact by construction (no 100M x nlist assignment matmul, which at this
shape costs ~4e17 FLOPs — the same reason the reference's 1B config
quantizes through an HNSW). Recall against exact blocked ground truth is
meaningful because the data is genuinely clustered.

Storage is PQ``--M`` bytes per id scanned through the LUT byte path
(VDBIDC_PQ_DECODE_SCAN=0 — at 100M ids the decoded-f32 scan would need
12.8 GB of HBM payload; the byte path holds 1.6 GB). ID containers under
test: none (raw 64-bit), roc, elias-fano — deferred decoding, grouped or
random-access translation per container capability. The oracle is recall
PARITY across containers (IDs are lossless) plus the redo-averaged
t_search.

    python -m vector_db_id_compression_tpu.bench.search_100m \
        --ntotal 100000000 --nlist 65536 --out results/search_100m.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def build_clustered(ntotal, nlist, d, nq, seed):
    """Generator-assigned clustered corpus, chunked to bound peak memory.
    Returns (centroids f32[nlist, d], assignment i32[ntotal], xb f32 memmap
    -shaped array, xq f32[nq, d])."""
    rng = np.random.default_rng(seed)
    cent = (rng.standard_normal((nlist, d)) * 4.0).astype(np.float32)
    assignment = rng.integers(0, nlist, size=ntotal).astype(np.int32)
    xb = np.empty((ntotal, d), np.float32)
    C = 4_000_000
    for s in range(0, ntotal, C):
        e = min(s + C, ntotal)
        xb[s:e] = cent[assignment[s:e]] + rng.standard_normal(
            (e - s, d)).astype(np.float32)
    qi = rng.integers(0, ntotal, size=nq)
    xq = xb[qi] + 0.05 * rng.standard_normal((nq, d)).astype(np.float32)
    return cent, assignment, xb, xq


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ntotal", type=int, default=100_000_000)
    p.add_argument("--nlist", type=int, default=65536)
    p.add_argument("--d", type=int, default=32)
    p.add_argument("--M", type=int, default=16)
    p.add_argument("--nq", type=int, default=1000)
    p.add_argument("--k", type=int, default=20)
    p.add_argument("--nprobe", type=int, nargs="+", default=[16, 64])
    p.add_argument("--runs", type=int, default=5)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--methods", nargs="+",
                   default=["none", "roc", "elias-fano"])
    p.add_argument("--out", default="results/search_100m.json")
    args = p.parse_args(argv)

    # byte-path scan: the decoded-f32 payload would not fit HBM at 100M
    os.environ.setdefault("VDBIDC_PQ_DECODE_SCAN", "0")

    import jax

    from .datasets import knn_l2
    from ..search.ivf import IndexIVF
    from ..store.invlists import AVAILABLE_COMPRESSED_IVFS, InvertedLists

    log(f"devices: {jax.devices()}")
    t0 = time.time()
    cent, assignment, xb, xq = build_clustered(
        args.ntotal, args.nlist, args.d, args.nq, args.seed)
    log(f"corpus built in {time.time()-t0:.0f}s "
        f"({xb.nbytes/2**30:.1f} GiB)")

    t0 = time.time()
    gt = knn_l2(xq, xb, 1)
    log(f"exact GT in {time.time()-t0:.0f}s")

    # ---- index: centroids + generator assignment, PQ codes --------------
    index = IndexIVF(args.d, args.nlist, storage="pq", pq_m=args.M)
    index.centroids = cent
    t0 = time.time()
    index.pq.train(xb[:: max(args.ntotal // 1_000_000, 1)][:1_000_000])
    log(f"pq trained in {time.time()-t0:.0f}s")
    t0 = time.time()
    codes = np.empty((args.ntotal, index.pq.code_size), np.uint8)
    C = 4_000_000
    for s in range(0, args.ntotal, C):
        codes[s:min(s + C, args.ntotal)] = index.pq.encode(
            xb[s:min(s + C, args.ntotal)])
    log(f"pq encoded in {time.time()-t0:.0f}s")

    t0 = time.time()
    il = InvertedLists(args.nlist, index.code_size)
    order = np.argsort(assignment, kind="stable")
    bounds = np.searchsorted(assignment[order], np.arange(args.nlist + 1))
    for ln in range(args.nlist):
        members = order[bounds[ln]: bounds[ln + 1]]
        il.add_entries(ln, members.astype(np.uint64),
                       codes[members].reshape(-1))
    index.invlists = il
    index.ntotal = args.ntotal
    log(f"invlists built in {time.time()-t0:.0f}s")
    del codes, xb

    rows = []
    for m in args.methods:
        if m == "none":
            container, ids_size = il, args.ntotal * 8
        else:
            t0 = time.time()
            container = AVAILABLE_COMPRESSED_IVFS[m](il)
            log(f"{m}: compressed in {time.time()-t0:.0f}s, "
                f"{container.compressed_ids_size_in_bytes} bytes")
            ids_size = container.compressed_ids_size_in_bytes
        t0 = time.time()
        index.replace_invlists(container)
        log(f"{m}: scan storage in {time.time()-t0:.0f}s")
        decode_1by1 = getattr(container, "supports_random_access", True)
        for nprobe in args.nprobe:
            index.search_defer_id_decoding(
                xq, args.k, nprobe=nprobe, decode_1by1=decode_1by1)  # warm
            ts, I = [], None
            for _ in range(args.runs):
                t0 = time.time()
                D, I = index.search_defer_id_decoding(
                    xq, args.k, nprobe=nprobe, decode_1by1=decode_1by1)
                ts.append(time.time() - t0)
            r1 = float((I[:, :1] == gt[:, :1]).sum()) / len(xq)
            row = dict(method=m, nprobe=nprobe, k=args.k, nq=args.nq,
                       ntotal=args.ntotal, nlist=args.nlist,
                       t_search=float(np.mean(ts)),
                       t_search_min=float(np.min(ts)), runs=args.runs,
                       ids_size=int(ids_size),
                       bits_per_id=8.0 * ids_size / args.ntotal,
                       recall_1=r1)
            rows.append(row)
            log(f"{m:12s} nprobe={nprobe:3d} "
                f"t={row['t_search']*1e3:8.1f}ms "
                f"min={row['t_search_min']*1e3:8.1f}ms "
                f"bits/id={row['bits_per_id']:6.2f} R@1={r1:.3f}")
            with open(args.out, "w") as f:
                json.dump(rows, f, indent=1)
    print(json.dumps(rows[-1]), flush=True)


if __name__ == "__main__":
    main()

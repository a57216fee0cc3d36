"""Coarse-quantizer study at large nlist: flat matmul vs HNSW graph.

The reference's 1B operating point quantizes 1M centroids through an HNSW
(--quantizer_efSearch 64, /root/reference/README.md:174-176) because CPU
brute force over 1M centroids is prohibitive. This bench measures the same
trade on the device for ``--nlist`` centroids: per-1000-query coarse time for

  - flat: one [nq, d] x [d, nlist] matmul + top-nprobe,
  - hnsw: the graph quantizer (IndexIVF quantizer='hnsw') at several
    efSearch values,

plus the probe-set overlap of hnsw vs the exact flat coarse (the recall
proxy: overlapping probe sets => identical downstream candidates). Writes
one JSON with build time, per-path timings, and overlaps — whatever the
numbers say: on matmul-heavy accelerators brute force may stay competitive
far past the CPU crossover, and the JSON records the measured reality.

    python -m vector_db_id_compression_tpu.bench.quantizer_bench \
        --nlist 262144 --out results/quantizer_262k.json
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--nlist", type=int, default=262144)
    p.add_argument("--d", type=int, default=32)
    p.add_argument("--nq", type=int, default=1000)
    p.add_argument("--nprobe", type=int, default=64)
    p.add_argument("--ef", type=int, nargs="+", default=[64, 128, 256])
    p.add_argument("--M", type=int, default=32)
    p.add_argument("--runs", type=int, default=5)
    p.add_argument("--seed", type=int, default=3)
    p.add_argument("--skip-hnsw", action="store_true",
                   help="flat-matmul point only (the 1M-centroid study: "
                        "a graph build at that scale costs hours on one "
                        "core and the measured question is whether "
                        "the matmul stays cheap — reference 1B config "
                        "README.md:174-176)")
    p.add_argument("--out", default="results/quantizer_262k.json")
    args = p.parse_args(argv)

    import jax

    from ..search.ivf import IndexIVF

    log(f"devices: {jax.devices()}")
    rng = np.random.default_rng(args.seed)
    cents = rng.standard_normal((args.nlist, args.d)).astype(np.float32)
    xq = rng.standard_normal((args.nq, args.d)).astype(np.float32)

    flat = IndexIVF(args.d, args.nlist)
    flat.centroids = cents
    t_build = None
    if not args.skip_hnsw:
        hq = IndexIVF(args.d, args.nlist, quantizer="hnsw",
                      quantizer_M=args.M)
        hq.centroids = cents

        t0 = time.time()
        hq._ensure_quantizer()
        t_build = time.time() - t0
        log(f"hnsw quantizer built over {args.nlist} centroids "
            f"in {t_build:.0f}s")

    def timed(fn):
        fn()  # warm/compile
        ts = []
        for _ in range(args.runs):
            t0 = time.time()
            out = fn()
            ts.append(time.time() - t0)
        return out, float(np.mean(ts)), float(np.min(ts))

    pf, t_flat, t_flat_min = timed(
        lambda: flat.coarse_assign(xq, args.nprobe))
    log(f"flat coarse: {t_flat*1e3:.0f} ms mean / {t_flat_min*1e3:.0f} min "
        f"per {args.nq}q top-{args.nprobe}")

    rows = dict(nlist=args.nlist, d=args.d, nq=args.nq, nprobe=args.nprobe,
                hnsw_M=args.M,
                hnsw_build_s=(round(t_build, 1) if t_build else None),
                flat_ms=round(t_flat * 1e3, 1),
                flat_ms_min=round(t_flat_min * 1e3, 1), hnsw=[])
    for ef in (args.ef if not args.skip_hnsw else []):
        hq.quantizer_efSearch = ef
        ph, t_h, t_h_min = timed(lambda: hq.coarse_assign(xq, args.nprobe))
        overlap = float(np.mean([
            len(np.intersect1d(a[a >= 0], b)) / args.nprobe
            for a, b in zip(ph, pf)]))
        # top-1 agreement: the assignment the add path would use
        top1 = float(np.mean(ph[:, 0] == pf[:, 0]))
        rows["hnsw"].append(dict(
            ef=ef, ms=round(t_h * 1e3, 1), ms_min=round(t_h_min * 1e3, 1),
            probe_overlap=round(overlap, 4), top1_agree=round(top1, 4)))
        log(f"hnsw ef={ef:4d}: {t_h*1e3:.0f} ms mean, overlap "
            f"{overlap:.3f}, top1 agree {top1:.3f}")

    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    print(json.dumps(rows), flush=True)


if __name__ == "__main__":
    main()

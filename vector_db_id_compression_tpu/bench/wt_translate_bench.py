"""Wavelet-tree translate decomposition at the Table-4 shape.

With a wavelet-tree container, the cost of a deferred search over ``none``
is the nshort-per-query 1-by-1 select translate (the reference pays the same
per-result wt.select at custom_invlists_impl.cpp:377-379). This driver
isolates that translate at the exact Table-4 shape — Q = nq x nshort select
queries against a wavelet tree over ``--ntotal`` ids in ``--nlist`` lists —
and decomposes it into:

  - ``select_chip_ms``: the jitted select walk alone, output reduced to a
    scalar on device (pure kernel cost, no transfer);
  - ``e2e_ms``: the container's ``get_single_ids_batch`` end to end
    (label upload + one dispatch + id pull — what the search path pays);
  - ``floor_ms``: a trivial kernel with the same output shape, timed the
    same way (the rig's dispatch+transfer floor for this shape);

so e2e ≈ floor + chip identifies dispatch/transfer-bound vs walk-bound.

    python -m vector_db_id_compression_tpu.bench.wt_translate_bench \
        --ntotal 10000000 --nlist 65536 --wt-type 0 \
        --out results/wt_translate_10m65k.json
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
    p.add_argument("--ntotal", type=int, default=10_000_000)
    p.add_argument("--nlist", type=int, default=65536)
    p.add_argument("--nq", type=int, default=1000)
    p.add_argument("--nshort", type=int, default=200)
    p.add_argument("--wt-type", type=int, default=0, choices=[0, 1])
    p.add_argument("--runs", type=int, default=5)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from .codec_scale import build_workload
    from ..store.invlists import InvertedLists, WaveletTreeInvertedLists

    log(f"devices: {jax.devices()}")
    t0 = time.time()
    ids, lengths, prec = build_workload(args.ntotal, args.nlist, args.seed)
    il = InvertedLists(args.nlist, 0)
    for ln in range(args.nlist):
        il.add_entries(ln, ids[ln, : lengths[ln]], np.zeros(0, np.uint8))
    log(f"workload in {time.time()-t0:.0f}s")
    t0 = time.time()
    cont = WaveletTreeInvertedLists(il, wt_type=args.wt_type)
    log(f"wt built in {time.time()-t0:.0f}s "
        f"({cont.compressed_ids_size_in_bytes} B)")

    # Table-4-shaped labels: nq queries x nshort shortlist entries, each a
    # (list_no, offset) pair drawn over the length distribution
    rng = np.random.default_rng(args.seed + 1)
    Q = args.nq * args.nshort
    lns = rng.integers(0, args.nlist, size=Q)
    nz = lengths[lns] > 0
    lns = np.where(nz, lns, int(np.argmax(lengths)))
    offs = (rng.random(Q) * lengths[lns]).astype(np.int64)

    # e2e: what the deferred-decoding search path pays per translate
    got = cont.get_single_ids_batch(lns, offs)  # warm/compile
    # oracle: the selected id must be the offs-th member of its list
    np.testing.assert_array_equal(got[:64],
                                  ids[lns[:64], offs[:64]].astype(np.uint64))
    ts = []
    for _ in range(args.runs):
        t0 = time.time()
        cont.get_single_ids_batch(lns, offs)
        ts.append(time.time() - t0)
    e2e_s = min(ts)

    # on-chip: same walk, scalar-reduced (tree arrays as ARGUMENTS)
    from ..codecs.wavelet_tree import wt_select, wt_select_rrr

    wt = cont.wt
    n, levels = wt.n, wt.levels
    arrs = tuple(wt)[:-2]
    tab = cont.wt_tables
    sel = wt_select if args.wt_type == 0 else wt_select_rrr

    @jax.jit
    def chip(a, t, sy, of):
        out = sel(type(wt)(*a, n, levels), sy, of, tables=t)
        return out[0] + out[-1] + jnp.sum(out[:: max(Q // 64, 1)])

    sy_j, of_j = jnp.asarray(lns), jnp.asarray(offs)
    np.asarray(chip(arrs, tab, sy_j, of_j))
    ts = []
    for _ in range(args.runs):
        t0 = time.time()
        np.asarray(chip(arrs, tab, sy_j, of_j))
        ts.append(time.time() - t0)
    chip_s = min(ts)

    # dispatch+transfer floor for the e2e output shape (Q int64 ids)
    triv = jax.jit(lambda a: a + jnp.int64(1))
    shp = jnp.zeros(Q, jnp.int64)
    np.asarray(triv(shp))
    ts = []
    for _ in range(args.runs):
        t0 = time.time()
        np.asarray(triv(shp))
        ts.append(time.time() - t0)
    floor_s = min(ts)

    row = {
        "ntotal": args.ntotal, "nlist": args.nlist, "wt_type": args.wt_type,
        "Q": Q, "levels": levels,
        "e2e_ms": round(e2e_s * 1e3, 2),
        "select_chip_ms": round(chip_s * 1e3, 2),
        "floor_ms": round(floor_s * 1e3, 2),
        "per_select_us_chip": round(chip_s / Q * 1e6, 3),
        "per_select_us_e2e": round(e2e_s / Q * 1e6, 3),
    }
    log(f"e2e {row['e2e_ms']} ms | chip {row['select_chip_ms']} ms | "
        f"floor {row['floor_ms']} ms | "
        f"{row['per_select_us_chip']} us/select on-chip")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(row, f, indent=1)
    print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()

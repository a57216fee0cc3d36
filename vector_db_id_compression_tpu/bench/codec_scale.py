"""Codec scale bench: batched ROC encode+decode at reference scale and above.

The reference validates its codec at n=65k ids (test_codec.cpp:54-106) and
runs the full pipeline at 10M-1B ids (README.md:139-197). This driver runs
the *codec layer alone* at arbitrary scale — an IVF-shaped workload of
``--ntotal`` uniform ids over ``--nlist`` lists — and reports:

  - host build (native C++ batch encoder) wall time + stream bits/id,
  - decode of EVERY list by the GPU decode kernel: one-shot latency
    including the id transfer, and the kernel's own time with the ids left
    on the device (median of ``--runs``, synced with block_until_ready).

Long-list routing (``--interleave auto``, the default): the decode kernel's
per-step rank pass is O(i) in the list position, so per-id cost grows
linearly with list length — the wrong direction for 1B ids in 65k lists.
Lists longer than 1.5x ``--chunk-target`` are split into S contiguous
sorted-value chunks via the interleaved-ROC chunk plan
(codecs/roc_interleaved.py: rebasing each chunk to its minimum recovers
~log2 S bits/symbol, cancelling the multiset-splitting loss to first
order), turning one n-step quadratic chain into S independent
(n/S)-length lanes that decode in lockstep. ``--interleave off``
reproduces the strict single-stream reference format.

Very large batches decode in ``--lane-chunk`` lane groups (each group is
one prepared kernel decoder; groups are length-sorted so every group
compiles a tight n_max) — this bounds device memory at 1B-id scale.

Prints one JSON row per invocation (needs a GPU; ``--interpret`` runs the
kernel in Pallas interpret mode on the CPU, for tests):

    python -m vector_db_id_compression_tpu.bench.codec_scale \
        --ntotal 100000000 --nlist 65536
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def build_workload(ntotal: int, nlist: int, seed: int):
    """Uniform IVF-shaped id lists (same generator family as bench.py and
    the reference harness): returns (ids u64[nlist, n_max] ascending-padded,
    lengths i32[nlist], prec i32[nlist])."""
    from ..codecs.roc import precision_for_max_id_safe

    rng = np.random.default_rng(seed)
    assignment = rng.integers(0, nlist, size=ntotal)
    order = np.argsort(assignment, kind="stable")  # members stay ascending
    lengths = np.bincount(assignment, minlength=nlist).astype(np.int32)
    del assignment
    bounds = np.zeros(nlist + 1, dtype=np.int64)
    np.cumsum(lengths, out=bounds[1:])
    n_max = int(lengths.max())
    ids = np.zeros((nlist, n_max), dtype=np.uint64)
    rows = np.repeat(np.arange(nlist, dtype=np.int64), lengths)
    cols = np.arange(ntotal, dtype=np.int64) - bounds[rows]
    ids[rows, cols] = order.astype(np.uint64)
    # per-list max member = last element of each (ascending) group
    prec = np.ones(nlist, dtype=np.int32)
    nz = lengths > 0
    maxs = np.zeros(nlist, dtype=np.int64)
    maxs[nz] = order[bounds[1:][nz] - 1]
    prec[nz] = [precision_for_max_id_safe(int(m)) for m in maxs[nz]]
    return ids, lengths, prec


def build_entries(ids, lengths, prec, mode: str, chunk_target: int):
    """Expand lists into codec lanes ("entries"). ``mode`` 'off': one entry
    per list, reference single-stream format. 'auto': lists longer than
    1.5x chunk_target are cut into S = ceil(n / chunk_target) sorted-value
    chunks (interleaved-ROC chunk plan — shared contract with the
    container, codecs/roc_interleaved.py:chunk_plan).

    Returns (ent_arrays list[u64[]], ent_len i32[E], ent_prec i32[E],
    ent_lo u64[E], ent_list i64[E], ent_bound i64[E] chunk start within the
    list, extra_lanes int)."""
    from ..codecs.roc_interleaved import chunk_plan

    nlist = len(lengths)
    ent_arrays, ent_len, ent_prec, ent_lo, ent_list, ent_bound = \
        [], [], [], [], [], []
    extra = 0
    thresh = int(1.5 * chunk_target)
    for ln in range(nlist):
        n = int(lengths[ln])
        if n == 0:
            continue
        row = ids[ln, :n]
        if mode == "auto" and n > thresh:
            S = -(-n // chunk_target)
            sizes, bnds, lo, pr, rebased = chunk_plan(row, S)
            for s in range(S):
                ent_arrays.append(rebased[s])
                ent_len.append(int(sizes[s]))
                ent_prec.append(int(pr[s]))
                ent_lo.append(lo[s])
                ent_list.append(ln)
                ent_bound.append(int(bnds[s]))
            extra += S - 1
        else:
            ent_arrays.append(row)
            ent_len.append(n)
            ent_prec.append(int(prec[ln]))
            ent_lo.append(np.uint64(0))
            ent_list.append(ln)
            ent_bound.append(0)
    return (ent_arrays, np.asarray(ent_len, np.int32),
            np.asarray(ent_prec, np.int32), np.asarray(ent_lo, np.uint64),
            np.asarray(ent_list, np.int64), np.asarray(ent_bound, np.int64),
            extra)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ntotal", type=int, default=10_000_000)
    p.add_argument("--nlist", type=int, default=8192)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--runs", type=int, default=3)
    p.add_argument("--interleave", choices=["auto", "off"], default="auto",
                   help="auto: chunk lists past 1.5x --chunk-target into "
                        "interleaved lanes; off: strict single-stream "
                        "reference format")
    p.add_argument("--chunk-target", type=int, default=512,
                   help="target chunk length for auto interleaving: per-id "
                        "decode cost is U-shaped in lane length (fixed "
                        "per-step codec cost at the short end, the O(i) "
                        "rank pass at the long end)")
    p.add_argument("--lane-chunk", type=int, default=262144,
                   help="decode at most this many lanes per prepared "
                        "decoder (bounds device memory at 1B scale)")
    p.add_argument("--interpret", action="store_true",
                   help="run the decode kernel in Pallas interpret mode "
                        "(CPU tests); without it the run needs a GPU")
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from .. import native
    from ..codecs import roc_device as rd
    from ..ops import roc_pallas as rp
    from ..ops.route import INTERPRET, XLA, roc_decode_route

    log(f"devices: {jax.devices()}")
    t0 = time.time()
    ids, lengths, prec = build_workload(args.ntotal, args.nlist, args.seed)
    n_max_list = int(lengths.max())
    log(f"workload: ntotal={args.ntotal} nlist={args.nlist} "
        f"n_max={n_max_list} prec_max={int(prec.max())} "
        f"built in {time.time()-t0:.1f}s")

    t0 = time.time()
    (ent_arrays, ent_len, ent_prec, ent_lo, ent_list, ent_bound,
     extra_lanes) = build_entries(
        ids, lengths, prec, args.interleave, args.chunk_target)
    E = len(ent_arrays)
    n_max = int(ent_len.max())
    log(f"entries: {E} lanes (extra from chunking: {extra_lanes}), "
        f"lane n_max={n_max}, planned in {time.time()-t0:.1f}s")

    # ---- host build: native C++ batch encoder (bit-exact with the device
    # encoder — tests/test_native.py) --------------------------------------
    cap = rd.stack_capacity(n_max, int(ent_prec.max()))
    t0 = time.time()
    if native.available():
        heads, stacks, lens, _, mt = native.roc_encode_lists(
            ent_arrays, ent_prec, cap=cap)
        states_np = (heads, stacks, lens, mt.astype(np.int32))
    else:
        pad = np.zeros((E, n_max), np.uint64)
        for e, a in enumerate(ent_arrays):
            pad[e, : len(a)] = a
        st, _ = rd.roc_encode_batch(
            jnp.asarray(pad), jnp.asarray(ent_len), jnp.asarray(ent_prec),
            rd.default_pool(n_max), rd.fresh_states(E, cap),
            rd.n_slices_for(int(ent_prec.max())))
        jax.block_until_ready(st)
        states_np = (np.asarray(st.head), np.asarray(st.stack),
                     np.asarray(st.stack_len),
                     np.asarray(st.mt_ctr).astype(np.int32))
    t_enc_host = time.time() - t0
    heads, stacks, lens_np, mt_np = states_np
    stream_bytes = int(8 * E + 4 * lens_np.astype(np.int64).sum())
    # envelope for chunked lanes: 8B lo + 4B length + 1B precision per
    # EXTRA lane (same accounting as InterleavedRoc.size_bytes)
    env_bytes = 13 * extra_lanes
    bits_per_id = 8.0 * (stream_bytes + env_bytes) / args.ntotal
    log(f"encode (host native={native.available()}): {t_enc_host:.1f}s "
        f"-> {args.ntotal/t_enc_host/1e6:.1f} Mids/s, "
        f"{bits_per_id:.3f} bits/id (envelope {env_bytes} B)")

    # ---- decode kernel, in length-sorted lane groups ----------------------
    route = roc_decode_route(int(ent_prec.max()), interpret=args.interpret)
    if route == XLA:
        p.error("codec_scale measures the decode kernel: run it on a GPU, "
                "or pass --interpret on the CPU")
    interp = route == INTERPRET
    sort_order = np.argsort(-ent_len, kind="stable")
    groups = [sort_order[g: g + args.lane_chunk]
              for g in range(0, E, args.lane_chunk)]

    def build_group(rows):
        st = rd.RocStates(
            head=jnp.asarray(heads[rows]), stack=jnp.asarray(stacks[rows]),
            stack_len=jnp.asarray(lens_np[rows]),
            mt_ctr=jnp.asarray(mt_np[rows]),
            err=jnp.zeros(len(rows), dtype=bool))
        g_nmax = max(int(ent_len[rows].max()), 1)
        return rp.RocPallasDecoder(
            st, ent_len[rows], ent_prec[rows],
            rd.default_pool(g_nmax), g_nmax)

    total_dec_s = 0.0
    total_oneshot_s = 0.0
    rate_largest = None
    for gi, rows in enumerate(groups):
        dec = build_group(rows)
        g_ids = int(ent_len[rows].astype(np.int64).sum())

        # one-shot latency incl. the id transfer to host, and a round-trip
        # spot check on a few lanes (chunk lanes validate against the list
        # slice they cover, rebased by lo)
        ts = []
        for _ in range(args.runs):
            t0 = time.perf_counter()
            got, ok = dec.decode(interpret=interp)
            got = np.asarray(got)
            ts.append(time.perf_counter() - t0)
        assert ok, "decode kernel flagged stack/pool exhaustion"
        total_oneshot_s += float(np.median(ts))
        for r in (0, len(rows) // 2, len(rows) - 1):
            e = int(rows[r])
            n = int(ent_len[e])
            want = ids[ent_list[e],
                       ent_bound[e]: ent_bound[e] + n] - ent_lo[e]
            np.testing.assert_array_equal(
                np.sort(got[r, :n].astype(np.uint64)), np.sort(want))

        # kernel time: the decode program alone, ids left on the device
        def run():
            return rp.run_kernel(dec.buf, dec.head, dec.ptr, dec.lens,
                                 dec.prec, n_max=dec.n_max,
                                 interpret=interp)

        jax.block_until_ready(run())  # compile + warm
        ts = []
        for _ in range(args.runs):
            t0 = time.perf_counter()
            jax.block_until_ready(run())
            ts.append(time.perf_counter() - t0)
        g_s = float(np.median(ts))
        total_dec_s += g_s
        log(f"group {gi}: {len(rows)} lanes, {g_ids} ids, "
            f"n_max={dec.n_max}: {g_s*1e3:.3f} ms "
            f"-> {g_ids/g_s/1e6:.1f} Mids/s")
        if gi == 0:
            rate_largest = g_ids / g_s
        del dec

    dec_rate = args.ntotal / total_dec_s
    log(f"decode kernel ({len(groups)} group(s)): "
        f"{total_dec_s*1e3:.3f} ms -> {dec_rate/1e6:.1f} Mids/s")
    log(f"decode one-shot total (incl. id pulls): {total_oneshot_s*1e3:.3f} "
        f"ms -> {args.ntotal/total_oneshot_s/1e6:.1f} Mids/s")

    print(json.dumps({
        "ntotal": args.ntotal, "nlist": args.nlist, "n_max": n_max_list,
        "interleave": args.interleave, "lanes": E,
        "lane_n_max": n_max,
        "bits_per_id": round(bits_per_id, 4),
        "host_encode_s": round(t_enc_host, 3),
        "decode_oneshot_mids_s": round(
            args.ntotal / total_oneshot_s / 1e6, 2),
        "decode_mids_s": round(dec_rate / 1e6, 2),
        "decode_mids_s_largest_group": (
            round(rate_largest / 1e6, 2) if rate_largest else None),
        "device": {"platform": jax.devices()[0].platform,
                   "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())},
    }), flush=True)


if __name__ == "__main__":
    main()

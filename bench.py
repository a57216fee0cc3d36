#!/usr/bin/env python
"""Headline benchmark: ROC decode throughput of the GPU decode kernel.

Workload: an IVF-shaped id set — ``NLIST`` lists over ``NTOTAL`` distinct ids
(~1k ids/list, 20-bit), the shape of SIFT1M IVF1024 deferred-ID-decoding
translation (SURVEY.md §3.2: decompression is paid once per touched list).
Every list is decoded on the device, in two formats reported side by side:

  - strict: one ROC stream per list (the reference's format);
  - chunked: lists cut into lanes of ~``CHUNK_TARGET`` ids
    (codecs/roc_interleaved.py), at a slightly larger bits/id.

Each time is the median of ``RUNS`` kernel calls, each waited for with
``block_until_ready``.

Baseline: the in-repo native C++ decoder (bit-exact with the reference
codec) on one thread, same workload, same host — the reference's codec has no
intra-list parallelism. ``vs_baseline`` = strict kernel ids/s / baseline.

Needs a GPU. Prints exactly ONE JSON line to stdout; the log goes to stderr.
"""

import json
import sys
import time

NLIST = 1024
NTOTAL = 1 << 20
SEED = 7
CHUNK_TARGET = 128
RUNS = 5


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from vector_db_id_compression_tpu import native
    from vector_db_id_compression_tpu.bench.codec_scale import (
        build_entries, build_workload)
    from vector_db_id_compression_tpu.codecs import roc_device as rd
    from vector_db_id_compression_tpu.ops import roc_pallas as rp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py times the GPU decode kernel; found {dev}")
    if not native.available():
        sys.exit("bench.py needs the native codec (a C++ compiler)")
    log(f"devices: {jax.devices()}")

    ids, lengths, prec = build_workload(NTOTAL, NLIST, SEED)
    result = {}
    for fmt, mode in (("strict", "off"), ("chunked", "auto")):
        (ent_arrays, ent_len, ent_prec, _lo, _list, _bound,
         extra) = build_entries(ids, lengths, prec, mode, CHUNK_TARGET)
        n_max = int(ent_len.max())
        heads, stacks, lens, _, mt = native.roc_encode_lists(
            ent_arrays, ent_prec,
            cap=rd.stack_capacity(n_max, int(ent_prec.max())))
        bits = 8.0 * (8 * len(ent_len) + 4 * int(lens.sum())
                      + 13 * extra) / NTOTAL
        states = rd.RocStates(
            head=jnp.asarray(heads), stack=jnp.asarray(stacks),
            stack_len=jnp.asarray(lens),
            mt_ctr=jnp.asarray(mt.astype(np.int32)),
            err=jnp.zeros(len(ent_len), dtype=bool))
        dec = rp.RocPallasDecoder(states, ent_len, ent_prec,
                                  rd.default_pool(n_max), n_max)
        got, ok = dec.decode()
        assert ok, "decode kernel flagged stack/pool exhaustion"
        got = np.asarray(got)
        want = native.roc_decode_lists(heads, stacks, lens, ent_len,
                                       ent_prec)
        for e in range(len(ent_len)):
            np.testing.assert_array_equal(
                got[e, : ent_len[e]].astype(np.uint64), want[e])

        def run():
            return rp.run_kernel(dec.buf, dec.head, dec.ptr, dec.lens,
                                 dec.prec, n_max=n_max)

        jax.block_until_ready(run())
        ts = []
        for _ in range(RUNS):
            t0 = time.perf_counter()
            jax.block_until_ready(run())
            ts.append(time.perf_counter() - t0)
        secs = float(np.median(ts))
        log(f"{fmt}: {len(ent_len)} lanes, {bits:.3f} bits/id, kernel "
            f"{secs*1e3:.3f} ms -> {NTOTAL/secs/1e6:.2f} Mids/s "
            f"(runs: {', '.join(f'{t*1e3:.3f}' for t in ts)} ms)")
        result[fmt] = (NTOTAL / secs, bits)
        if fmt == "strict":
            t0 = time.perf_counter()
            native.roc_decode_lists(heads, stacks, lens, ent_len, ent_prec,
                                    n_threads=1)
            base = NTOTAL / (time.perf_counter() - t0)
            log(f"native C++ decoder, one thread: {base/1e6:.2f} Mids/s")

    rate, bits = result["strict"]
    print(json.dumps({
        "metric": "roc_decode_throughput",
        "value": round(rate / 1e6, 3),
        "unit": "Mids/s",
        "vs_baseline": round(rate / base, 3),
        "bits_per_id": round(bits, 3),
        "chunked_mids_s": round(result["chunked"][0] / 1e6, 3),
        "chunked_bits_per_id": round(result["chunked"][1], 3),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()

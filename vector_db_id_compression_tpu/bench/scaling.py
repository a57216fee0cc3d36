"""Multi-device scaling bench — the BASELINE.md "≥80% N-device scaling
efficiency" metric.

The reference's only parallelism is OpenMP over lists on one CPU
(custom_invlists_impl.cpp:147); its scaling story stops at one socket. Here
the unit of parallelism is the same — the inverted list — sharded over a
'lists' device mesh (SURVEY.md §2.4). Because each list's ANS chain is
strictly sequential (codec.cpp:140-152 — the state threads through every
element), wall time is set by the number of *scan steps* (max list length),
not the lane count: lanes ride the vector units for ~free. Sharding
therefore buys *throughput*, not latency, and the meaningful experiment is
**weak scaling**: N devices process N× the lists in the time one device
takes for its share,

  efficiency(N) = T(1 device, B lists) / T(N devices, N*B lists)

reported for sharded ROC encode and decode (parallel.mesh), plus a
device-count-invariance assert on the N-device artifact (the §2.4
determinism contract). On GPUs each shard is a separate card and the
collectives go to NCCL; run under JAX_PLATFORMS=cpu, the mesh is the virtual
N-device CPU mesh (XLA_FLAGS=--xla_force_host_platform_device_count), whose
"devices" share one socket's cores and thread pool — measured efficiencies
are a LOWER bound on separate-chip hardware (shards contend for the same
ALUs here and would not on a pod). Run under JAX_PLATFORMS=cpu.

    python -m vector_db_id_compression_tpu.bench.scaling \
        --lists-per-device 256 --ids-per-list 500 \
        >> results/scaling_cpu_mesh.json
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


def _sync(x):
    import jax

    return np.asarray(jax.tree_util.tree_leaves(x)[0])


def _time(fn, runs: int) -> float:
    fn()  # compile + warm
    ts = []
    for _ in range(runs):
        t0 = time.time()
        _sync(fn())
        ts.append(time.time() - t0)
    return min(ts)


def make_lists(n_lists: int, ids_per_list: int, seed: int):
    """IVF-shaped workload: ``n_lists`` lists of ~``ids_per_list`` uniform
    ids each (every list drawn over its own dense id range so per-list
    precision is constant across scales)."""
    from ..codecs.roc import precision_for_max_id_safe

    # per-list generators so list ln's content is independent of n_lists —
    # the weak-scaling runs then share their leading lists across mesh sizes
    # and the determinism assert can compare shard-0 artifacts directly
    id_range = ids_per_list * 16
    n_max_bound = int(ids_per_list * 1.1) + 1
    lengths = np.empty(n_lists, dtype=np.int32)
    members_all = []
    for ln in range(n_lists):
        r = np.random.default_rng(seed * 1_000_003 + ln)
        m = int(r.integers(int(ids_per_list * 0.9), n_max_bound))
        members_all.append(
            np.sort(r.choice(id_range, size=m, replace=False)
                    ).astype(np.uint64))
        lengths[ln] = m
    n_max = int(lengths.max())
    ids = np.zeros((n_lists, n_max), dtype=np.uint64)
    prec = np.ones(n_lists, dtype=np.int32)
    for ln, members in enumerate(members_all):
        ids[ln, : len(members)] = members
        prec[ln] = precision_for_max_id_safe(int(members[-1]))
    return ids, lengths, prec, int(lengths.sum())


def run(lists_per_device: int, ids_per_list: int, seed: int, runs: int,
        device_counts):
    import jax
    import jax.numpy as jnp

    from ..codecs import roc_device as rd
    from ..parallel.mesh import (
        make_lists_mesh,
        sharded_roc_decode,
        sharded_roc_encode,
    )

    n_dev = len(jax.devices())
    device_counts = [n for n in device_counts if n <= n_dev]
    log(f"devices: {n_dev} x {jax.devices()[0].platform}; "
        f"meshes {device_counts}; {lists_per_device} lists/device x "
        f"~{ids_per_list} ids/list")

    rows = []
    base_t = {}
    shard0 = None  # 1-device artifact of the first shard's lists
    for N in device_counts:
        B = lists_per_device * N
        ids, lengths, prec, ntotal = make_lists(B, ids_per_list, seed)
        cap = rd.stack_capacity(int(lengths.max()), int(prec.max()))
        n_max = ids.shape[1]
        mesh = make_lists_mesh(N)
        ids_j, len_j = jnp.asarray(ids), jnp.asarray(lengths)
        prec_j = jnp.asarray(prec)

        def enc():
            st, _ = sharded_roc_encode(mesh, ids_j, len_j, prec_j, cap)
            return st

        t_enc = _time(enc, runs)
        states = enc()

        # determinism: every mesh size encodes shard-0's lists (the first
        # lists_per_device rows, identical across scales by construction of
        # make_lists) to the same streams as the 1-device mesh
        head0 = np.asarray(states.head)[:lists_per_device]
        slen0 = np.asarray(states.stack_len)[:lists_per_device]
        if shard0 is None:
            shard0 = (head0, slen0)
        else:
            np.testing.assert_array_equal(head0, shard0[0])
            np.testing.assert_array_equal(slen0, shard0[1])

        def dec():
            return sharded_roc_decode(mesh, states, len_j, prec_j, n_max)

        t_dec = _time(dec, runs)

        row = {"n_devices": N, "n_lists": B, "ntotal": ntotal,
               "encode_s": round(t_enc, 4), "decode_s": round(t_dec, 4),
               "encode_mids_s": round(ntotal / t_enc / 1e6, 3),
               "decode_mids_s": round(ntotal / t_dec / 1e6, 3)}
        if not base_t:
            base_t = dict(row)
            if N != 1:
                log(f"warning: efficiency baseline is N={N}, not 1 "
                    "(pass --devices starting at 1 for T(1)/T(N))")
        row["eff_vs"] = base_t["n_devices"]  # baseline N the effs divide by
        for key in ("encode", "decode"):
            row[f"{key}_eff"] = round(base_t[f"{key}_s"] / row[f"{key}_s"], 3)
        rows.append(row)
        log(f"N={N}: {B:5d} lists  encode {t_enc*1e3:7.1f} ms "
            f"({row['encode_mids_s']:7.2f} Mids/s, eff {row['encode_eff']:.2f})"
            f"  decode {t_dec*1e3:7.1f} ms "
            f"({row['decode_mids_s']:7.2f} Mids/s, eff {row['decode_eff']:.2f})")
    return rows


def run_search(lists_per_device: int, ids_per_list: int, d: int, nq: int,
               k: int, nprobe: int, seed: int, runs: int, device_counts,
               method: str = "roc", phases: bool = False):
    """Weak-scale the SHARDED SEARCH program (parallel.search.ShardedIVF):
    the database grows N× with the mesh (lists_per_device lists per shard,
    so per-device coarse matmul and per-device translate lanes are
    invariant by construction), queries stay fixed — ideal weak scaling
    keeps query latency ~flat while capacity grows N×. Also asserts the
    §2.4 device-count-invariance contract at every scale: the N-device
    mesh returns the same (D, I) as a 1-device mesh over the SAME
    N-scale database."""
    import jax
    import jax.numpy as jnp  # noqa: F401  (device warmup)
    from jax.sharding import Mesh

    from ..parallel.search import ShardedIVF
    from ..search.ivf import IndexIVF
    from ..store.invlists import AVAILABLE_COMPRESSED_IVFS

    n_dev = len(jax.devices())
    device_counts = [n for n in device_counts if n <= n_dev]
    rng = np.random.default_rng(seed)
    rows = []
    base_t = {}
    for N in device_counts:
        nlist = lists_per_device * N
        nb = nlist * ids_per_list
        xb = rng.standard_normal((nb, d)).astype(np.float32)
        xq = rng.standard_normal((nq, d)).astype(np.float32)
        index = IndexIVF(d, nlist)
        index.train(xb[: min(nb, 20 * nlist)], niter=2)
        index.add(xb)
        cont = (index.invlists if method == "ref"
                else AVAILABLE_COMPRESSED_IVFS[method](index.invlists))
        if method != "ref":
            index.replace_invlists(cont)
        mesh = Mesh(np.array(jax.devices()[:N]), axis_names=("lists",))
        sh = ShardedIVF(mesh, index, cont)

        def q():
            return sh.search(xq, k, nprobe)

        t = _time(lambda: q()[1], runs)
        D, I = q()
        # device-count invariance on the same database
        mesh1 = Mesh(np.array(jax.devices()[:1]), axis_names=("lists",))
        D1, I1 = ShardedIVF(mesh1, index, cont).search(xq, k, nprobe)
        np.testing.assert_array_equal(I, I1)
        np.testing.assert_allclose(D, D1, rtol=1e-5, atol=1e-5)

        row = {"n_devices": N, "nlist": nlist, "ntotal": nb,
               "search_s": round(t, 4),
               "qps": round(nq / t, 1)}

        if phases:
            # cumulative staged programs (VDBIDC_ABLATE_STAGE in
            # parallel.search._build) differenced into per-phase costs;
            # each stage is a fresh compile, so clear the program cache
            cum = {}
            for stage in ("coarse", "scan", "merge"):
                os.environ["VDBIDC_ABLATE_STAGE"] = stage
                sh._compiled.clear()
                cum[stage] = _time(lambda: q()[1], runs)
            os.environ.pop("VDBIDC_ABLATE_STAGE", None)
            sh._compiled.clear()
            cum["full"] = _time(lambda: q()[1], runs)
            row["phase_cum_s"] = {s: round(v, 4) for s, v in cum.items()}
            row["phase_s"] = {
                "coarse": round(cum["coarse"], 4),
                "scan": round(cum["scan"] - cum["coarse"], 4),
                "merge": round(cum["merge"] - cum["scan"], 4),
                "translate": round(cum["full"] - cum["merge"], 4)}
            log(f"    phases (cumulative-diff): {row['phase_s']}")

        if not base_t:
            base_t = dict(row)
        row["eff_vs"] = base_t["n_devices"]
        row["search_eff"] = round(base_t["search_s"] / row["search_s"], 3)
        rows.append(row)
        log(f"N={N}: ntotal={nb:7d}  search {t*1e3:7.1f} ms "
            f"({row['qps']:8.1f} q/s, eff {row['search_eff']:.2f}) "
            f"[N-dev == 1-dev checked]")
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--lists-per-device", type=int, default=256)
    p.add_argument("--ids-per-list", type=int, default=500)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--runs", type=int, default=3)
    p.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    p.add_argument("--search", action="store_true",
                   help="weak-scale the sharded search program instead of "
                        "the codec (smaller defaults: see --search-*)")
    p.add_argument("--search-method", default="roc")
    p.add_argument("--search-d", type=int, default=16)
    p.add_argument("--search-nq", type=int, default=64)
    p.add_argument("--search-k", type=int, default=10)
    p.add_argument("--search-nprobe", type=int, default=8)
    p.add_argument("--phases", action="store_true",
                   help="with --search: time the staged programs "
                        "(coarse/scan/merge/translate) per mesh size")
    args = p.parse_args(argv)

    if args.search:
        rows = run_search(
            min(args.lists_per_device, 64), min(args.ids_per_list, 200),
            args.search_d, args.search_nq, args.search_k,
            args.search_nprobe, args.seed, args.runs, args.devices,
            method=args.search_method, phases=args.phases)
        print(json.dumps({
            "platform": os.environ.get("JAX_PLATFORMS", "default"),
            "host_cores": os.cpu_count(),
            "mode": "weak_scaling_search",
            "method": args.search_method,
            "note": ("database grows Nx with the mesh; ideal weak scaling "
                     "keeps latency flat. Virtual CPU devices share one "
                     "host's cores — efficiencies are a lower bound on "
                     "separate-chip hardware."),
            "rows": rows,
        }), flush=True)
        return

    rows = run(args.lists_per_device, args.ids_per_list, args.seed,
               args.runs, args.devices)
    print(json.dumps({
        "platform": os.environ.get("JAX_PLATFORMS", "default"),
        # virtual CPU devices share the host's cores: with host_cores == 1
        # every shard contends for ONE core's ALUs and the efficiencies
        # measure SIMD-width headroom, not device scaling (see module doc)
        "host_cores": os.cpu_count(),
        "mode": "weak_scaling",
        "lists_per_device": args.lists_per_device,
        "ids_per_list": args.ids_per_list, "rows": rows,
    }), flush=True)


if __name__ == "__main__":
    main()

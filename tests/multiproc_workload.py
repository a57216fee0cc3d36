"""Shared deterministic workload for the multi-process tests: every process
(and the single-process oracle) builds bit-identical inputs from fixed
seeds."""

import numpy as np


def build_workload():
    rng = np.random.default_rng(42)
    B, n_max = 64, 48  # codec lanes (divisible by 8 devices)
    lengths = rng.integers(1, n_max + 1, size=B).astype(np.int32)
    sorted_ids = np.zeros((B, n_max), dtype=np.uint64)
    prec = np.zeros(B, dtype=np.int32)
    for b in range(B):
        v = np.sort(rng.choice(1 << 16, size=lengths[b], replace=False))
        sorted_ids[b, : lengths[b]] = v
        prec[b] = max(int(v.max()).bit_length(), 1)

    d, nb, nq, nlist = 8, 1500, 24, 16
    xb = rng.standard_normal((nb, d)).astype(np.float32)
    xq = xb[rng.integers(0, nb, nq)] + 0.01 * rng.standard_normal(
        (nq, d)).astype(np.float32)

    def make_index():
        from vector_db_id_compression_tpu.search.ivf import IndexIVF
        from vector_db_id_compression_tpu.store.invlists import (
            RocInvertedLists,
        )

        index = IndexIVF(d, nlist)
        index.train(xb[:1000], niter=6)
        index.add(xb)
        container = RocInvertedLists(index.invlists)
        return index, container

    def make_index_pl():
        """200 lists (25/shard on an 8-device mesh: the kernel wrapper pads
        the lanes) for the roc_pl kernel translate in interpret mode — each
        process builds kernel lane buffers for ITS rows only."""
        from vector_db_id_compression_tpu.search.ivf import IndexIVF
        from vector_db_id_compression_tpu.store.invlists import (
            RocInvertedLists,
        )

        r2 = np.random.default_rng(7)
        xb2 = r2.standard_normal((6000, d)).astype(np.float32)
        xq2 = xb2[r2.integers(0, len(xb2), 12)] + 0.01 * r2.standard_normal(
            (12, d)).astype(np.float32)
        index = IndexIVF(d, 200)
        index.train(xb2[:4000], niter=3)
        index.add(xb2)
        return index, RocInvertedLists(index.invlists), xq2

    return dict(sorted_ids=sorted_ids, lengths=lengths, prec=prec,
                n_max=n_max, xq=xq, make_index=make_index,
                make_index_pl=make_index_pl)

"""Smoke tests for the experiment drivers (bench/): each runs end-to-end on a
tiny dataset, produces its CSV/file artifacts, and reports sane numbers."""

import csv

import numpy as np
import pytest

from vector_db_id_compression_tpu.bench.bench_invlists import run_bench as ivf_bench
from vector_db_id_compression_tpu.bench.datasets import (
    SyntheticDataset,
    get_dataset,
    knn_l2,
)
from vector_db_id_compression_tpu.bench.generate_graph_edgelists import run as gen_el
from vector_db_id_compression_tpu.bench.graph_dynamic_bench import (
    run_bench as graph_bench,
)
from vector_db_id_compression_tpu.bench.graph_static_bench import (
    run_bench as static_bench,
)


@pytest.fixture(scope="module")
def tiny():
    return SyntheticDataset(8, 500, 1500, 30)


def test_synthetic_groundtruth(tiny):
    gt = tiny.get_groundtruth(5)
    xb, xq = tiny.get_database(), tiny.get_queries()
    d0 = ((xb[gt[0, 0]] - xq[0]) ** 2).sum()
    d_all = ((xb - xq[0]) ** 2).sum(1)
    assert d0 == d_all.min()
    assert gt.shape == (30, 5)


def test_get_dataset_table():
    ds = get_dataset(0)
    assert type(ds).__name__ == "SyntheticDataset"
    with pytest.raises((FileNotFoundError, ValueError)):
        get_dataset("nope")


def test_ivf_bench(tiny, tmp_path):
    out = tmp_path / "ivf.csv"
    rows = ivf_bench(tiny, "IVF8,Flat", runs=1, nprobes=(1,),
                     methods=["ref", "roc"], out_csv=str(out))
    assert len(rows) == 2
    with open(out) as f:
        got = list(csv.DictReader(f))
    assert {r["method"] for r in got} == {"ref", "roc"}
    ref, roc = (next(r for r in got if r["method"] == m) for m in ("ref", "roc"))
    assert ref["recall_1"] == roc["recall_1"]  # lossless ids
    assert float(roc["bits_per_id"]) < float(ref["bits_per_id"])


def test_graph_dynamic_bench(tiny, tmp_path):
    out = tmp_path / "g.csv"
    rows = graph_bench(tiny, 8, runs=1, k=5,
                       methods=["ref", "compact", "roc"], out_csv=str(out))
    recalls = {r["method"]: r["recall_1"] for r in rows}
    assert recalls["ref"] == recalls["compact"] == recalls["roc"]
    bpe = {r["method"]: r["bits_per_edge"] for r in rows}
    assert bpe["compact"] < bpe["ref"]


def test_graph_static_bench(tiny, tmp_path):
    out = tmp_path / "s.csv"
    rows = static_bench(tiny, 8, out_csv=str(out))
    index_strs = {r["index_str"] for r in rows}
    assert index_strs == {"NSG8,Flat", "HNSW8,Flat"}
    rec_rows = [r for r in rows if r["comp_method"] == "rec"]
    assert len(rec_rows) == 2
    for r in rec_rows:
        assert 0 < r["bpe"] < 2 * np.log2(tiny.nb)


def test_generate_edgelists(tiny, tmp_path):
    gen_el(tiny, 8, str(tmp_path / "el"))
    files = sorted((tmp_path / "el").glob("*.el"))
    assert len(files) == 2
    line = files[0].read_text().splitlines()[0].split()
    assert len(line) == 2 and all(t.isdigit() for t in line)


def test_hnsw_bench(tiny, tmp_path):
    from vector_db_id_compression_tpu.bench.hnsw_bench import (
        run_bench as hnsw_bench,
    )

    out = tmp_path / "hnsw.csv"
    rows = hnsw_bench(tiny, M=8, runs=1, k=5, ef=24, out_csv=str(out))
    assert {r["method"] for r in rows} == {"ref", "compact", "elias-fano",
                                           "roc", "roc-block"}
    # lossless adjacency: identical recall across containers
    recalls = {r["recall_1"] for r in rows}
    assert len(recalls) == 1
    for r in rows:
        if r["method"] != "ref":
            assert r["bits_per_edge"] < 32.0
    with open(out) as f:
        assert len(list(csv.DictReader(f))) == len(rows)


def test_codec_scale_driver(capsys):
    """codec_scale runs end-to-end at tiny scale on the CPU (decode kernel
    in interpret mode) and reports a correct round-trip + sane JSON row."""
    import json

    from vector_db_id_compression_tpu.bench.codec_scale import main as scale

    scale(["--ntotal", "3000", "--nlist", "16", "--runs", "1",
           "--interpret"])
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["ntotal"] == 3000 and row["nlist"] == 16
    # ~log2(ntotal) - log2(n/nlist!)/n + state overhead; sane band
    assert 2.0 < row["bits_per_id"] < 16.0
    assert row["decode_mids_s"] > 0
    assert row["lanes"] == 16  # 187-id lists stay under the 512 target


def test_codec_scale_interleave_routing(capsys):
    """Long lists route through the interleaved chunk plan (extra lanes,
    round-trip still validated in-driver) and multi-group decode works."""
    import json

    from vector_db_id_compression_tpu.bench.codec_scale import main as scale

    scale(["--ntotal", "3000", "--nlist", "4", "--runs", "1",
           "--chunk-target", "128", "--lane-chunk", "8",
           "--interpret"])
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["lanes"] > 4 and row["lane_n_max"] <= 2 * 128
    assert row["decode_mids_s"] > 0


def test_scaling_search_phases(capsys):
    """The staged-ablation programs (coarse/scan/merge/full) compile and
    run; cumulative diffs are reported per mesh size."""
    import json

    from vector_db_id_compression_tpu.bench.scaling import run_search

    rows = run_search(lists_per_device=8, ids_per_list=20, d=8, nq=8, k=4,
                      nprobe=4, seed=3, runs=1, device_counts=[1, 2],
                      method="roc", phases=True)
    assert len(rows) == 2
    for r in rows:
        assert set(r["phase_s"]) == {"coarse", "scan", "merge", "translate"}
        assert r["phase_cum_s"]["full"] > 0


def test_wt_translate_bench(capsys):
    """WT translate microbench runs at tiny scale and validates its oracle
    (selected id == the offset-th member of the list)."""
    import json

    from vector_db_id_compression_tpu.bench.wt_translate_bench import main

    main(["--ntotal", "4000", "--nlist", "32", "--nq", "16",
          "--nshort", "8", "--runs", "1"])
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["Q"] == 128 and row["e2e_ms"] > 0

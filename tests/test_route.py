"""The one ROC decode route helper (ops.route), the failure contract around
the kernel (a compile error raises, nothing falls back), and the compile
cache choice made at package import."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import vector_db_id_compression_tpu as pkg
from vector_db_id_compression_tpu.ops import route

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("platform,interpret,max_precision,expect", [
    ("gpu", False, 20, route.KERNEL),
    ("gpu", False, 32, route.KERNEL),
    ("gpu", False, 33, route.XLA),          # past the kernel's envelope
    ("cpu", False, 20, route.XLA),
    ("cpu", True, 20, route.INTERPRET),     # only when asked by argument
    ("cpu", True, 40, route.XLA),
    ("rocm-unknown", False, 20, route.XLA),  # any other backend: plain XLA
])
def test_roc_decode_route(platform, interpret, max_precision, expect):
    assert route.roc_decode_route(max_precision, platform=platform,
                                  interpret=interpret) == expect


def test_route_default_platform_is_the_backend():
    # the tests run with JAX_PLATFORMS=cpu
    assert route.roc_decode_route(20) == route.XLA


def _roc_container():
    from vector_db_id_compression_tpu.store.invlists import (
        InvertedLists, RocInvertedLists)

    rng = np.random.default_rng(3)
    il = InvertedLists(3, 1)
    ids = rng.permutation(60).astype(np.uint64)
    for ln in range(3):
        il.add_entries(ln, np.sort(ids[ln * 20:(ln + 1) * 20]))
    return RocInvertedLists(il)


def _decode_lists(monkeypatch):
    monkeypatch.setattr(route, "roc_decode_route",
                        lambda *a, **k: route.KERNEL)
    _roc_container().decode_lists(np.array([0, 2]))


def _decode_select(monkeypatch):
    monkeypatch.setattr(route, "roc_decode_route",
                        lambda *a, **k: route.KERNEL)
    _roc_container().decode_select(np.array([0, 1]), np.array([3, 4]))


def _graph_fetch(monkeypatch):
    from vector_db_id_compression_tpu.search.graph_device import roc_provider
    from vector_db_id_compression_tpu.store.graph import Graph, RocGraph

    monkeypatch.setattr(route, "roc_decode_route",
                        lambda *a, **k: route.KERNEL)
    adj = np.array([[1, 2, -1], [0, 2, -1], [0, 1, -1]], np.int32)
    roc_provider(RocGraph(Graph(adj)))


@pytest.mark.parametrize("entry", [_decode_lists, _decode_select,
                                   _graph_fetch])
def test_kernel_compile_failure_raises(monkeypatch, entry):
    """Forcing the GPU kernel route where the kernel cannot compile (the CPU
    backend has no Triton) must raise out of the entry point — no caller
    turns the failure into the XLA path."""
    with pytest.raises(ValueError, match="interpret mode"):
        entry(monkeypatch)


@pytest.mark.parametrize("env_dir", [None, "set"])
def test_compile_cache_dir(monkeypatch, tmp_path, env_dir):
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert pkg.compile_cache_dir() == str(REPO / ".jax_cache")
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert pkg.compile_cache_dir() is None


@pytest.mark.parametrize("env_dir", [None, "set"])
def test_compile_cache_dir_at_import(tmp_path, env_dir):
    """What a fresh process ends up with: the env var's directory when set,
    else <repo root>/.jax_cache."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    want = str(REPO / ".jax_cache")
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = want = str(tmp_path)
    out = subprocess.run(
        [sys.executable, "-c",
         "import vector_db_id_compression_tpu, jax; "
         "print(jax.config.jax_compilation_cache_dir)"],
        env=env, capture_output=True, text=True, check=True, cwd=tmp_path)
    assert out.stdout.strip().splitlines()[-1] == want

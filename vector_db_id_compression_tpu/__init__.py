"""vector_db_id_compression_tpu — lossless compression of vector IDs for
approximate nearest neighbor search, in JAX, with a Pallas decode kernel for
the GPU.

A from-scratch JAX/XLA/Pallas framework with the capabilities of
facebookresearch/vector_db_id_compression (the reference implementation of
"Lossless Compression of Vector IDs for Approximate Nearest Neighbor Search",
arXiv:2501.10479): lossless codecs for the identifiers stored in ANN index
structures — per-cluster ID lists of IVF indices and adjacency lists of graph
indices — integrated into the search path with deferred ID decoding.

Codecs (reference parity, see each module's docstring for file:line cites):
  - ROC / bits-back rANS multiset coding   (codecs.roc)
  - Elias-Fano monotone sequences          (codecs.elias_fano)
  - Wavelet tree over cluster assignments  (codecs.wavelet_tree)
  - Packed fixed-width bits                (codecs.packed_bits)

Unlike the reference (single-node CPU + OpenMP), compute here is expressed as
batched, static-shape JAX programs: lists are lanes, the sequential ANS chain
is a `lax.scan`, order statistics are dense vector ops, and multi-chip scaling
is `jax.sharding.Mesh` + `shard_map` data parallelism over lists.

64-bit integer arithmetic is required for the rANS head; we enable jax x64
mode at import. All public entry points work on the CPU and GPU backends.
"""

import os as _os
from pathlib import Path as _Path

import jax as _jax

_jax.config.update("jax_enable_x64", True)


def compile_cache_dir():
    """The persistent compile cache this package sets up: None when
    ``JAX_COMPILATION_CACHE_DIR`` is set (JAX then uses that directory and
    nothing here overrides it), else the fixed ``<repo root>/.jax_cache``.
    A fixed path lets every process and every run find what an earlier one
    compiled."""
    if _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return str(_Path(__file__).resolve().parent.parent / ".jax_cache")


if compile_cache_dir() is not None:
    _jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
_jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)

__version__ = "0.1.0"

"""Interleaved ROC — S-lane parallel coding of ONE long ID list.

The reference decodes a list strictly sequentially (the ANS state threads
through every element: codec.cpp:140-152); a 100k-element list is a 100k-step
chain. This framework extension splits a list into S independent streams that
encode/decode in lockstep across lanes (canonical interleaved-rANS idea,
Giesen arXiv:1402.3392, applied per-list):

  1. sort the ids; cut into S *contiguous chunks* of near-equal size — the
     partition is a pure function of the multiset + chunk sizes, so it costs
     no side information beyond the S chunk minima;
  2. rebase each chunk to its minimum and code it with per-chunk precision
     ceil(log2(max - lo + 1)). With ids spread over [0, 2^p), each chunk's
     range is ~2^p/S, so the per-symbol saving ~log2(S) cancels (to first
     order, by Stirling) the bits-back loss of coding S small multisets
     instead of one big one:  n·p − n·log2 S − Σ log2(n_s!)  ≈  n·p − log2 n!.
  3. each chunk is an ordinary ROC stream (bit-exact with the single-stream
     format at S=1 and lo=0) — the S>1 container format is a framework
     envelope: per-lane (head, stack, lo, n_s, prec).

Decode runs all S chains concurrently in one `roc_decode_batch` call (or S
lanes of the Pallas kernel), giving ~S× the per-list decode throughput.

Decoded output order = lane-concatenated sampling order; `encode` returns the
matching global permutation so payload codes can be co-reordered exactly like
the single-stream container does (custom_invlists_impl.cpp:188-193).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import roc_device as rd
from .roc import precision_for_max_id_safe


class InterleavedRoc(NamedTuple):
    """Envelope for one list coded as S lanes."""

    states: rd.RocStates   # S-lane batch
    lane_lengths: np.ndarray  # i32[S]
    lane_lo: np.ndarray       # u64[S] chunk minima (subtracted before coding)
    lane_prec: np.ndarray     # i32[S] per-chunk symbol precision

    @property
    def n(self) -> int:
        return int(self.lane_lengths.sum())

    @property
    def size_bytes(self) -> int:
        """Stream bytes + envelope accounting: per lane 8B head + 4B/stack
        word (reference codec.h:42-44) + 8B lo + 4B length + 1B precision."""
        stream = int(np.asarray(self.states.size_bytes).sum())
        return stream + len(self.lane_lengths) * (8 + 4 + 1)


def partition_sizes(n: int, S: int) -> np.ndarray:
    """Near-equal chunk sizes, deterministic (first n % S chunks get +1)."""
    base = n // S
    sizes = np.full(S, base, dtype=np.int64)
    sizes[: n % S] += 1
    return sizes


def chunk_plan(sorted_ids: np.ndarray, S: int):
    """Shared chunk planning for S-lane interleaving — ONE definition of the
    (sizes, minima, rebase, precision) contract, used by both the standalone
    codec below and the container (store.invlists
    InterleavedRocInvertedLists), so their stream formats can never drift.

    Returns (sizes i64[S], bounds i64[S+1], lo u64[S], prec i32[S],
    rebased list[S] of u64 chunks)."""
    sorted_ids = np.asarray(sorted_ids, dtype=np.uint64)
    sizes = partition_sizes(len(sorted_ids), S)
    bounds = np.zeros(S + 1, dtype=np.int64)
    np.cumsum(sizes, out=bounds[1:])
    lo = np.zeros(S, dtype=np.uint64)
    prec = np.zeros(S, dtype=np.int32)
    rebased = []
    for s in range(S):
        chunk = sorted_ids[bounds[s]: bounds[s + 1]]
        lo[s] = chunk[0] if len(chunk) else np.uint64(0)
        rb = chunk - lo[s]
        prec[s] = (precision_for_max_id_safe(int(rb[-1]))
                   if len(chunk) > 1 else 1)
        rebased.append(rb)
    return sizes, bounds, lo, prec, rebased


def interleaved_encode(
    ids: np.ndarray, S: int
) -> Tuple[InterleavedRoc, np.ndarray]:
    """Encode distinct u64 ``ids`` as S lanes. Returns (envelope, order):
    ``order[i]`` is the original index of the element at decoded position i
    (lane-concatenated decode order)."""
    ids = np.asarray(ids, dtype=np.uint64)
    n = len(ids)
    assert n >= S >= 1, (n, S)
    sort_perm = np.argsort(ids, kind="stable")
    sorted_ids = ids[sort_perm]
    sizes, bounds, lo, prec, rebased = chunk_plan(sorted_ids, S)

    # the S rebased chunks go through the SAME ragged front door as the
    # containers (native C++ / Pallas / XLA scan — codecs/roc_device.py
    # encode_ragged), so the standalone codec and
    # InterleavedRocInvertedLists can never drift in stream format
    n_max = int(sizes.max())
    cap = rd.stack_capacity(n_max, int(prec.max()))
    states, orders = rd.encode_ragged(rebased, prec, n_max, cap)
    # lane-local sampling order (over the sorted chunk) → original index
    global_order = np.concatenate([
        sort_perm[bounds[s] + orders[s]] for s in range(S)
    ])
    env = InterleavedRoc(states, sizes.astype(np.int32), lo, prec)
    return env, global_order


def interleaved_decode(env: InterleavedRoc) -> np.ndarray:
    """Decode all S lanes in lockstep; returns ids in lane-concatenated
    sampling order (matching ``interleaved_encode``'s returned permutation)."""
    S = len(env.lane_lengths)
    n_max = int(env.lane_lengths.max())
    pool = rd.default_pool(n_max)
    ids, _ = rd.roc_decode_batch(
        env.states,
        jnp.asarray(env.lane_lengths),
        jnp.asarray(env.lane_prec),
        pool,
        n_max,
        rd.n_slices_for(int(env.lane_prec.max())),
    )
    ids_np = np.asarray(ids)
    out = np.concatenate([
        ids_np[s, : int(env.lane_lengths[s])] + env.lane_lo[s]
        for s in range(S)
    ]).astype(np.uint64)
    return out

"""Packed fixed-width bits — the baseline ID codec.

Reference behavior (custom_invlists_impl.cpp:64-118): width =
ceil(log2(ntotal + 1)) bits per id (the smallest width such that
2**bits >= ntotal + 1, computed by the `while((1 << bits) < ntotal+1)` loop);
ids written LSB-first back to back; O(1) random access by bit offset.

Host: vectorized pack (core.bits.np_pack_fixed). Device: `PackedBitsBatch`
holds the packed words; both full-sweep decode and random access are a single
vectorized two-word gather + shift (core.bits.get_fixed_fields) — no
sequential structure at all, so this codec is pure memory bandwidth.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..core.bits import get_fixed_fields, np_pack_fixed


def packed_width(ntotal: int) -> int:
    """Smallest b with 2**b >= ntotal + 1 (reference custom_invlists_impl.cpp:68-70)."""
    bits = 0
    while (1 << bits) < ntotal + 1:
        bits += 1
    return bits


class PackedBitsBatch(NamedTuple):
    words: jax.Array    # u32[B, W]
    lengths: jax.Array  # i32[B]
    width: int

    @property
    def size_in_bytes_per_list(self) -> np.ndarray:
        """Reference accounting: (ls*bits+7)/8 bytes per list
        (custom_invlists_impl.cpp:82-84)."""
        ls = np.asarray(self.lengths)
        return (ls * self.width + 7) // 8


def pack_lists(id_lists: Sequence[np.ndarray], width: int) -> PackedBitsBatch:
    B = len(id_lists)
    lengths = np.array([len(v) for v in id_lists], dtype=np.int32)
    n_max = int(lengths.max()) if B else 0
    W = max((n_max * width + 31) // 32, 1)
    words = np.zeros((B, W), dtype=np.uint32)
    for b, v in enumerate(id_lists):
        w = np_pack_fixed(np.asarray(v, dtype=np.uint64), width)
        words[b, : len(w)] = w
    return PackedBitsBatch(jnp.asarray(words), jnp.asarray(lengths), width)


def unpack_all(pb: PackedBitsBatch, n_max: int) -> jax.Array:
    """Decode every lane → u64[B, n_max], zero-padded."""
    B = pb.words.shape[0]
    idx = jnp.broadcast_to(jnp.arange(n_max, dtype=jnp.int32)[None, :], (B, n_max))
    vals = get_fixed_fields(pb.words, pb.width, idx)
    return jnp.where(idx < pb.lengths[:, None], vals, 0)


def get_single(pb: PackedBitsBatch, lane: jax.Array, offset: jax.Array) -> jax.Array:
    """O(1) random access, vectorized over (lane, offset) query pairs —
    the reference's get_single_id (custom_invlists_impl.cpp:108-113)."""
    words = pb.words[lane]           # [Q, W]
    q = offset.shape[0] if offset.ndim else 1
    vals = get_fixed_fields(words.reshape(q, -1), pb.width, offset.reshape(q, 1))
    return vals.reshape(offset.shape)

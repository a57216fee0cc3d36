"""Batched device (JAX/XLA) ROC codec — lists as lanes.

The ANS chain is strictly sequential *within* a list (the state threads
through every element: reference codec.cpp:123-152), but embarrassingly
parallel *across* lists. The reference parallelizes with OpenMP over lists
(custom_invlists_impl.cpp:147); here a batch of B same-padded lists advances
in lockstep through one `lax.scan`, so every per-step primitive is a dense
vector op over the lane dimension — the batched shape of the same
computation. Sharding the lane dimension over a device mesh is layered on top
in ``parallel.mesh``.

Bit-exactness: each lane reproduces the reference stream exactly (same 64-bit
head arithmetic, same 32-bit stack words in the same order, same MT19937(1234)
initial-bits draws — supplied as a precomputed shared pool, since every list's
generator starts from the same seed). Verified in tests against both the host
oracle (core.rans) and the compiled C++ reference.

Order statistics are dense per-step vector ops (O(n) per element):
  encode: select k-th remaining = cumsum over an aliveness mask + argmax;
  decode: rank of symbol = masked compare-and-sum over inserted symbols.
O(n^2) per list total, but every op is a dense vector op across
(lanes x elements). A hierarchical (blocked popcount) variant is the planned fast path
for very long lists.

State-array layout per batch of B lists (static shapes; pad + mask):
  head:      u64[B]       rANS head, invariant-maintained exactly as reference
  stack:     u32[B, cap]  bottom-to-top stack words
  stack_len: i32[B]
  mt_ctr:    i32[B]       how many pool words consumed (per-lane draw count)
  pool:      u32[P]       shared MT19937(1234) output pool
  err:       bool[B]      pool overflow flag (assert clear host-side)
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.mt19937 import mt19937_pool

RANS_L = jnp.uint64(1 << 31)
_U64_1 = jnp.uint64(1)
_MASK32 = jnp.uint64(0xFFFFFFFF)


class RocStates(NamedTuple):
    """Batched ANS states for B lists."""

    head: jax.Array       # u64[B]
    stack: jax.Array      # u32[B, cap]
    stack_len: jax.Array  # i32[B]
    mt_ctr: jax.Array     # i32[B]
    err: jax.Array        # bool[B]

    @property
    def size_bytes(self) -> jax.Array:
        """Per-list compressed size, matching reference codec.h:42-44."""
        return 8 + 4 * self.stack_len


def fresh_states(batch: int, cap: int) -> RocStates:
    return RocStates(
        head=jnp.full((batch,), RANS_L, dtype=jnp.uint64),
        stack=jnp.zeros((batch, cap), dtype=jnp.uint32),
        stack_len=jnp.zeros((batch,), dtype=jnp.int32),
        mt_ctr=jnp.zeros((batch,), dtype=jnp.int32),
        err=jnp.zeros((batch,), dtype=bool),
    )


@lru_cache(maxsize=64)
def default_pool(n_max: int) -> jnp.ndarray:
    """MT19937(1234) pool sized for encode+decode of lists up to n_max.
    Cached — decode hot paths (grouped ID translation, graph neighbor
    fetches) call this per batch, and regenerating + re-uploading the pool
    each time is pure waste."""
    return jnp.asarray(mt19937_pool(count=n_max + 64))


def stack_capacity(n_max: int, max_precision: int) -> int:
    """Per-list stack bound: pushes add <= precision bits per element (spilled
    in 32-bit words), plus slack for pop-side spills. Overflow is detected at
    runtime via the err flag (never silent)."""
    return (n_max * max_precision + 31) // 32 + max(16, n_max // 8)


# ---------------------------------------------------------------------------
# masked stack helpers (all lanes move in lockstep; `mask` gates mutation)
# ---------------------------------------------------------------------------


def _stack_push(stack, stack_len, word, mask):
    b = jnp.arange(stack.shape[0])
    idx = jnp.clip(stack_len, 0, stack.shape[1] - 1)
    old = stack[b, idx]
    stack = stack.at[b, idx].set(jnp.where(mask, word.astype(jnp.uint32), old))
    overflow = mask & (stack_len >= stack.shape[1])
    return stack, stack_len + mask.astype(jnp.int32), overflow


def _stack_or_pool_word(stack, stack_len, pool, mt_ctr, take):
    """One 32-bit refill word per lane: stack top if nonempty, else pool."""
    b = jnp.arange(stack.shape[0])
    has = stack_len > 0
    top = stack[b, jnp.clip(stack_len - 1, 0, stack.shape[1] - 1)]
    pooled = pool[jnp.clip(mt_ctr, 0, pool.shape[0] - 1)]
    word = jnp.where(has, top, pooled)
    from_stack = take & has
    from_pool = take & ~has
    stack_len = stack_len - from_stack.astype(jnp.int32)
    overflow = from_pool & (mt_ctr >= pool.shape[0])
    mt_ctr = mt_ctr + from_pool.astype(jnp.int32)
    return word.astype(jnp.uint64), stack_len, mt_ctr, overflow


# ---------------------------------------------------------------------------
# rANS primitives, vectorized over lanes (reference codec.cpp:21-121)
# ---------------------------------------------------------------------------


def _divmod_by_u32(head0, nmax_u32, digit_bits: int = 8):
    """Exact (head0 // nmax, head0 % nmax) for head0 < 2^64.

    Digit-wise long division so every intermediate fits uint32 (32-bit
    divides instead of a 64-bit division). digit_bits=16 needs
    nmax < 2^16 (4 steps); digit_bits=8 needs nmax < 2^24 (8 steps). Callers
    choose statically from the bucket's max list length."""
    nm = jnp.maximum(nmax_u32, 1)
    mask = jnp.uint32((1 << digit_bits) - 1)
    r = jnp.zeros_like(nm)
    q = jnp.zeros_like(head0)
    for shift in range(64 - digit_bits, -digit_bits, -digit_bits):
        digit = (head0 >> jnp.uint64(shift)).astype(jnp.uint32) & mask
        cur = (r << jnp.uint32(digit_bits)) | digit
        qd = cur // nm
        r = cur - qd * nm
        q = (q << jnp.uint64(digit_bits)) | qd.astype(jnp.uint64)
    return q, r.astype(jnp.uint64)


def digit_bits_for(n_max: int) -> int:
    """Static digit width for _divmod_by_u32 given the max modulus."""
    if n_max < (1 << 16):
        return 16
    if n_max < (1 << 24):
        return 8
    raise ValueError("lists longer than 2^24 are not supported per bucket")


def _pop_mod(st: RocStates, pool, nmax_u32, active, digit_bits: int = 8):
    """pop_with_finer_precision (codec.cpp:21-42), lanes in lockstep."""
    head0 = st.head
    q32 = (jnp.uint32(1 << 31) // jnp.maximum(nmax_u32, 1)).astype(jnp.uint64)
    nmax = nmax_u32.astype(jnp.uint64)
    spill = (head0 >= nmax * (q32 << jnp.uint64(32))) & active
    stack, stack_len, ovf0 = _stack_push(st.stack, st.stack_len, head0 & _MASK32, spill)
    head0 = jnp.where(spill, head0 >> jnp.uint64(32), head0)

    head, cfs = _divmod_by_u32(head0, nmax_u32, digit_bits)
    cfs = jnp.where(active, cfs, 0)

    refill = (head0 < RANS_L) & active
    word, stack_len, mt_ctr, ovf = _stack_or_pool_word(
        stack, stack_len, pool, st.mt_ctr, refill
    )
    head = jnp.where(refill, word | (head << jnp.uint64(32)), head)
    head = jnp.where(active, head, st.head)
    return cfs, RocStates(head, stack, stack_len, mt_ctr, st.err | ovf0 | ovf)


def _push_mod(st: RocStates, pool, value, nmax_u32, active):
    """push_with_finer_precision (codec.cpp:44-63), lanes in lockstep."""
    head0 = st.head
    q32 = (jnp.uint32(1 << 31) // jnp.maximum(nmax_u32, 1)).astype(jnp.uint64)
    spill = (head0 >= (q32 << jnp.uint64(32))) & active
    stack, stack_len, ovf0 = _stack_push(st.stack, st.stack_len, head0 & _MASK32, spill)
    head0 = jnp.where(spill, head0 >> jnp.uint64(32), head0)

    head = head0 * nmax_u32.astype(jnp.uint64) + value.astype(jnp.uint64)

    refill = (head < RANS_L) & active
    word, stack_len, mt_ctr, ovf = _stack_or_pool_word(
        stack, stack_len, pool, st.mt_ctr, refill
    )
    head = jnp.where(refill, (head << jnp.uint64(32)) | word, head)
    head = jnp.where(active, head, st.head)
    return RocStates(head, stack, stack_len, mt_ctr, st.err | ovf0 | ovf)


def _slice_lowers(n_slices: int):
    """Active 16-bit slice offsets. Slices with clamped precision 0 for every
    lane are exact no-ops on any valid stream (the head invariant
    head >= RANS_L makes a p=0 vrans push/pop touch nothing), so callers pass
    n_slices = ceil(max_precision / 16) and we skip the rest statically."""
    return (0, 16, 32, 48)[:n_slices]


def _push_symbol(st: RocStates, symbol, precision, active, n_slices=4):
    """codec_push (codec.cpp:92-105): 16-bit slices, low slice first.
    vrans_push never refills, so no pool access here."""
    head, stack, stack_len = st.head, st.stack, st.stack_len
    err = st.err
    for lower in _slice_lowers(n_slices):
        p = jnp.clip(precision - lower, 0, 16).astype(jnp.uint64)
        s = (symbol >> jnp.uint64(lower)) & jnp.uint64(0xFFFF)
        spill = (head >= ((RANS_L >> p) << jnp.uint64(32))) & active
        stack, stack_len, ovf = _stack_push(stack, stack_len, head & _MASK32, spill)
        err = err | ovf
        head0 = jnp.where(spill, head >> jnp.uint64(32), head)
        head = jnp.where(active, (head0 << p) + s, head)
    return RocStates(head, stack, stack_len, st.mt_ctr, err)


def _pop_symbol(st: RocStates, pool, precision, active, n_slices=4):
    """codec_pop (codec.cpp:107-121): high slice first."""
    head, stack, stack_len, mt_ctr, err = st
    symbol = jnp.zeros_like(head)
    for lower in reversed(_slice_lowers(n_slices)):
        p = jnp.clip(precision - lower, 0, 16).astype(jnp.uint64)
        mask = (_U64_1 << p) - _U64_1
        cfs = head & mask
        h = head >> p
        refill = (h < RANS_L) & active
        word, stack_len, mt_ctr, ovf = _stack_or_pool_word(
            stack, stack_len, pool, mt_ctr, refill
        )
        err = err | ovf
        h = jnp.where(refill, (h << jnp.uint64(32)) | word, h)
        head = jnp.where(active, h, head)
        symbol = jnp.where(active, (symbol << jnp.uint64(16)) | cfs, symbol)
    return symbol, RocStates(head, stack, stack_len, mt_ctr, err)


# ---------------------------------------------------------------------------
# full ROC encode / decode over a padded batch
# ---------------------------------------------------------------------------


def n_slices_for(max_precision: int) -> int:
    """Static count of active 16-bit symbol slices for a bucket."""
    return max(1, -(-int(max_precision) // 16))


@partial(jax.jit, static_argnums=(5,))
def roc_encode_batch(sorted_ids, lengths, precision, pool, states: RocStates,
                     n_slices: int = 4):
    """Encode B lists in lockstep.

    Args:
      sorted_ids: u64[B, n_max] — each lane's ids ascending in [0:ls), padding
        arbitrary beyond.
      lengths: i32[B] true list sizes; precision: i32[B] per-lane bit widths.
      pool: u32[P] shared MT19937 pool; states: fresh (or resumed) RocStates.

    Returns (states, order) where order: i32[B, n_max] gives, per lane, the
    index into the lane's *sorted* ids emitted at step i (payload codes must
    be reordered by it — custom_invlists_impl.cpp:178-193).
    """
    B, n_max = sorted_ids.shape

    digit_bits = digit_bits_for(n_max)

    def step(carry, i):
        st, alive = carry
        active = i < lengths
        nmax = (lengths - i).astype(jnp.uint32)
        k, st = _pop_mod(st, pool, nmax, active, digit_bits)
        # select k-th (0-based) remaining element per lane
        cum = jnp.cumsum(alive, axis=1)
        pos = jnp.argmax(cum == (k.astype(jnp.int32) + 1)[:, None], axis=1)
        b = jnp.arange(B)
        symbol = sorted_ids[b, pos]
        alive = alive.at[b, pos].set(
            jnp.where(active, 0, alive[b, pos]).astype(alive.dtype)
        )
        st = _push_symbol(st, symbol, precision, active, n_slices)
        return (st, alive), jnp.where(active, pos, -1)

    alive0 = (
        jnp.arange(n_max, dtype=jnp.int32)[None, :] < lengths[:, None]
    ).astype(jnp.int32)
    (states, _), order = jax.lax.scan(
        step, (states, alive0), jnp.arange(n_max, dtype=jnp.int32)
    )
    return states, order.T  # [B, n_max]


@partial(jax.jit, static_argnums=(4, 5))
def roc_decode_batch(states: RocStates, lengths, precision, pool, n_max: int,
                     n_slices: int = 4):
    """Decode B lists in lockstep; inverse of ``roc_encode_batch``.

    Returns (ids, states): ids u64[B, n_max] in encode sampling order
    (matching reordered payload codes), zero-padded beyond each lane's length.
    """
    B = lengths.shape[0]

    def step(st_and_syms, i):
        st, syms = st_and_syms
        active = i < lengths
        symbol, st = _pop_symbol(st, pool, precision, active, n_slices)
        # rank among previously inserted (count of strictly smaller)
        seen = jnp.arange(n_max, dtype=jnp.int32)[None, :] < i
        smaller = seen & (syms < symbol[:, None])
        rank = jnp.sum(smaller, axis=1).astype(jnp.uint32)
        syms = syms.at[:, i].set(symbol)
        st = _push_mod(st, pool, rank, jnp.uint32(i + 1), active)
        return (st, syms), symbol

    # derive the init from an input so it inherits the shard_map varying
    # axis (plain zeros would be typed as replicated inside shard_map)
    syms0 = jnp.broadcast_to(
        (lengths * 0).astype(jnp.uint64)[:, None], (B, n_max)
    )
    (states, _), emitted = jax.lax.scan(
        step, (states, syms0), jnp.arange(n_max, dtype=jnp.int32)
    )
    emitted = emitted.T  # [B, n_max]; step i decoded = output slot ls-1-i
    j = jnp.arange(n_max, dtype=jnp.int32)[None, :]
    src = jnp.clip(lengths[:, None] - 1 - j, 0, n_max - 1)
    ids = jnp.take_along_axis(emitted, src, axis=1)
    ids = jnp.where(j < lengths[:, None], ids, 0)
    return ids, states


# ---------------------------------------------------------------------------
# chained (multi-multiset) coding through ONE threaded ANS state per lane.
# ANS is a bijection on states, so S multisets can share a lane's state
# sequentially: encode slot S-1 ... 0, then decode emits slot 0 first. This
# amortizes the 8-byte head + stack word rounding that dominate the per-node
# ROC rate at small list sizes (altid_impl.cpp:103-165 pays them per node).
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnums=(5,))
def roc_encode_chained(sorted_ids, lengths, precision, pool,
                       states: RocStates, n_slices: int = 4):
    """Encode S multisets per lane through one threaded state.

    Args:
      sorted_ids: u64[B, S, n_max] — slot ids ascending in [0:lengths[b, s]).
      lengths, precision: i32[B, S] per-slot sizes / symbol bit widths.

    Slot S-1 is pushed first so that chained decode pops slot 0 first.
    Returns the final states (sampling orders are discarded — chained storage
    has no per-slot payload co-reordering; callers that need it should use
    ``roc_encode_batch`` per slot).
    """

    def step(st, inp):
        ids_s, len_s, prec_s = inp
        st, _ = roc_encode_batch(ids_s, len_s, prec_s, pool, st, n_slices)
        return st, None

    xs = (jnp.flip(jnp.swapaxes(sorted_ids, 0, 1), axis=0),
          jnp.flip(lengths.T, axis=0), jnp.flip(precision.T, axis=0))
    states, _ = jax.lax.scan(step, states, xs)
    return states


@partial(jax.jit, static_argnums=(4, 5))
def roc_decode_chained(states: RocStates, lengths, precision, pool,
                       n_max: int, n_slices: int = 4):
    """Inverse of ``roc_encode_chained``: decode S multisets per lane.

    Returns (ids, states): ids u64[B, S, n_max] in per-slot encode sampling
    order, zero-padded beyond each slot's length; slot 0 decodes first.
    """

    def step(st, inp):
        len_s, prec_s = inp
        ids, st = roc_decode_batch(st, len_s, prec_s, pool, n_max, n_slices)
        return st, ids

    states, ids = jax.lax.scan(step, states, (lengths.T, precision.T))
    return jnp.swapaxes(ids, 0, 1), states


# ---------------------------------------------------------------------------
# host <-> device state conversion (for serialization & oracle cross-checks)
# ---------------------------------------------------------------------------


def states_to_numpy(states: RocStates):
    return jax.tree_util.tree_map(np.asarray, states)


def pack_states(states: RocStates, lengths) -> list[dict]:
    """Per-list plain dict (head, stack list) for serialization/tests."""
    st = states_to_numpy(states)
    out = []
    for b in range(st.head.shape[0]):
        out.append(
            {
                "head": int(st.head[b]),
                "stack": st.stack[b, : int(st.stack_len[b])].tolist(),
                "mt_ctr": int(st.mt_ctr[b]),
                "n": int(lengths[b]),
            }
        )
    return out


# ---------------------------------------------------------------------------
# ragged-batch encode front door (native C++ when available, else XLA scan)
# ---------------------------------------------------------------------------


def native_encode_enabled() -> bool:
    import os

    from .. import native

    return (native.available()
            and os.environ.get("VDBIDC_NATIVE_ENCODE", "1") == "1")


def encode_ragged(lists, precisions, n_pad: int, cap: int,
                  use_native=None):
    """Encode a ragged batch of distinct-id lists → (RocStates, orders).

    ``orders[i]`` is the sampling-order permutation into the i-th ORIGINAL
    list (what payload codes must be reordered by). Dispatches to the native
    C++ batch encoder when available (bit-exact with the device encoder —
    tests/test_native.py), else the lists-as-lanes XLA scan encoder. This is
    the one shared path behind RocInvertedLists / InterleavedRocInvertedLists
    / RocGraph construction."""
    B = len(lists)
    prec = np.asarray(precisions, dtype=np.int32)
    if use_native is None:
        use_native = native_encode_enabled()
    if use_native:
        from .. import native

        heads, stacks, lens, orders, mt = native.roc_encode_lists(
            lists, prec, cap=cap)
        states = RocStates(
            head=jnp.asarray(heads), stack=jnp.asarray(stacks),
            stack_len=jnp.asarray(lens),
            mt_ctr=jnp.asarray(mt.astype(np.int32)),
            err=jnp.zeros(B, dtype=bool),
        )
        return states, orders

    lengths = np.array([len(v) for v in lists], dtype=np.int32)
    sorted_ids = np.zeros((B, n_pad), dtype=np.uint64)
    perms = []
    for i, v in enumerate(lists):
        v = np.asarray(v, np.uint64)
        perm = np.argsort(v, kind="stable")
        perms.append(perm)
        sorted_ids[i, : len(v)] = v[perm]
    states, order = roc_encode_batch(
        jnp.asarray(sorted_ids), jnp.asarray(lengths), jnp.asarray(prec),
        default_pool(n_pad), fresh_states(B, cap),
        n_slices_for(int(prec.max(initial=1))))
    if bool(np.asarray(states.err).any()):
        raise RuntimeError("MT19937 pool exhausted / stack overflow in "
                           "ROC encode")
    order_np = np.asarray(order)
    orders = [perms[i][order_np[i, : len(lists[i])]] for i in range(B)]
    return states, orders

"""ROC decode as one Pallas kernel, compiled for the GPU through Triton.

The plain decoder (``codecs.roc_device.roc_decode_batch``) is a ``lax.scan``
with one step per decoded id; XLA runs every step as a handful of small
kernels, so a list of n ids costs ~n launches. This kernel runs the whole
sequential chain of a block of lanes (lists) inside one program: the 64-bit
rANS head lives in registers, the stack is popped by a per-lane gather and
spilled by a per-lane masked store, and the insert-rank of each decoded
symbol is a count over the symbols already emitted, read back in
``[rank_rows, lanes]`` tiles. Bit-exact with the scan path, hence with the
C++ reference (tests run the kernel in interpret mode on the CPU).

Data layout: row-major ``[rows, lanes]`` arrays, lanes minor, so a block's
per-step loads and stores of one row are coalesced. The MT19937 initial-bits
pool is composed *below* each lane's stack in the same buffer, so "stack
empty -> draw from the pool" (reference codec.h:32-40) is the same pop
reading below the stack base.

Per element step (inverse of reference codec.cpp:140-152):
  codec_pop (16-bit slices, high first)      -> symbol
  rank = #smaller among previously emitted   (tile compare + reduce)
  push_with_finer_precision(rank, i+1)

Envelope: symbol precision <= 32 (ids < 2^32). Callers route wider
containers to the plain path before building a decoder (``supports``).

Chained slots (``lengths`` of shape [B, S]): S multisets threaded through
one ANS state per lane, slot 0 first (store.graph RocBlockGraph).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..codecs import roc_device as rd

POOL_ROWS = 32  # decode rarely draws initial bits; err flag if exceeded
N_SLICES = 2  # precision <= 32: a symbol pops as at most two 16-bit slices
LANE_PAD = 64  # lane counts are padded to this (the widest lane block)
TILE = 2048  # elements of one [rank_rows, lanes] rank tile
_WAVE = 264  # programs that give each of the H100's 132 SMs two blocks

_RANS_L = 1 << 31
_MASK32 = 0xFFFFFFFF


def supports(max_precision: int) -> bool:
    """Data envelope of the kernel: symbols (ids) must fit 32 bits."""
    return max_precision <= 32


def lanes_per_program(n_lanes: int) -> int:
    """Lanes one program decodes. Each lane is a sequential chain, so the
    card fills only with enough programs: take the widest block that still
    gives every SM two programs, and the narrowest (8) when lanes are few
    (1024 whole lists -> 128 programs of 8 lanes)."""
    for lb in (64, 32, 16):
        if -(-n_lanes // lb) >= _WAVE:
            return lb
    return 8


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _decode_kernel(n_max: int, n_rows: int, S: int, lb: int, rb: int,
                   capp: int, interpret: bool):
    """Kernel for static shapes. One program owns ``lb`` lanes; emit rows
    ``[s*n_rows, s*n_rows + length)`` of a lane hold slot s's symbols in
    decode-iteration order (reversed sampling order)."""

    def barrier():
        # per-lane stores become visible to the threads that read them back
        # in other layouts (rank tiles, later pops)
        if not interpret:
            plgpu.debug_barrier()

    def kernel(len_ref, prec_ref, head_ref, ptr_ref, buf_in_ref,
               buf_ref, emit_ref, err_ref):
        lane0 = pl.program_id(0) * lb
        cols = pl.ds(lane0, lb)
        lanes = lane0 + jax.lax.broadcasted_iota(jnp.int32, (lb,), 0)
        rows_t = jax.lax.broadcasted_iota(jnp.int32, (rb, lb), 0)

        def copy(t, c):
            rs = pl.ds(t * rb, rb)
            buf_ref[rs, cols] = buf_in_ref[rs, cols]
            return c

        jax.lax.fori_loop(0, capp // rb, copy, 0)
        barrier()

        def pop_word(ptr, take, err, load=None):
            """One refill word per lane from the stack top (or the pool
            below it); ``load`` narrows which lanes read memory."""
            w = plgpu.load(buf_ref.at[ptr - 1, lanes],
                           mask=take if load is None else load,
                           other=jnp.uint32(0))
            err = err | (take & (ptr <= 0)).astype(jnp.int32)
            return w.astype(jnp.uint64), ptr - take.astype(jnp.int32), err

        def slot(s, lengths, prec):
            base = s * n_rows

            def step(i, carry):
                head, ptr, err = carry
                active = i < lengths

                # codec_pop: slices high -> low (codec.cpp:107-121)
                sym = jnp.zeros((lb,), jnp.uint64)
                for si in range(N_SLICES - 1, -1, -1):
                    p = jnp.clip(prec - 16 * si, 0, 16).astype(jnp.uint64)
                    cfs = head & ((jnp.uint64(1) << p) - jnp.uint64(1))
                    h = head >> p
                    refill = (h < _RANS_L) & active
                    w, ptr, err = pop_word(ptr, refill, err)
                    h = jnp.where(refill, (h << jnp.uint64(32)) | w, h)
                    head = jnp.where(active, h, head)
                    sym = jnp.where(active, (sym << jnp.uint64(16)) | cfs,
                                    sym)
                symbol = sym.astype(jnp.uint32)

                # rank: count strictly smaller among rows < i of this slot
                def rank_tile(b, acc):
                    r = rows_t + b * rb
                    tile = emit_ref[pl.ds(base + b * rb, rb), cols]
                    hit = (r < i) & (tile < symbol[None, :])
                    return acc + jnp.sum(hit.astype(jnp.int32), axis=0,
                                         dtype=jnp.int32)

                rank = jax.lax.fori_loop(
                    0, jax.lax.div(i + (rb - 1), jnp.int32(rb)), rank_tile,
                    jnp.zeros((lb,), jnp.int32))

                # push_with_finer_precision(rank, i+1) (codec.cpp:44-63)
                nm = (i + 1).astype(jnp.uint64)
                q32 = jnp.uint64(_RANS_L) // nm
                spill = (head >= (q32 << jnp.uint64(32))) & active
                low = (head & jnp.uint64(_MASK32)).astype(jnp.uint32)
                plgpu.store(buf_ref.at[ptr, lanes], low,
                            mask=spill & (ptr < capp))
                err = err | (spill & (ptr >= capp)).astype(jnp.int32)
                ptr = ptr + spill.astype(jnp.int32)
                head0 = jnp.where(spill, head >> jnp.uint64(32), head)
                h = head0 * nm + rank.astype(jnp.uint64)
                refill = (h < _RANS_L) & active
                # a refill right after a spill pops the word just spilled,
                # which is still in registers
                w, ptr, err = pop_word(ptr, refill, err, refill & ~spill)
                w = jnp.where(spill, low.astype(jnp.uint64), w)
                h = jnp.where(refill, (h << jnp.uint64(32)) | w, h)
                head = jnp.where(active, h, head)

                emit_ref[base + i, cols] = jnp.where(active, symbol,
                                                     jnp.uint32(0))
                barrier()
                return head, ptr, err

            return step

        carry = (head_ref[cols], ptr_ref[cols], jnp.zeros((lb,), jnp.int32))
        for s in range(S):  # chained slots thread the state, slot 0 first
            lengths = len_ref[s, cols]
            prec = prec_ref[s, cols]
            n_steps = jnp.minimum(jnp.max(lengths), n_max)
            carry = jax.lax.fori_loop(0, n_steps, slot(s, lengths, prec),
                                      carry)
        err_ref[cols] = carry[2]

    return kernel


@partial(jax.jit, static_argnames=("n_max", "interpret"))
def run_kernel(buf, head, ptr, lens, prec, *, n_max: int,
               interpret: bool = False):
    """Decode every lane of prepared inputs (see ``prepare``).

    ``buf`` u32[capp, B] pool+stack rows, ``head`` u64[B], ``ptr`` i32[B],
    ``lens``/``prec`` i32[S, B]. Returns (emit u32[S, n_max, B] in
    decode-iteration order — element j of slot s of lane b is
    ``emit[s, lens[s, b]-1-j, b]`` — and err bool, set on stack or pool
    exhaustion). Lanes are padded here to a multiple of ``LANE_PAD``."""
    capp0, B0 = buf.shape
    S = lens.shape[0]
    B = _round_up(max(B0, 1), LANE_PAD)
    lb = lanes_per_program(B)
    rb = TILE // lb
    capp = _round_up(capp0, rb)
    n_rows = _round_up(max(n_max, 1), rb)
    pad = B - B0
    buf = jnp.pad(buf, ((0, capp - capp0), (0, pad)))
    head = jnp.pad(head, (0, pad), constant_values=np.uint64(_RANS_L))
    ptr = jnp.pad(ptr, (0, pad))
    lens = jnp.pad(lens, ((0, 0), (0, pad)))
    prec = jnp.pad(prec, ((0, 0), (0, pad)), constant_values=1)
    kernel = _decode_kernel(n_max, n_rows, S, lb, rb, capp, interpret)
    _, emit, err = pl.pallas_call(
        kernel,
        grid=(B // lb,),
        out_shape=[
            jax.ShapeDtypeStruct((capp, B), jnp.uint32),
            jax.ShapeDtypeStruct((S * n_rows, B), jnp.uint32),
            jax.ShapeDtypeStruct((B,), jnp.int32),
        ],
        interpret=interpret,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        name="roc_decode",
    )(lens, prec, head, ptr, buf)
    emit = emit.reshape(S, n_rows, B)[:, :n_max, :B0]
    return emit, jnp.any(err[:B0] != 0)


def to_sampling_order(emit, lens):
    """Decode-iteration order u32[S, n_max, B] -> ids u32[B, S, n_max] in
    encode sampling order, zero beyond each slot's length."""
    S, n_max, B = emit.shape
    j = jnp.arange(n_max, dtype=jnp.int32)[None, :, None]
    src = jnp.clip(lens[:, None, :] - 1 - j, 0, max(n_max - 1, 0))
    ids = jnp.take_along_axis(emit, src, axis=1)
    ids = jnp.where(j < lens[:, None, :], ids, jnp.uint32(0))
    return jnp.transpose(ids, (2, 0, 1))


@partial(jax.jit, static_argnames=("capp",))
def prepare(stack, stack_len, mt_ctr, head, pool, *, capp: int):
    """Kernel inputs from lane-major RocStates fields: (buf u32[capp, B],
    head u64[B], ptr i32[B], pool_ok). Rows [0, POOL_ROWS) of a lane hold
    the pool words it would draw next, reversed, so the pop below the stack
    base reads pool[mt_ctr], pool[mt_ctr + 1], ... in order."""
    B, cap = stack.shape
    draw = mt_ctr[:, None] + (POOL_ROWS - 1 - jnp.arange(POOL_ROWS))[None, :]
    pool_ok = jnp.all(draw < pool.shape[0])
    pool_part = pool[jnp.minimum(draw, pool.shape[0] - 1)]
    rows = capp - POOL_ROWS
    stack_part = (stack[:, :rows] if rows <= cap else jnp.pad(
        stack, ((0, 0), (0, rows - cap))))
    buf = jnp.concatenate([pool_part.astype(jnp.uint32),
                           stack_part.astype(jnp.uint32)], axis=1).T
    ptr = (POOL_ROWS + stack_len).astype(jnp.int32)
    return buf, head.astype(jnp.uint64), ptr, pool_ok


class RocPallasDecoder:
    """Prepared, device-resident ROC decoder over a batch of lanes.

    ``lengths``/``precision`` are [B] for one multiset per lane or [B, S]
    for S chained slots per lane. Build once per container; ``decode`` and
    the lane-subset calls are then single kernel launches."""

    def __init__(self, states: rd.RocStates, lengths, precision, pool,
                 n_max: int, capp: int | None = None):
        """``capp`` optionally pins the stack-buffer height (rows) instead
        of deriving it from max(stack_len) — multi-process builds pass the
        GLOBAL maximum so every process compiles the same kernel shape."""
        lengths = np.asarray(lengths, np.int32)
        precision = np.asarray(precision, np.int32)
        self.chained = lengths.ndim == 2
        if not self.chained:
            lengths, precision = lengths[:, None], precision[:, None]
        if not supports(int(precision.max(initial=1))):
            raise ValueError("ROC decode kernel supports precision <= 32")
        self.B0, self.S = lengths.shape
        self.n_max = int(n_max)
        # decode never grows the stack past its initial height (+1 transient
        # word per step before the matching refill)
        max_len = (int(np.max(np.asarray(states.stack_len), initial=0))
                   if capp is None else capp)
        self.capp = _round_up(POOL_ROWS + max_len + 8, 8)
        self.buf, self.head, self.ptr, pool_ok = prepare(
            jnp.asarray(states.stack), jnp.asarray(states.stack_len),
            jnp.asarray(states.mt_ctr), jnp.asarray(states.head),
            jnp.asarray(pool, jnp.uint32), capp=self.capp)
        self.pool_ok = bool(pool_ok)
        self.lens = jnp.asarray(lengths.T.copy())      # [S, B]
        self.prec = jnp.asarray(precision.T.copy())    # [S, B]

    def _ids(self, emit, lens):
        ids = to_sampling_order(emit, lens)
        return ids if self.chained else ids[:, 0]

    def decode(self, interpret: bool = False):
        """-> (ids u32[B0, n_max] (or [B0, S, n_max] chained) in encode
        sampling order, ok)."""
        emit, err = run_kernel(self.buf, self.head, self.ptr, self.lens,
                               self.prec, n_max=self.n_max,
                               interpret=interpret)
        return self._ids(emit, self.lens), self.pool_ok and not bool(err)

    def checked(self, interpret: bool = False):
        """Validate the err flag once with a full decode and return self:
        per-lane decode is deterministic, so later subset calls need no
        flag pull. Raises when the kernel flags stack/pool exhaustion."""
        if not self.decode(interpret=interpret)[1]:
            raise RuntimeError("ROC decode kernel flagged stack/pool "
                               "exhaustion: the streams are corrupt")
        return self

    def decode_lanes(self, idx, interpret: bool = False):
        """Decode the lanes ``idx`` i32[Q] (host array, or traced inside
        jit) -> ids in encode sampling order. No err pull — see
        ``checked``."""
        idx = jnp.asarray(idx).astype(jnp.int32)
        lens = self.lens[:, idx]
        emit, _ = run_kernel(self.buf[:, idx], self.head[idx], self.ptr[idx],
                             lens, self.prec[:, idx], n_max=self.n_max,
                             interpret=interpret)
        return self._ids(emit, lens)


def roc_decode_pallas(states: rd.RocStates, lengths, precision, pool,
                      n_max: int, interpret: bool = False):
    """One-shot wrapper: -> (ids u32[B, n_max] numpy, zero-padded, in
    encode sampling order; ok)."""
    dec = RocPallasDecoder(states, lengths, precision, pool, n_max)
    ids, ok = dec.decode(interpret=interpret)
    return np.asarray(ids), ok

"""Host-exact streaming rANS state machine (the ROC codec core).

Semantics-equivalent reimplementation of the reference ANS primitives
(reference: custom_invlist_cpp/codec.h:13-52, codec.cpp:19-121):

  - 64-bit head with invariant head >= RANS_L = 2^31, 32-bit word stack.
  - When the stack underflows, "initial bits" are drawn from MT19937(1234)
    (codec.h:32-40) — see core.mt19937.
  - ``push_uniform`` / ``pop_uniform``: power-of-two-precision uniform coding
    with 32-bit renormalization (codec.cpp:65-90, `vrans_push/pop` there).
  - ``push_mod`` / ``pop_mod``: uniform coding with an arbitrary modulus
    ``nmax`` (codec.cpp:21-63, `push/pop_with_finer_precision` there); used
    for sampling-without-replacement indices in ROC.
  - ``push_symbol`` / ``pop_symbol``: a u64 symbol as four 16-bit slices with
    per-slice precision clamped to [0,16] (codec.cpp:92-121).

The stream this machine emits is byte-identical to the reference for the same
inputs — that is the bit-exactness contract the whole framework tests against.
This host path is the correctness oracle; the batched device path lives in
``codecs.roc`` and the native C++ build-time path in ``native/``.

Everything here is plain Python/numpy integer arithmetic on the host — it is
used at index-build/serialization time and in tests, not in the device hot
path.
"""

from __future__ import annotations

from typing import List, Optional

from .mt19937 import MT19937, DEFAULT_SEED

RANS_L = 1 << 31  # reference: codec.cpp:19
_MASK32 = 0xFFFFFFFF
_MASK64 = 0xFFFFFFFFFFFFFFFF


class RansState:
    """head + stack + MT19937 initial-bits source.

    ``size_bytes`` matches the reference accounting: 8 bytes of head plus 4
    per stack word (codec.h:42-44).
    """

    __slots__ = ("head", "stack", "mt", "mt_draws")

    def __init__(self, seed: int = DEFAULT_SEED):
        self.head: int = RANS_L
        self.stack: List[int] = []
        self.mt = MT19937(seed)
        self.mt_draws: int = 0  # diagnostics: how many initial-bit words drawn

    def clone(self) -> "RansState":
        out = RansState.__new__(RansState)
        out.head = self.head
        out.stack = list(self.stack)
        out.mt = self.mt.clone()
        out.mt_draws = self.mt_draws
        return out

    def stack_push(self, word: int) -> None:
        self.stack.append(word & _MASK32)

    def stack_slice(self) -> int:
        if self.stack:
            return self.stack.pop()
        self.mt_draws += 1
        return self.mt()

    @property
    def size_bytes(self) -> int:
        return 8 + 4 * len(self.stack)


def push_uniform(state: RansState, value: int, precision: int) -> None:
    """Encode a ``precision``-bit uniform symbol. Reference codec.cpp:65-76."""
    head = state.head
    if head >= ((RANS_L >> precision) << 32):
        state.stack_push(head & _MASK32)
        head >>= 32
    state.head = ((head << precision) + value) & _MASK64


def pop_uniform(state: RansState, precision: int) -> int:
    """Decode a ``precision``-bit uniform symbol. Reference codec.cpp:78-90."""
    head0 = state.head
    value = head0 & ((1 << precision) - 1)
    head = head0 >> precision
    if head < RANS_L:
        head = ((head << 32) | state.stack_slice()) & _MASK64
    state.head = head
    return value


def push_mod(state: RansState, value: int, nmax: int) -> None:
    """Encode ``value`` uniform over [0, nmax) for arbitrary nmax.

    Reference codec.cpp:44-63 (`push_with_finer_precision`). Note the spill
    threshold differs from ``pop_mod``'s by the nmax factor — transcribed
    exactly, both are load-bearing for bit-exactness.
    """
    head0 = state.head
    if head0 >= ((RANS_L // nmax) << 32):
        state.stack_push(head0 & _MASK32)
        head0 >>= 32
    head = (head0 * nmax + value) & _MASK64
    if head < RANS_L:
        head = ((head << 32) | state.stack_slice()) & _MASK64
    state.head = head


def pop_mod(state: RansState, nmax: int) -> int:
    """Decode a uniform value over [0, nmax). Reference codec.cpp:21-42.

    The refill condition tests the *pre-divide* head (head0 < RANS_L), which
    can only hold after a spill shifted it down — exact transcription.
    """
    head0 = state.head
    if head0 >= nmax * ((RANS_L // nmax) << 32):
        state.stack_push(head0 & _MASK32)
        head0 >>= 32
    value = head0 % nmax
    head = head0 // nmax
    if head0 < RANS_L:
        head = (state.stack_slice() | (head << 32)) & _MASK64
    state.head = head
    return value


def _slice_precision(precision: int, lower: int) -> int:
    p = precision - lower
    return 0 if p < 0 else (16 if p > 16 else p)


def push_symbol(state: RansState, symbol: int, precision: int) -> None:
    """Encode a u64 symbol as four 16-bit slices, low slice pushed first.

    Reference codec.cpp:92-105. Note: if ``symbol >= 2**precision`` the high
    bits are silently lost (the reference has the same behavior for
    power-of-two max ids; reproduced for bit-exactness, asserted against in
    the container layer instead).
    """
    for lower in (0, 16, 32, 48):
        s = (symbol >> lower) & 0xFFFF
        push_uniform(state, s, _slice_precision(precision, lower))


def pop_symbol(state: RansState, precision: int) -> int:
    """Decode a u64 symbol, high slice popped first. Reference codec.cpp:107-121."""
    symbol = 0
    for lower in (48, 32, 16, 0):
        s = pop_uniform(state, _slice_precision(precision, lower))
        symbol = ((symbol << 16) | s) & _MASK64
    return symbol

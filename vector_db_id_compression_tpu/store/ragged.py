"""Size-bucketed batching of ragged lists.

XLA needs static shapes; inverted lists and adjacency lists are ragged
(empty to ~1e5 elements). We group lists into geometric size buckets and pad
each bucket to its ceiling — the device codecs then process one bucket as one
lanes-in-lockstep batch. This is the batched replacement for the
reference's OpenMP `parallel for` over individual lists
(custom_invlists_impl.cpp:147,234): instead of one thread per list, one lane
per list and one scan per bucket, with padding waste bounded by the bucket
growth factor.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class Bucket:
    """Lists of similar length, padded to ``n_pad``."""

    list_ids: np.ndarray  # i64[B] original list numbers
    lengths: np.ndarray   # i32[B]
    n_pad: int


def bucketize(lengths: Sequence[int], growth: float = 2.0, min_pad: int = 8,
              max_waste: float = 1.35, abs_slack: float = 0.04) -> List[Bucket]:
    """Group list indices into size buckets (empty lists dropped).

    The ceiling grows geometrically while the bucket's padded-slot waste
    stays under ``max_waste`` (padded slots / true slots). A pure
    occupancy-growth rule collapses any continuous length distribution into
    ONE bucket padded to the global max — at 10M ids that meant 4087 lists
    padded to n_pad=11168 against a mean length of 2441 (4.6x slot waste in
    every scan/decode pass). The waste bound keeps n_pad near each bucket's own lengths;
    the number of buckets stays O(log(max_len)/log(growth)).

    ``abs_slack`` is a GLOBAL budget of extra padded slots (fraction of the
    total true slots) spent merging small buckets into their larger
    neighbor AFTER the tight ratio pass. The pure ratio rule strands
    distribution tails in near-empty buckets (a 1M-id IVF1024 build
    produced 6 buckets holding 8 lists total): for a tiny bucket the ratio
    bound trips on a handful of absolute slots, yet every extra bucket
    costs a full extra program dispatch in EVERY scan/decode/translate
    pass and a compiled shape. Merges
    are applied cheapest-first so the slack eliminates only the
    cheap-to-remove buckets, never inflating the dense core."""
    lengths = np.asarray(lengths, dtype=np.int64)
    nonempty = np.flatnonzero(lengths > 0)
    if len(nonempty) == 0:
        return []
    order = nonempty[np.argsort(lengths[nonempty], kind="stable")]
    sorted_lens = lengths[order]
    csum = np.zeros(len(order) + 1, dtype=np.int64)
    np.cumsum(sorted_lens, out=csum[1:])
    # two-pointer greedy: extend the bucket one member at a time (cap = the
    # new member's length) while waste stays bounded. Growing the CAP
    # multiplicatively instead degenerates: from a length near the
    # distribution mode, one doubling overshoots the waste bound
    # immediately, producing one bucket per distinct length (~750 buckets =
    # ~750 decode dispatches at 10M ids); member-at-a-time growth yields a
    # handful of buckets with the same bound.
    spans: List[Tuple[int, int, int]] = []  # (lo, hi, cap) over `order`
    lo = 0
    n = len(order)
    while lo < n:
        hi = lo + 1
        cap = max(int(sorted_lens[lo]), min_pad)
        while hi < n:
            cand = max(int(sorted_lens[hi]), min_pad)
            if (hi + 1 - lo) * cand > max_waste * int(csum[hi + 1] - csum[lo]):
                break
            cap = cand
            hi += 1
        spans.append((lo, hi, cap))
        lo = hi

    # merge pass: absorbing span i into its larger right neighbor costs
    # (hi_i - lo_i) * (cap_{i+1} - cap_i) extra padded slots; apply
    # cheapest merges while the global budget lasts
    slack = int(abs_slack * int(csum[-1]))
    while len(spans) > 1:
        costs = [
            (spans[i][1] - spans[i][0]) * (spans[i + 1][2] - spans[i][2])
            for i in range(len(spans) - 1)
        ]
        i = int(np.argmin(costs))
        if costs[i] > slack:
            break
        slack -= costs[i]
        spans[i] = (spans[i][0], spans[i + 1][1], spans[i + 1][2])
        del spans[i + 1]

    buckets: List[Bucket] = []
    for lo, hi, cap in spans:
        ids = order[lo:hi]
        buckets.append(
            Bucket(
                list_ids=ids.copy(),
                lengths=lengths[ids].astype(np.int32),
                n_pad=cap,
            )
        )
    return buckets


def pad_lists(
    arrays: Sequence[np.ndarray], n_pad: int, dtype=None, fill=0
) -> np.ndarray:
    """[B, n_pad] padded stack of 1-D arrays."""
    B = len(arrays)
    dtype = dtype or arrays[0].dtype
    out = np.full((B, n_pad), fill, dtype=dtype)
    for b, a in enumerate(arrays):
        out[b, : len(a)] = a
    return out

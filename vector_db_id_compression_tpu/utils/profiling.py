"""Profiling/tracing helpers.

The reference's observability is ad-hoc ``time.time()`` in benches and a
purpose-built visited-ids tracer (SURVEY.md §5; altid_impl.cpp:170-231 — our
functional equivalent lives in search/nsg.py:search_and_trace). This module
adds the device-side counterparts:

  - :func:`device_trace`: context manager around ``jax.profiler`` traces
    (view in TensorBoard / xprof);
  - :func:`throughput`: wall-clock throughput of a device computation, each
    run synced with ``jax.block_until_ready``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Tuple

import numpy as np


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a jax.profiler trace of the enclosed block into ``logdir``."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


def throughput(fn: Callable[[], object], items: int, repeats: int = 5,
               warmup: int = 1) -> Tuple[float, float]:
    """(items_per_second, seconds) at the median of ``repeats`` runs of
    ``fn``; each run waits for the device with ``block_until_ready``."""
    import jax

    for _ in range(warmup):
        jax.block_until_ready(fn())
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    secs = float(np.median(times))
    return items / secs, secs

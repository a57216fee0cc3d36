"""The one place that picks how ROC lists are decoded on a backend.

  "kernel"     the Pallas decode kernel compiled for the GPU (ops.roc_pallas)
  "interpret"  the same kernel in Pallas interpret mode — only when a caller
               (a CPU test) asks for it by argument
  "xla"        the plain ``lax.scan`` decoder (codecs.roc_device), on the CPU
               and any other backend

The kernel's data envelope (symbol precision <= 32) is checked here, from
the container's data and before anything compiles; an out-of-envelope
container takes the plain path and the choice is logged. A kernel that
fails to compile raises: no caller catches it.
"""

from __future__ import annotations

import logging
from typing import Optional

import jax

from .roc_pallas import supports

KERNEL, INTERPRET, XLA = "kernel", "interpret", "xla"

log = logging.getLogger(__name__)


def roc_decode_route(max_precision: int, *, platform: Optional[str] = None,
                     interpret: bool = False) -> str:
    """Decode route for lists whose widest symbol has ``max_precision``
    bits, on ``platform`` (default: JAX's default backend)."""
    platform = platform or jax.default_backend()
    if not interpret and platform != "gpu":
        return XLA
    if not supports(max_precision):
        log.warning("ROC ids need %d-bit symbols, past the decode kernel's "
                    "32-bit envelope: decoding with the XLA path",
                    max_precision)
        return XLA
    return INTERPRET if interpret else KERNEL

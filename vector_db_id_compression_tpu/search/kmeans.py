"""Batched Lloyd k-means on the device.

Replaces the reference's use of faiss k-means for IVF training
(search_ivf_qinco.py:44, bench scripts build "IVFxxx,Flat" factory indexes).
Assignment is one [n, d] x [d, k] matmul per iteration, update is a
segment-sum — the whole iteration is a single jitted program.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@partial(jax.jit, static_argnums=(2,))
def _assign_block(x: jax.Array, centroids: jax.Array, block: int = 0) -> jax.Array:
    # ||x-c||^2 = ||x||^2 - 2 x.c + ||c||^2 ; ||x||^2 constant per row
    dots = jnp.dot(x, centroids.T, preferred_element_type=jnp.float32,
                                   precision=jax.lax.Precision.HIGHEST)
    c2 = jnp.sum(centroids * centroids, axis=1)
    return jnp.argmin(c2[None, :] - 2.0 * dots, axis=1).astype(jnp.int32)


def assign(x, centroids, budget: int = 2 ** 28):
    """Nearest centroid per row (L2). x [n, d], centroids [k, d] → i32[n].
    Blocked over rows so the [rows, k] distance slab stays under ``budget``
    f32 elements (10M x 4096 would otherwise be a 160 GB allocation)."""
    n, k = x.shape[0], centroids.shape[0]
    rows = max(1, min(n, budget // max(k, 1)))
    if rows >= n:
        return _assign_block(jnp.asarray(x), jnp.asarray(centroids))
    cent = jnp.asarray(centroids)
    out = np.empty(n, np.int32)
    for s in range(0, n, rows):
        e = min(s + rows, n)
        xb = jnp.asarray(np.asarray(x[s:e], np.float32))
        if e - s < rows:  # pad the tail to reuse the compiled block
            xb = jnp.pad(xb, ((0, rows - (e - s)), (0, 0)))
        out[s:e] = np.asarray(_assign_block(xb, cent))[: e - s]
    return jnp.asarray(out)


@jax.jit
def _update(x: jax.Array, assignment: jax.Array, k: int, key: jax.Array, centroids):
    d = x.shape[1]
    sums = jax.ops.segment_sum(x, assignment, num_segments=centroids.shape[0])
    counts = jax.ops.segment_sum(
        jnp.ones(x.shape[0], dtype=jnp.float32), assignment,
        num_segments=centroids.shape[0],
    )
    # empty clusters: re-seed from random data points
    rand_idx = jax.random.randint(key, (centroids.shape[0],), 0, x.shape[0])
    fallback = x[rand_idx]
    new = jnp.where(
        (counts > 0)[:, None], sums / jnp.maximum(counts, 1.0)[:, None], fallback
    )
    return new


def train_kmeans(
    x: np.ndarray, k: int, niter: int = 20, seed: int = 1234,
    max_points_per_centroid: int = 256,
) -> np.ndarray:
    """Returns centroids f32[k, d]. Training subsamples to
    ``max_points_per_centroid * k`` points (the faiss clustering default) —
    beyond that extra points don't move the centroids but do cost a full
    blocked assign per iteration."""
    x = np.asarray(x, dtype=np.float32)
    cap = max_points_per_centroid * k
    if len(x) > cap:
        sel = np.random.default_rng(seed).choice(len(x), cap, replace=False)
        x = x[sel]
    x = jnp.asarray(x)
    key = jax.random.PRNGKey(seed)
    key, sub = jax.random.split(key)
    init_idx = jax.random.choice(sub, x.shape[0], (k,), replace=False)
    centroids = x[init_idx]
    for _ in range(niter):
        key, sub = jax.random.split(key)
        a = assign(x, centroids)
        centroids = _update(x, a, k, sub, centroids)
    return np.asarray(centroids)

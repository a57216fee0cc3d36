"""Product quantizer (PQ) for IVF payload codes.

The reference stores Faiss PQ codes as the invlist payload (index factory
strings like "IVF1024,PQ16" in bench_invlists.py:50-64). This is a
from-scratch PQ: M subspaces x ksub=256 centroids trained by k-means per
subspace (matmuls), encode = per-subspace argmin, asymmetric distance =
LUT built from the query and summed over code columns.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from .kmeans import train_kmeans, assign


@dataclass
class ProductQuantizer:
    d: int
    M: int
    ksub: int = 256
    centroids: np.ndarray | None = None  # f32[M, ksub, dsub]

    @property
    def dsub(self) -> int:
        return self.d // self.M

    @property
    def code_size(self) -> int:
        return self.M  # one byte per subspace (ksub=256)

    def train(self, x: np.ndarray, niter: int = 15, seed: int = 5678):
        assert self.d % self.M == 0
        x = np.asarray(x, dtype=np.float32)
        cents = np.zeros((self.M, self.ksub, self.dsub), dtype=np.float32)
        for m in range(self.M):
            sub = x[:, m * self.dsub : (m + 1) * self.dsub]
            k = min(self.ksub, len(sub))
            cents[m, :k] = train_kmeans(sub, k, niter=niter, seed=seed + m)
            if k < self.ksub:
                cents[m, k:] = cents[m, :1]
        self.centroids = cents

    def encode(self, x: np.ndarray) -> np.ndarray:
        """u8[n, M] codes. Row-blocked so each block uploads ONCE and all M
        subspace assignments run on that resident block — routing device
        slices through the generic blocked ``assign`` re-downloaded and
        re-uploaded every sub-block."""
        from .kmeans import _assign_block

        x = np.asarray(x, np.float32)
        n = len(x)
        out = np.empty((n, self.M), np.uint8)
        R = 1_000_000  # [R, ksub] f32 distance slab stays ~1 GB
        cents = [jnp.asarray(self.centroids[m]) for m in range(self.M)]
        for s in range(0, n, R):
            xb = jnp.asarray(x[s: s + R])
            pend = [
                _assign_block(xb[:, m * self.dsub: (m + 1) * self.dsub],
                              cents[m])
                for m in range(self.M)
            ]
            for m, a in enumerate(pend):  # all dispatched before any pull
                out[s: s + R, m] = np.asarray(a)
        return out

    def decode(self, codes: np.ndarray) -> np.ndarray:
        """f32[n, d] reconstruction."""
        codes = np.asarray(codes)
        out = np.zeros((len(codes), self.d), dtype=np.float32)
        for m in range(self.M):
            out[:, m * self.dsub : (m + 1) * self.dsub] = self.centroids[m][codes[:, m]]
        return out

    def compute_luts(self, xq: jax.Array) -> jax.Array:
        """Asymmetric distance LUTs f32[nq, M, ksub]: squared L2 from each
        query subvector to every subspace centroid."""
        nq = xq.shape[0]
        xs = xq.reshape(nq, self.M, self.dsub)
        c = jnp.asarray(self.centroids)  # [M, ksub, dsub]
        dots = jnp.einsum("qmd,mkd->qmk", xs, c,
                          preferred_element_type=jnp.float32,
                          precision=jax.lax.Precision.HIGHEST)
        c2 = jnp.sum(c * c, axis=2)  # [M, ksub]
        x2 = jnp.sum(xs * xs, axis=2)  # [nq, M]
        return x2[:, :, None] - 2.0 * dots + c2[None, :, :]

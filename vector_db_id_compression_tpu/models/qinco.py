"""QINCo-style neural residual quantizer (flax), the flagship model.

The reference's large-scale pipeline (search_ivf_qinco.py:185-315) loads a
pretrained *torch* QINCo model and uses it only to decode shortlist codes for
neural re-ranking after deferred-ID-decoding search. This module provides a
JAX equivalent: an implicit neural codebook residual quantizer
(QINCo-family: each step's codebook is conditioned on the prefix
reconstruction through a small MLP), with

  - ``decode``: codes u8/i32[B, M] -> reconstruction f32[B, d] — the op the
    search pipeline calls on shortlists (search_ivf_qinco.py:282-287);
  - ``encode``: greedy per-step argmin over adapted codebooks;
  - ``make_train_step``: full jittable training step (reconstruction loss
    through all quantization steps, straight-through codeword selection,
    adam) designed to shard as dp over batch x tp over the hidden dimension.

Everything is dense batched matmul ([B, ksub, *] x [*, hidden]).
"""

from __future__ import annotations

from functools import partial
from typing import Any, NamedTuple, Tuple

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax


class QincoStep(nn.Module):
    """One residual step: codebook adapted by conditioning on x_hat."""

    d: int
    ksub: int
    hidden: int

    @nn.compact
    def __call__(self, x_hat: jax.Array) -> jax.Array:
        """x_hat [B, d] -> adapted codebook [B, ksub, d]."""
        # dtype pinned: x64 mode is enabled package-wide for the codec layer,
        # but the model must stay f32
        base = self.param(
            "codebook", nn.initializers.normal(0.02), (self.ksub, self.d),
            jnp.float32,
        )
        B = x_hat.shape[0]
        cond = jnp.broadcast_to(x_hat[:, None, :], (B, self.ksub, self.d))
        h = jnp.concatenate(
            [jnp.broadcast_to(base[None], (B, self.ksub, self.d)), cond], axis=-1
        )
        h = nn.Dense(self.hidden, name="adapt_in")(h)
        h = nn.relu(h)
        delta = nn.Dense(self.d, name="adapt_out")(h)
        return base[None] + delta


class Qinco(nn.Module):
    """M-step residual quantizer with implicit neural codebooks."""

    d: int
    M: int
    ksub: int = 256
    hidden: int = 256

    def setup(self):
        self.steps = [
            QincoStep(self.d, self.ksub, self.hidden, name=f"step{m}")
            for m in range(self.M)
        ]

    def decode(self, codes: jax.Array) -> jax.Array:
        """codes i32[B, M] -> x_hat f32[B, d]."""
        B = codes.shape[0]
        x_hat = jnp.zeros((B, self.d), dtype=jnp.float32)
        for m in range(self.M):
            cb = self.steps[m](x_hat)                       # [B, ksub, d]
            sel = jnp.take_along_axis(
                cb, codes[:, m][:, None, None].astype(jnp.int32), axis=1
            )[:, 0]
            x_hat = x_hat + sel
        return x_hat

    def encode(self, x: jax.Array) -> Tuple[jax.Array, jax.Array]:
        """x [B, d] -> (codes i32[B, M], x_hat f32[B, d]), greedy argmin."""
        B = x.shape[0]
        x_hat = jnp.zeros_like(x)
        codes = []
        for m in range(self.M):
            cb = self.steps[m](x_hat)
            r = x - x_hat
            d2 = jnp.sum((cb - r[:, None, :]) ** 2, axis=-1)  # [B, ksub]
            c = jnp.argmin(d2, axis=-1).astype(jnp.int32)
            sel = jnp.take_along_axis(cb, c[:, None, None], axis=1)[:, 0]
            x_hat = x_hat + sel
            codes.append(c)
        return jnp.stack(codes, axis=1), x_hat

    def __call__(self, x: jax.Array) -> jax.Array:
        """Training forward: total reconstruction loss across steps (deep
        supervision on every prefix, straight-through selection)."""
        x_hat = jnp.zeros_like(x)
        loss = 0.0
        for m in range(self.M):
            cb = self.steps[m](x_hat)
            r = x - x_hat
            d2 = jnp.sum((cb - r[:, None, :]) ** 2, axis=-1)
            c = jnp.argmin(jax.lax.stop_gradient(d2), axis=-1)
            sel = jnp.take_along_axis(cb, c[:, None, None], axis=1)[:, 0]
            x_hat = x_hat + sel
            loss = loss + jnp.mean(jnp.sum((x - x_hat) ** 2, axis=-1))
        return loss / self.M


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: jax.Array


class QincoCodec:
    """Trained-QINCo vector quantizer with the surface the IVF pipeline needs
    (the JAX analogue of the reference's faiss-RQ + torch-QINCo pair,
    search_ivf_qinco.py:185-315):

      - ``train(x)``: fit the model on (residual) vectors;
      - ``encode(x) -> u8[B, M]``: greedy neural encoding;
      - ``decode(codes) -> f32[B, d]``: neural reconstruction (re-rank path);
      - ``lin_codebooks f32[M, ksub, d]``: the per-step *base* codebooks —
        the linear additive part of the model, used for LUT scanning (the
        analogue of scanning with the plain RQ decoder while QINCo decodes
        the same codes better);
      - ``compute_luts(xq) -> f32[nq, M, ksub]`` of −2⟨x, C_m[j]⟩ terms and
      - ``lin_decode(codes)`` / per-vector ``lin_norms`` for the AQ distance
        d(x, x̂) = ‖x̂‖² − 2Σ_m ⟨x, C_m[c_m]⟩ + ‖x‖².
    """

    def __init__(self, d: int, M: int, ksub: int = 256, hidden: int = 256,
                 lr: float = 1e-3, seed: int = 0):
        assert ksub <= 256, "codes are stored as uint8"
        self.model = Qinco(d=d, M=M, ksub=ksub, hidden=hidden)
        self.d, self.M, self.ksub = d, M, ksub
        self.lr = lr
        self.seed = seed
        self.params: Any = None

    def _rq_init_params(self, params, x: np.ndarray):
        """Residual-quantizer init: set each step's base codebook to k-means
        centroids of the running residuals (the classic RQ recipe), so adam
        only has to learn the neural deltas."""
        from ..search.kmeans import assign, train_kmeans

        params = jax.tree_util.tree_map(lambda a: a, dict(params))  # copy
        resid = np.asarray(x, np.float32).copy()
        for m in range(self.M):
            cb = np.asarray(train_kmeans(resid, self.ksub, niter=10))
            a = np.asarray(assign(jnp.asarray(resid), jnp.asarray(cb)))
            resid -= cb[a]
            params["params"][f"step{m}"]["codebook"] = jnp.asarray(cb)
        return params

    def train(self, x: np.ndarray, steps: int = 300, batch_size: int = 256,
              verbose: bool = False, rq_init: bool = True):
        x = np.asarray(x, np.float32)
        n = len(x)
        batch_size = min(batch_size, n)
        init_fn, train_step = make_train_step(self.model, self.lr)
        state = init_fn(jax.random.PRNGKey(self.seed), jnp.asarray(x[:8]))
        if rq_init:
            state = state._replace(params=self._rq_init_params(state.params, x))
        step = jax.jit(train_step)
        rng = np.random.default_rng(self.seed)
        for i in range(steps):
            batch = jnp.asarray(x[rng.choice(n, batch_size, replace=False)])
            state, loss = step(state, batch)
            if verbose and i % 50 == 0:
                print(f"  qinco step {i}: loss {float(loss):.4f}", flush=True)
        self.params = state.params
        # jitted inference closures capture params at trace time — drop any
        # callables traced against previous weights
        self.__dict__.pop("_jit_cache", None)
        return self

    # --------------------------------------------------------------- inference

    def _apply(self, method, *args):
        return self.model.apply(self.params, *args, method=method)

    def _jitted(self, name: str, fn):
        """Cache jitted inference callables — a fresh jax.jit per call would
        retrace the whole unrolled model every invocation."""
        cache = self.__dict__.setdefault("_jit_cache", {})
        if name not in cache:
            cache[name] = jax.jit(fn)
        return cache[name]

    def encode(self, x: np.ndarray, batch: int = 16384) -> np.ndarray:
        # batch sizes the [batch, ksub, d] codebook tensor (~512 MB at the
        # default); bigger batches amortize the per-dispatch round trip
        enc = self._jitted("encode",
                           lambda xb: self._apply(Qinco.encode, xb)[0])
        out = []
        for s in range(0, len(x), batch):
            xb = np.asarray(x[s:s + batch], np.float32)
            pad = 0
            if len(xb) < batch and s > 0:
                pad = batch - len(xb)
                xb = np.pad(xb, ((0, pad), (0, 0)))
            c = np.asarray(enc(jnp.asarray(xb)))
            out.append(c[: len(c) - pad])
        return np.concatenate(out).astype(np.uint8)

    def decode(self, codes: np.ndarray, batch: int = 32768) -> np.ndarray:
        # fixed-size batches: one compiled shape, and the decode working set
        # stays bounded — each step materializes the [B, ksub, d] conditional
        # codebook (~1 GB at the default), so a 200k-code one-shot decode
        # OOMed the 10M sweep where the chip already held the scan payloads
        dec = self._jitted("decode", lambda c: self._apply(Qinco.decode, c))
        if len(codes) <= batch:
            return np.asarray(dec(jnp.asarray(codes, jnp.int32)))
        out = []
        for s in range(0, len(codes), batch):
            cb = np.asarray(codes[s:s + batch], np.int32)
            pad = batch - len(cb)
            if pad:
                cb = np.pad(cb, ((0, pad), (0, 0)))
            d = np.asarray(dec(jnp.asarray(cb)))
            out.append(d[: len(d) - pad] if pad else d)
        return np.concatenate(out)

    @property
    def lin_codebooks(self) -> np.ndarray:
        cbs = [
            np.asarray(self.params["params"][f"step{m}"]["codebook"])
            for m in range(self.M)
        ]
        return np.stack(cbs)  # [M, ksub, d]

    def lin_decode(self, codes: np.ndarray) -> np.ndarray:
        cb = self.lin_codebooks
        codes = np.asarray(codes, np.int64)
        out = np.zeros((len(codes), self.d), np.float32)
        for m in range(self.M):
            out += cb[m][codes[:, m]]
        return out

    def lin_norms(self, codes: np.ndarray) -> np.ndarray:
        xl = self.lin_decode(codes)
        return (xl * xl).sum(axis=1).astype(np.float32)

    def compute_luts(self, xq) -> jax.Array:
        """f32[nq, M, ksub]: −2⟨x, C_m[j]⟩."""
        cb = jnp.asarray(self.lin_codebooks)  # [M, ksub, d]
        return -2.0 * jnp.einsum("qd,mkd->qmk", jnp.asarray(xq), cb,
                                 preferred_element_type=jnp.float32)


def make_train_step(model: Qinco, lr: float = 1e-3):
    """Returns (init_fn, train_step). train_step is a pure jittable function
    (params/opt sharded by the caller; batch dp-sharded)."""
    tx = optax.adam(lr)

    def init_fn(rng, sample):
        params = model.init(rng, sample)
        return TrainState(params, tx.init(params), jnp.zeros((), jnp.int32))

    def train_step(state: TrainState, batch: jax.Array):
        loss, grads = jax.value_and_grad(
            lambda p: model.apply(p, batch)
        )(state.params)
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        return TrainState(params, opt_state, state.step + 1), loss

    return init_fn, train_step

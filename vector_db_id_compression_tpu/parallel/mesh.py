"""Device-mesh parallelism for the codec and model layers.

The reference has no distributed runtime at all — its parallelism is OpenMP
over lists on one CPU (SURVEY.md §2.4, custom_invlists_impl.cpp:147). The
device-mesh equivalent: the unit of parallelism is the (inverted/adjacency)
list, sharded over a 1-D "lists" mesh axis with ``shard_map``; every lane of
the batched codecs is independent, so encode/decode scale linearly with no
collectives in the hot loop. Gathers of compressed state for serialization
ride ``jax.lax.all_gather`` in deterministic lane order, so the N-device
artifact is bit-identical to the 1-device artifact by construction.

Model training (models.qinco) shards dp over batch x tp over hidden; see
``shard_qinco_train_step``.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..codecs import roc_device as rd


def make_lists_mesh(n_devices: Optional[int] = None) -> Mesh:
    devs = jax.devices()[: n_devices or len(jax.devices())]
    return Mesh(np.array(devs), axis_names=("lists",))


def sharded_roc_encode(
    mesh: Mesh,
    sorted_ids: jax.Array,   # u64[B, n_max], B divisible by mesh size
    lengths: jax.Array,      # i32[B]
    precision: jax.Array,    # i32[B]
    cap: int,
) -> Tuple[rd.RocStates, jax.Array]:
    """ROC-encode B lists sharded over the 'lists' axis. Returns fully
    replicated (gathered) states + order so the host can serialize the
    artifact in deterministic list order."""
    n_max = sorted_ids.shape[1]
    pool = rd.default_pool(n_max)

    def local(ids_l, len_l, prec_l):
        states = rd.fresh_states(ids_l.shape[0], cap)
        # mark the per-shard initial states as device-varying so the scan
        # carry types line up under shard_map's varying-axis typing
        states = jax.tree_util.tree_map(
            lambda a: jax.lax.pcast(a, "lists", to="varying"), states
        )
        st, order = rd.roc_encode_batch(ids_l, len_l, prec_l, pool, states)
        return st, order

    # outputs stay lane-sharded; the returned global arrays are assembled in
    # deterministic list order by construction (shard i holds lists i*B/N..)
    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P("lists"), P("lists"), P("lists")),
        out_specs=(
            rd.RocStates(P("lists"), P("lists"), P("lists"), P("lists"), P("lists")),
            P("lists"),
        ),
    )
    return jax.jit(fn)(sorted_ids, lengths, precision)


def sharded_roc_decode(
    mesh: Mesh,
    states: rd.RocStates,    # replicated or host arrays, B lanes
    lengths: jax.Array,
    precision: jax.Array,
    n_max: int,
) -> jax.Array:
    """Decode B lists sharded over the 'lists' axis → gathered ids [B, n_max]."""
    pool = rd.default_pool(n_max)

    def local(st, len_l, prec_l):
        ids, _ = rd.roc_decode_batch(st, len_l, prec_l, pool, n_max)
        return ids

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(
            rd.RocStates(P("lists"), P("lists"), P("lists"), P("lists"), P("lists")),
            P("lists"),
            P("lists"),
        ),
        out_specs=P("lists"),
    )
    return jax.jit(fn)(states, lengths, precision)


def sharded_size_accounting(
    mesh: Mesh,
    states: rd.RocStates,     # lane-sharded over 'lists'
    lengths: jax.Array,       # i32[B] lane-sharded
) -> Tuple[jax.Array, jax.Array]:
    """Global compressed-size accounting with a psum over the 'lists' axis
    (SURVEY.md §2.4: the collective replacing the reference's serial size
    loops, custom_invlists_impl.cpp:196-207 — including NOT reproducing its
    O(nlist^2) codes_size accounting bug). Returns replicated
    (total_bytes, total_ids) scalars."""

    def local(stack_len, len_l):
        local_bytes = jnp.sum(jnp.where(
            len_l > 0, 8 + 4 * stack_len.astype(jnp.int64), jnp.int64(0)))
        local_ids = jnp.sum(len_l.astype(jnp.int64))
        return (jax.lax.psum(local_bytes, "lists"),
                jax.lax.psum(local_ids, "lists"))

    fn = shard_map(
        local, mesh=mesh,
        in_specs=(P("lists"), P("lists")),
        out_specs=(P(), P()),
    )
    return jax.jit(fn)(states.stack_len, lengths)


def shard_qinco_train_step(mesh: Mesh, train_step, state, batch):
    """Jit the model train step over a (dp, tp) mesh: batch dp-sharded,
    params replicated over dp and (where profitable) tp-sharded by XLA's
    sharding propagation from the batch constraint."""
    dp_sharding = NamedSharding(mesh, P("dp"))
    batch = jax.device_put(batch, dp_sharding)
    stepped = jax.jit(
        train_step,
        in_shardings=(None, dp_sharding),
        out_shardings=None,
    )
    return stepped(state, batch)

"""Multikey encrypted aggregation over a client mesh axis.

Generalizes the reference's 2-client ``aggregateEncryptedWeights``
(server/src/aggregateEncryptedWeights.cpp:68-115: EvalAdd + EvalMult 0.5) to
N clients as a device collective: each mesh shard holds its clients' ciphertexts
(already PRE'd into the common key domain); the homomorphic sum is a
``jax.lax.psum`` of residue stacks over the ``client`` axis — modular
reduction is restored locally afterwards, exploiting q < 2^60 so up to 2^4
raw u64 sums cannot wrap (for larger N the shards pre-reduce in a tree).

The 1/N averaging folds into a single scalar EvalMult + rescale on the
aggregated ciphertext (FLEXIBLEAUTO semantics, scale-preserving).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.modarith import U64
from . import eval as ev
from .params import CkksContext
from .types import Ciphertext


def _psum_mod(x, q, axis_name):
    """Modular psum: values < q < 2^60, so a raw u64 psum of up to 16 shards
    cannot overflow; fold back into [0, q) with at most 4 conditional subs."""
    s = jax.lax.psum(x, axis_name)
    for _ in range(4):  # log2(16): each pass halves the overshoot
        s = jnp.where(s >= q * jnp.uint64(8), s - q * jnp.uint64(8), s)
        s = jnp.where(s >= q, s - q, s)
    return jnp.where(s >= q, s - q, s)


def _reduce_mod_full(x, q):
    """General reduction of a raw sum of up to 2^4 residues into [0, q)."""
    for shift in (3, 2, 1, 0):
        s = q * jnp.uint64(1 << shift)
        x = jnp.where(x >= s, x - s, x)
    return x


def aggregate_local(ctx: CkksContext, cts: list[Ciphertext], scale_by_count: bool = True) -> Ciphertext:
    """Single-device N-ciphertext FedAvg (the 2-client reference path)."""
    out = cts[0]
    for ct in cts[1:]:
        out = ev.add(ctx, out, ct)
    if scale_by_count:
        out = ev.mult_scalar(ctx, out, 1.0 / len(cts))
    return out


def aggregate_sharded(
    ctx: CkksContext,
    ct_stack,                # u64[clients_local, B, k, l, n] per shard
    mesh: Mesh,
    scale: float,
    n_clients_total: int,
    average: bool = True,
):
    """Mesh-parallel encrypted FedAvg.

    ``ct_stack`` is the per-shard slice of the (n_clients, B, 2, l, n)
    residue stack (all ciphertexts already in the common key domain). Returns
    a replicated aggregated Ciphertext batch (B, 2, l, n).
    """
    l = ct_stack.shape[-2]
    q = ctx.q_vec[:l]

    def shard_fn(local):
        # local: (clients_local, B, k, l, n) — tree-reduce locally mod q…
        acc = local[0]
        for i in range(1, local.shape[0]):
            s = acc + local[i]
            acc = jnp.where(s >= q, s - q, s)
        # …then one modular psum across the client axis.
        return _psum_mod(acc, q, "client")

    spec_in = P("client", None, None, None, None)
    spec_out = P(None, None, None, None)
    agg = jax.jit(
        jax.shard_map(shard_fn, mesh=mesh, in_specs=(spec_in,), out_specs=spec_out)
    )(ct_stack)  # (B, k, l, n) replicated
    if not average:
        return Ciphertext(data=agg, scale=scale)
    factor = 1.0 / n_clients_total
    avg = jax.vmap(
        lambda d: ev.mult_scalar(ctx, Ciphertext(d, scale=scale), factor).data
    )(agg)
    # mult_scalar encodes 1/N at scale q_last then rescales, so the scale is
    # preserved (FLEXIBLEAUTO) while the limb count drops by one.
    return Ciphertext(data=avg, scale=scale)

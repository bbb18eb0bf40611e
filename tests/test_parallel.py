"""Mesh-parallel tests on the virtual 8-device CPU mesh (SURVEY.md §2.5 —
client-axis psum aggregation, GSPMD-sharded encrypted FedAvg step)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ppqsflhe.ckks import eval as ev
from ppqsflhe.ckks.multikey import aggregate_sharded, aggregate_local
from ppqsflhe.ckks.params import CkksParams
from ppqsflhe.ckks.scheme import CkksScheme
from ppqsflhe.ckks.types import Ciphertext
from ppqsflhe.parallel.mesh import make_mesh


@pytest.fixture(scope="module")
def sch():
    return CkksScheme(CkksParams.generate(n=128, mult_depth=2, scale_bits=40, dnum=2))


def test_eight_devices_available():
    assert len(jax.devices()) == 8


def test_aggregate_sharded_matches_local(sch):
    """psum-over-client-axis FedAvg == sequential EvalAdd chain."""
    n_clients, B = 8, 2
    sk, pk = sch.keygen(jax.random.PRNGKey(0))
    vecs = [np.random.default_rng(i).uniform(-1, 1, sch.encoder.slots)
            for i in range(n_clients)]
    cts = [[sch.encrypt_values(pk, v, jax.random.PRNGKey(100 + 10 * i + b))
            for b in range(B)] for i, v in enumerate(vecs)]
    stack = jnp.stack([jnp.stack([ct.data for ct in row]) for row in cts])
    mesh = make_mesh({"client": 8})
    scale = cts[0][0].scale
    agg = aggregate_sharded(sch.ctx, stack, mesh, scale, n_clients)
    want_mean = np.mean(vecs, axis=0)
    for b in range(B):
        got = sch.decrypt(sk, Ciphertext(agg.data[b], scale=agg.scale))
        np.testing.assert_allclose(got, want_mean, atol=1e-4)
    # cross-check vs the sequential path
    local = aggregate_local(sch.ctx, [row[0] for row in cts])
    got_local = sch.decrypt(sk, local)
    np.testing.assert_allclose(got_local, want_mean, atol=1e-4)


def test_gspmd_sharded_fedavg_step(sch):
    """jit + NamedSharding over (client × coef): XLA inserts the collectives."""
    mesh = make_mesh({"client": 2, "coef": 4})
    L = sch.params.num_q
    n = sch.params.n
    n_clients = 4
    rng = np.random.default_rng(0)
    stack = np.stack([
        np.stack([rng.integers(0, q, (2, n), dtype=np.uint64)
                  for q in sch.params.q_moduli], axis=1)
        for _ in range(n_clients)
    ])
    q_vec = sch.ctx.q_vec[:L]
    scale = sch.params.scale

    def step(cts):
        acc = cts[0]
        for i in range(1, cts.shape[0]):
            s = acc + cts[i]
            acc = jnp.where(s >= q_vec, s - q_vec, s)
        return ev.mult_scalar(sch.ctx, Ciphertext(acc, scale), 1.0 / cts.shape[0]).data

    in_sh = NamedSharding(mesh, P("client", None, None, "coef"))
    out_sh = NamedSharding(mesh, P(None, None, "coef"))
    fn = jax.jit(step, in_shardings=in_sh, out_shardings=out_sh)
    with mesh:
        sharded = jax.device_put(jnp.asarray(stack), in_sh)
        out = fn(sharded)
        out.block_until_ready()
    want = np.asarray(step(jnp.asarray(stack)))
    np.testing.assert_array_equal(np.asarray(out), want)


def test_graft_entry_contract():
    import sys
    sys.path.insert(0, "/root/repo")
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    assert out.shape[0] == 2

    ge.dryrun_multichip(8)

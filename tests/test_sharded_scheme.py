"""Full-scheme coefficient sharding (parallel/sharded_scheme.py): the
UNCHANGED ckks.eval key-switch/PRE/FedAvg code executing under shard_map
over a client × coef mesh must be BIT-EXACT vs the replicated fourstep path
(one all-to-all per transform; one psum for the aggregation)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh

from ppqsflhe.ckks import eval as ev
from ppqsflhe.ckks.params import CkksParams
from ppqsflhe.ckks.scheme import CkksScheme
from ppqsflhe.ckks.types import Ciphertext
from ppqsflhe.core.modarith import modadd
from ppqsflhe.parallel.sharded_scheme import (
    ShardedEvalContext, fedavg_round_sharded, re_encrypt_sharded)


@pytest.fixture(scope="module")
def setup():
    params = CkksParams.generate(n=256, mult_depth=2, scale_bits=40, dnum=2,
                                 ntt_backend="fourstep", ntt_impl="xla")
    sch = CkksScheme(params)
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("client", "coef"))
    sctx = ShardedEvalContext(params, mesh, axis="coef")
    return params, sch, mesh, sctx


def test_sharded_ntt_roundtrip_matches_replicated(setup):
    """sctx.ntt/intt under shard_map == the replicated fourstep transform."""
    from jax.sharding import PartitionSpec as P

    params, sch, mesh, sctx = setup
    rng = np.random.default_rng(0)
    L = params.num_q
    x = jnp.asarray(np.stack([
        rng.integers(0, q, params.n, dtype=np.uint64) for q in params.q_moduli
    ]))
    idx = tuple(range(L))
    want = sch.ctx.ntt(x, idx)

    n1, n2 = sctx.n1, sctx.n2
    D = sctx.D

    def body(xm):
        return sctx.ntt(xm.reshape(L, -1), idx).reshape(L, n2, n1 // D)

    got = jax.jit(jax.shard_map(
        body, mesh=mesh, check_vma=False, in_specs=(P(None, None, "coef"),),
        out_specs=P(None, None, "coef"),
    ))(x.reshape(L, n1, n2)).reshape(L, -1)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))

    def body_inv(xm):
        return sctx.intt(xm.reshape(L, -1), idx).reshape(L, n1, n2 // D)

    back = jax.jit(jax.shard_map(
        body_inv, mesh=mesh, check_vma=False, in_specs=(P(None, None, "coef"),),
        out_specs=P(None, None, "coef"),
    ))(got.reshape(L, n2, n1)).reshape(L, -1)
    np.testing.assert_array_equal(np.asarray(back), np.asarray(x))


def test_re_encrypt_sharded_bitexact(setup):
    params, sch, mesh, sctx = setup
    sk_a, pk_a = sch.keygen(jax.random.PRNGKey(1))
    sk_b, pk_b = sch.keygen(jax.random.PRNGKey(2))
    rk = sch.rekey_gen(sk_a, pk_b, jax.random.PRNGKey(3))
    v = np.random.default_rng(1).uniform(-1, 1, sch.encoder.slots)
    ct = sch.encrypt_values(pk_a, v, jax.random.PRNGKey(4))

    want = sch.re_encrypt(ct, rk)
    got = re_encrypt_sharded(sctx, ct, rk)
    np.testing.assert_array_equal(np.asarray(got.data), np.asarray(want.data))
    np.testing.assert_allclose(sch.decrypt(sk_b, got), v, atol=1e-4)


def test_fedavg_round_sharded_bitexact(setup):
    """The complete server round (PRE in → psum FedAvg → PRE back) over the
    client × coef mesh equals the replicated computation bit-for-bit."""
    params, sch, mesh, sctx = setup
    rng = np.random.default_rng(2)
    sk1, pk1 = sch.keygen(jax.random.PRNGKey(10))
    sk2, pk2 = sch.keygen(jax.random.PRNGKey(11))
    rk12 = sch.rekey_gen(sk1, pk2, jax.random.PRNGKey(12))
    rk21 = sch.rekey_gen(sk2, pk1, jax.random.PRNGKey(13))
    B = 2
    vs1 = [rng.uniform(-1, 1, sch.encoder.slots) for _ in range(B)]
    vs2 = [rng.uniform(-1, 1, sch.encoder.slots) for _ in range(B)]
    cts1 = [sch.encrypt_values(pk1, v, jax.random.PRNGKey(20 + i))
            for i, v in enumerate(vs1)]
    cts2 = [sch.encrypt_values(pk2, v, jax.random.PRNGKey(30 + i))
            for i, v in enumerate(vs2)]
    scale = cts1[0].scale

    # replicated reference: client 1 → hub (client 2) domain, FedAvg, back
    want_agg, want_back = [], []
    for c1, c2 in zip(cts1, cts2):
        c1in2 = sch.re_encrypt(c1, rk12)
        avg = sch.mult_scalar(sch.add(c1in2, c2), 0.5)
        want_agg.append(avg.data)
        want_back.append(sch.re_encrypt(avg, rk21).data)

    stacks = jnp.stack([jnp.stack([c.data for c in cts1]),
                        jnp.stack([c.data for c in cts2])])
    agg, back = fedavg_round_sharded(sctx, stacks, rk12.data, rk21.data, scale)

    np.testing.assert_array_equal(np.asarray(agg),
                                  np.asarray(jnp.stack(want_agg)))
    np.testing.assert_array_equal(np.asarray(back),
                                  np.asarray(jnp.stack(want_back)))
    # and it decrypts to the plaintext FedAvg
    l = want_agg[0].shape[1]
    for b in range(B):
        got = sch.decrypt(sk2, Ciphertext(jnp.asarray(agg[b]),
                                          scale=scale))
        np.testing.assert_allclose(got, (vs1[b] + vs2[b]) / 2, atol=1e-4)


def test_rotate_sharded_bitexact(setup):
    """Sharded Galois rotation (one all_gather for the cross-shard bin
    permutation + sharded key switch) == replicated ev.rotate, bit-exact;
    and it decrypts to the rolled plaintext."""
    from ppqsflhe.parallel.sharded_scheme import (
        conjugate_sharded, rotate_hoisted_sharded, rotate_sharded)

    params, sch, mesh, sctx = setup
    sk, pk = sch.keygen(jax.random.PRNGKey(40))
    rots = [1, 3]
    rot_keys = sch.rotation_key_gen(sk, rots, jax.random.PRNGKey(41))
    v = np.random.default_rng(3).uniform(-1, 1, sch.encoder.slots)
    ct = sch.encrypt_values(pk, v, jax.random.PRNGKey(42))

    for r in rots:
        want = sch.rotate(ct, r, rot_keys)
        got = rotate_sharded(sctx, ct, r, rot_keys[r])
        np.testing.assert_array_equal(np.asarray(got.data),
                                      np.asarray(want.data))
        np.testing.assert_allclose(sch.decrypt(sk, got), np.roll(v, -r),
                                   atol=1e-4)

    # hoisted: one sharded decompose+extend shared across both rotations
    want_h = sch.rotate_hoisted(ct, rots, rot_keys)
    got_h = rotate_hoisted_sharded(sctx, ct, rots, rot_keys)
    for w, g in zip(want_h, got_h):
        np.testing.assert_array_equal(np.asarray(g.data), np.asarray(w.data))

    ck = sch.conjugation_key_gen(sk, jax.random.PRNGKey(43))
    want_c = sch.conjugate(ct, ck)
    got_c = conjugate_sharded(sctx, ct, ck)
    np.testing.assert_array_equal(np.asarray(got_c.data),
                                  np.asarray(want_c.data))


@pytest.fixture(scope="module")
def setup_mxu():
    """The sharded fast path: ntt_impl='mxu' runs each shard's column
    transforms as int8 digit-matmuls around the one all-to-all."""
    params = CkksParams.generate(n=256, mult_depth=2, scale_bits=40, dnum=2,
                                 ntt_backend="fourstep", ntt_impl="mxu")
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("client", "coef"))
    sctx = ShardedEvalContext(params, mesh, axis="coef")
    assert sctx.impl == "mxu"
    return params, mesh, sctx


def test_sharded_mxu_ntt_matches_replicated(setup, setup_mxu):
    """Sharded MXU digit-matmul transforms == replicated xla, bit-exact."""
    from jax.sharding import PartitionSpec as P

    _, sch, _, _ = setup
    params, mesh, sctx = setup_mxu
    rng = np.random.default_rng(7)
    L = params.num_q
    x = jnp.asarray(np.stack([
        rng.integers(0, q, params.n, dtype=np.uint64) for q in params.q_moduli
    ]))
    idx = tuple(range(L))
    want = sch.ctx.ntt(x, idx)
    n1, n2, D = sctx.n1, sctx.n2, sctx.D

    got = jax.jit(jax.shard_map(
        lambda xm: sctx.ntt(xm.reshape(L, -1), idx).reshape(L, n2, n1 // D),
        mesh=mesh, check_vma=False, in_specs=(P(None, None, "coef"),),
        out_specs=P(None, None, "coef"),
    ))(x.reshape(L, n1, n2)).reshape(L, -1)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))

    back = jax.jit(jax.shard_map(
        lambda xm: sctx.intt(xm.reshape(L, -1), idx).reshape(L, n1, n2 // D),
        mesh=mesh, check_vma=False, in_specs=(P(None, None, "coef"),),
        out_specs=P(None, None, "coef"),
    ))(jnp.asarray(got).reshape(L, n2, n1)).reshape(L, -1)
    np.testing.assert_array_equal(np.asarray(back), np.asarray(x))


def test_fedavg_round_sharded_mxu_bitexact(setup, setup_mxu):
    """The full server round on the sharded FAST path equals the replicated
    xla computation bit-for-bit (the keyswitch NTTs run as per-shard int8
    MXU digit-matmuls)."""
    _, sch, _, _ = setup
    params, mesh, sctx = setup_mxu
    rng = np.random.default_rng(8)
    sk1, pk1 = sch.keygen(jax.random.PRNGKey(50))
    sk2, pk2 = sch.keygen(jax.random.PRNGKey(51))
    rk12 = sch.rekey_gen(sk1, pk2, jax.random.PRNGKey(52))
    rk21 = sch.rekey_gen(sk2, pk1, jax.random.PRNGKey(53))
    vs1 = rng.uniform(-1, 1, sch.encoder.slots)
    vs2 = rng.uniform(-1, 1, sch.encoder.slots)
    ct1 = sch.encrypt_values(pk1, vs1, jax.random.PRNGKey(54))
    ct2 = sch.encrypt_values(pk2, vs2, jax.random.PRNGKey(55))
    scale = ct1.scale

    c1in2 = sch.re_encrypt(ct1, rk12)
    avg = sch.mult_scalar(sch.add(c1in2, ct2), 0.5)
    want_agg = avg.data
    want_back = sch.re_encrypt(avg, rk21).data

    stacks = jnp.stack([ct1.data[None], ct2.data[None]])
    agg, back = fedavg_round_sharded(sctx, stacks, rk12.data, rk21.data, scale)
    np.testing.assert_array_equal(np.asarray(agg[0]), np.asarray(want_agg))
    np.testing.assert_array_equal(np.asarray(back[0]), np.asarray(want_back))
    got = sch.decrypt(sk2, Ciphertext(jnp.asarray(agg[0]), scale=scale))
    np.testing.assert_allclose(got, (vs1 + vs2) / 2, atol=1e-4)

"""Threshold (N-of-N) multiparty CKKS tests — the MULTIPARTY capability the
reference's CryptoContext enables but never exercises (genCC.cpp:71-76).

Covers: joint keygen from additive shares, encrypt-under-joint-key,
homomorphic FedAvg + distributed decryption (host loop and the psum-sharded
mesh collective on the virtual 8-device CPU mesh).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from ppqsflhe.ckks import eval as ev
from ppqsflhe.ckks import threshold as th
from ppqsflhe.ckks.params import CkksParams
from ppqsflhe.ckks.scheme import CkksScheme
from ppqsflhe.ckks.types import Ciphertext

N_PARTIES = 3


@pytest.fixture(scope="module")
def sch():
    params = CkksParams.generate(n=256, mult_depth=2, scale_bits=40, dnum=2)
    return CkksScheme(params)


@pytest.fixture(scope="module")
def joint(sch):
    """CRS + per-party shares + joint public key."""
    a = th.common_random_poly(sch.ctx, seed=42)
    shares, b_shares = [], []
    for i in range(N_PARTIES):
        sk_i, b_i = th.partial_keygen(sch.ctx, a, jax.random.PRNGKey(100 + i))
        shares.append(sk_i)
        b_shares.append(b_i)
    pk = th.joint_public_key(sch.ctx, a, b_shares)
    return a, shares, pk


def rand_vec(sch, seed):
    return np.random.default_rng(seed).uniform(-1, 1, sch.encoder.slots)


def test_crs_deterministic(sch):
    a1 = th.common_random_poly(sch.ctx, seed=7)
    a2 = th.common_random_poly(sch.ctx, seed=7)
    assert jnp.array_equal(a1, a2)
    assert not jnp.array_equal(a1, th.common_random_poly(sch.ctx, seed=8))


def test_joint_encrypt_threshold_decrypt(sch, joint):
    _, shares, pk = joint
    v = rand_vec(sch, 1)
    ct = sch.encrypt_values(pk, v, jax.random.PRNGKey(5))
    out = th.threshold_decrypt(sch.ctx, ct, shares, jax.random.PRNGKey(6),
                               sch.encoder)
    # smudging noise 2^30 (ss=30 default, reference parity) at Δ=2^40 →
    # slot error ≈ √N·2^{30-40} ≈ 0.02 at N=256, 3 parties
    np.testing.assert_allclose(out, v, atol=0.08)


def test_no_single_share_decrypts(sch, joint):
    """Any strict subset of shares yields garbage — the threshold property."""
    _, shares, pk = joint
    v = rand_vec(sch, 2)
    ct = sch.encrypt_values(pk, v, jax.random.PRNGKey(7))
    out = th.threshold_decrypt(sch.ctx, ct, shares[:-1], jax.random.PRNGKey(8),
                               sch.encoder)
    assert np.abs(np.asarray(out) - v).max() > 1.0


def test_lead_main_fusion_split(sch, joint):
    """OpenFHE's Lead/Main split: exactly one partial folds in c0."""
    _, shares, pk = joint
    v = rand_vec(sch, 3)
    ct = sch.encrypt_values(pk, v, jax.random.PRNGKey(9))
    keys = jax.random.split(jax.random.PRNGKey(10), N_PARTIES)
    partials = [th.partial_decrypt(sch.ctx, shares[0], ct, keys[0], lead=True)]
    partials += [th.partial_decrypt(sch.ctx, s, ct, k)
                 for s, k in zip(shares[1:], keys[1:])]
    coeffs = th.fuse_partial_decryptions(sch.ctx, ct, partials, include_c0=False)
    from ppqsflhe.ckks.rlwe import decode_coeffs

    out = decode_coeffs(sch.ctx, coeffs, ct, sch.encoder)
    np.testing.assert_allclose(out, v, atol=0.08)


def test_threshold_fedavg_round(sch, joint):
    """The PRE-free FL round: every client encrypts under the joint key,
    server aggregates (add + 1/N mult + rescale), parties jointly decrypt."""
    _, shares, pk = joint
    vecs = [rand_vec(sch, 10 + i) for i in range(N_PARTIES)]
    cts = [sch.encrypt_values(pk, v, jax.random.PRNGKey(20 + i))
           for i, v in enumerate(vecs)]
    agg = cts[0]
    for ct in cts[1:]:
        agg = ev.add(sch.ctx, agg, ct)
    agg = ev.mult_scalar(sch.ctx, agg, 1.0 / N_PARTIES)
    out = th.threshold_decrypt(sch.ctx, agg, shares, jax.random.PRNGKey(30),
                               sch.encoder)
    np.testing.assert_allclose(out, np.mean(vecs, axis=0), atol=0.08)


def test_sharded_joint_keygen_and_decrypt(sch):
    """Mesh collectives: joint pk via psum over the client axis, and the
    one-collective fused decryption, on a 4-way client mesh (2 parties per
    shard → 8 total)."""
    n_parties = 8
    devs = np.array(jax.devices()[:4]).reshape(4)
    mesh = Mesh(devs, ("client",))

    a = th.common_random_poly(sch.ctx, seed=77)
    shares, b_shares = [], []
    for i in range(n_parties):
        sk_i, b_i = th.partial_keygen(sch.ctx, a, jax.random.PRNGKey(200 + i))
        shares.append(sk_i)
        b_shares.append(b_i)
    b_local = jnp.stack(b_shares)                    # (8, L+K, N)
    pk = th.joint_public_key_sharded(sch.ctx, a, b_local, mesh)

    # must equal the host-combined key exactly
    pk_host = th.joint_public_key(sch.ctx, a, b_shares)
    assert jnp.array_equal(pk.data, pk_host.data)

    v = rand_vec(sch, 40)
    ct = sch.encrypt_values(pk, v, jax.random.PRNGKey(41))

    s_local = jnp.stack([s.s_eval for s in shares])  # (8, L+K, N)
    rng_local = jax.random.split(jax.random.PRNGKey(42), n_parties)
    coeffs = th.partial_decrypt_psum(sch.ctx, ct, s_local, rng_local, mesh)
    from ppqsflhe.ckks.rlwe import decode_coeffs

    out = decode_coeffs(sch.ctx, coeffs, ct, sch.encoder)
    np.testing.assert_allclose(out, v, atol=0.08)


def test_t_of_n_decryption(sch, joint):
    """t-of-N availability: Shamir-share the additive secret shares; any t
    parties decrypt, fewer than t produce garbage (VERDICT r2 #8)."""
    a, shares, pk = joint
    n_parties, t = N_PARTIES, 2
    v = np.linspace(-1, 1, sch.encoder.slots)
    ct = sch.encrypt_values(pk, v, jax.random.PRNGKey(500))

    # each party Shamir-shares its additive share; party j aggregates what
    # it received: sigma_j = sum_i f_i(j)
    outgoing = [th.shamir_share_secret(sch.ctx, shares[i], n_parties, t,
                                       jax.random.PRNGKey(600 + i))
                for i in range(n_parties)]
    sigmas = {
        j: th.aggregate_received_shares(
            sch.ctx, jnp.stack([outgoing[i][j - 1] for i in range(n_parties)]))
        for j in range(1, n_parties + 1)
    }

    # every t-subset decrypts correctly
    for party_set in ([1, 2], [1, 3], [2, 3]):
        got = th.threshold_decrypt_t(sch.ctx, ct, sigmas, party_set,
                                     jax.random.PRNGKey(700), sch.encoder)
        np.testing.assert_allclose(np.asarray(got), v, atol=0.2)

    # a (t-1)-subset must NOT decrypt: lambda for a singleton set is 1, so
    # fusing one share yields c0 + c1*F(j) != c0 + c1*s
    got_bad = th.threshold_decrypt_t(sch.ctx, ct, sigmas, [2],
                                     jax.random.PRNGKey(701), sch.encoder)
    assert np.abs(np.asarray(got_bad) - v).max() > 1.0


def test_t_of_n_after_homomorphic_fedavg(sch, joint):
    """The FL shape: aggregate under the joint key, then any t clients
    finish the round (dropout-tolerant decryption)."""
    a, shares, pk = joint
    t = 2
    v1 = np.linspace(-1, 1, sch.encoder.slots)
    v2 = np.linspace(1, -1, sch.encoder.slots)
    ct1 = sch.encrypt_values(pk, v1, jax.random.PRNGKey(800))
    ct2 = sch.encrypt_values(pk, v2, jax.random.PRNGKey(801))
    avg = sch.mult_scalar(sch.add(ct1, ct2), 0.5)

    outgoing = [th.shamir_share_secret(sch.ctx, shares[i], N_PARTIES, t,
                                       jax.random.PRNGKey(900 + i))
                for i in range(N_PARTIES)]
    sigmas = {
        j: th.aggregate_received_shares(
            sch.ctx, jnp.stack([outgoing[i][j - 1] for i in range(N_PARTIES)]))
        for j in range(1, N_PARTIES + 1)
    }
    got = th.threshold_decrypt_t(sch.ctx, avg, sigmas, [3, 1],
                                 jax.random.PRNGKey(901), sch.encoder)
    np.testing.assert_allclose(np.asarray(got), (v1 + v2) / 2, atol=0.2)


def test_smudging_semantics_and_derivation(sch):
    """The default flood is an ABSOLUTE ±2^30 (the reference's ss=30
    PARAMETER, SURVEY.md §2.3); the ACHIEVED statistical distance is
    2^-(30 − noise_bits) by the smudging lemma (ADVICE r4). The derived
    flood_bits_for_ss bound gives a flood that honestly meets a target ss:
    noise_bits + ss."""
    assert th.DEFAULT_SMUDGING_BITS == 30
    nb = th.decryption_noise_bits(sch.ctx)
    # N=256, σ=3.19: 3·6σ√(2N/3) ≈ 750 → 10 bits; sanity-band the bound
    assert 8 <= nb <= 14
    assert th.flood_bits_for_ss(sch.ctx, 30) == nb + 30
    # at the reference shape (N=2^14) the honest ss=30 flood exceeds Δ=2^40:
    # the documented parameter-set limitation (ckks/threshold.py header)
    import math
    ref_nb = max(1, math.ceil(math.log2(3 * 6 * 3.19 * math.sqrt(2 * (1 << 14) / 3))))
    assert th.flood_bits_for_ss(sch.ctx, 30, noise_bits=ref_nb) > 40

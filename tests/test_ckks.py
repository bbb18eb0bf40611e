"""End-to-end CKKS scheme tests (SURVEY.md §7.1 steps 3-6).

Small ring (N=256) for CPU speed; the parameter *structure* (60/40/40-bit
chain, dnum=2 hybrid KS, special primes) mirrors the reference set.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ppqsflhe.ckks.params import CkksParams
from ppqsflhe.ckks.scheme import CkksScheme


@pytest.fixture(scope="module")
def sch():
    params = CkksParams.generate(n=256, mult_depth=2, scale_bits=40, dnum=2)
    return CkksScheme(params)


@pytest.fixture(scope="module")
def keys(sch):
    sk, pk = sch.keygen(jax.random.PRNGKey(0))
    return sk, pk


def rand_vec(sch, seed=0, lo=-1.0, hi=1.0):
    rng = np.random.default_rng(seed)
    return rng.uniform(lo, hi, sch.encoder.slots)


def test_encode_decode_roundtrip(sch):
    v = rand_vec(sch, 1)
    coeffs = sch.encoder.encode(v, sch.params.scale)
    back = sch.encoder.decode(coeffs.astype(np.float64), sch.params.scale).real
    np.testing.assert_allclose(back, v, atol=1e-9)


def test_encrypt_decrypt(sch, keys):
    sk, pk = keys
    v = rand_vec(sch, 2)
    ct = sch.encrypt_values(pk, v, jax.random.PRNGKey(1))
    out = sch.decrypt(sk, ct)
    np.testing.assert_allclose(out, v, atol=1e-6)


def test_add_sub(sch, keys):
    sk, pk = keys
    v1, v2 = rand_vec(sch, 3), rand_vec(sch, 4)
    ct1 = sch.encrypt_values(pk, v1, jax.random.PRNGKey(2))
    ct2 = sch.encrypt_values(pk, v2, jax.random.PRNGKey(3))
    np.testing.assert_allclose(sch.decrypt(sk, sch.add(ct1, ct2)), v1 + v2, atol=1e-6)
    np.testing.assert_allclose(sch.decrypt(sk, sch.sub(ct1, ct2)), v1 - v2, atol=1e-6)


def test_mult_scalar_rescale(sch, keys):
    """The reference aggregation op: EvalMult(ct, 0.5) + rescale
    (aggregateEncryptedWeights.cpp:83). Scale must be unchanged after."""
    sk, pk = keys
    v = rand_vec(sch, 5)
    ct = sch.encrypt_values(pk, v, jax.random.PRNGKey(4))
    out = sch.mult_scalar(ct, 0.5)
    assert out.nlimbs == ct.nlimbs - 1
    assert np.isclose(out.scale, ct.scale)
    np.testing.assert_allclose(sch.decrypt(sk, out), 0.5 * v, atol=1e-6)


def test_fedavg_identity(sch, keys):
    """decrypt(0.5*(Enc(v1)+Enc(v2))) ≈ (v1+v2)/2 — the homomorphic FedAvg."""
    sk, pk = keys
    v1, v2 = rand_vec(sch, 6), rand_vec(sch, 7)
    ct1 = sch.encrypt_values(pk, v1, jax.random.PRNGKey(5))
    ct2 = sch.encrypt_values(pk, v2, jax.random.PRNGKey(6))
    avg = sch.mult_scalar(sch.add(ct1, ct2), 0.5)
    np.testing.assert_allclose(sch.decrypt(sk, avg), (v1 + v2) / 2, atol=1e-6)


def test_mult_plain(sch, keys):
    sk, pk = keys
    v1, v2 = rand_vec(sch, 8), rand_vec(sch, 9)
    ct = sch.encrypt_values(pk, v1, jax.random.PRNGKey(7))
    pt = sch.make_plaintext(v2)
    out = sch.mult_plain(ct, pt)
    np.testing.assert_allclose(sch.decrypt(sk, out), v1 * v2, atol=1e-5)


def test_ct_ct_mult_relin(sch, keys):
    sk, pk = keys
    rk = sch.relin_key_gen(sk, jax.random.PRNGKey(10))
    v1, v2 = rand_vec(sch, 10), rand_vec(sch, 11)
    ct1 = sch.encrypt_values(pk, v1, jax.random.PRNGKey(8))
    ct2 = sch.encrypt_values(pk, v2, jax.random.PRNGKey(9))
    out = sch.mult(ct1, ct2, rk)
    assert out.num_components == 2
    np.testing.assert_allclose(sch.decrypt(sk, out), v1 * v2, atol=1e-4)


def test_depth2_circuit(sch, keys):
    """(v1*v2)*0.25 uses both levels (BASELINE.json config 2 analogue)."""
    sk, pk = keys
    rk = sch.relin_key_gen(sk, jax.random.PRNGKey(12))
    v1, v2 = rand_vec(sch, 12), rand_vec(sch, 13)
    ct1 = sch.encrypt_values(pk, v1, jax.random.PRNGKey(13))
    ct2 = sch.encrypt_values(pk, v2, jax.random.PRNGKey(14))
    prod = sch.mult(ct1, ct2, rk)
    out = sch.mult_scalar(prod, 0.25)
    assert out.nlimbs == 1
    np.testing.assert_allclose(sch.decrypt(sk, out), v1 * v2 * 0.25, atol=1e-3)


def test_rotation(sch, keys):
    sk, pk = keys
    rot_keys = sch.rotation_key_gen(sk, [1, 3], jax.random.PRNGKey(15))
    v = rand_vec(sch, 14)
    ct = sch.encrypt_values(pk, v, jax.random.PRNGKey(16))
    for r in (1, 3):
        out = sch.decrypt(sk, sch.rotate(ct, r, rot_keys))
        np.testing.assert_allclose(out, np.roll(v, -r), atol=1e-4)


def test_hoisted_rotations(sch, keys):
    sk, pk = keys
    rots = [1, 2, 5]
    rot_keys = sch.rotation_key_gen(sk, rots, jax.random.PRNGKey(17))
    v = rand_vec(sch, 15)
    ct = sch.encrypt_values(pk, v, jax.random.PRNGKey(18))
    outs = sch.rotate_hoisted(ct, rots, rot_keys)
    for r, out in zip(rots, outs):
        np.testing.assert_allclose(sch.decrypt(sk, out), np.roll(v, -r), atol=1e-4)
    # hoisted == plain, bit-exact (the r5 batched-take refactor must not
    # change a single residue)
    for r, out in zip(rots, outs):
        np.testing.assert_array_equal(np.asarray(out.data),
                                      np.asarray(sch.rotate(ct, r, rot_keys).data))


def test_rotate_sum_double_hoisted(sch, keys):
    """rotate_sum_hoisted (one decompose+extend + ONE deferred ModDown,
    r5 / VERDICT r4 weak #3) decrypts to Σ_r roll(v, -r) within the same
    noise budget as summing plain rotations."""
    sk, pk = keys
    rots = [1, 2, 5, 7]
    rot_keys = sch.rotation_key_gen(sk, rots, jax.random.PRNGKey(27))
    v = rand_vec(sch, 35)
    ct = sch.encrypt_values(pk, v, jax.random.PRNGKey(28))
    got = sch.decrypt(sk, sch.rotate_sum_hoisted(ct, rots, rot_keys))
    want = sum(np.roll(v, -r) for r in rots)
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_conjugation(sch, keys):
    sk, pk = keys
    ck = sch.conjugation_key_gen(sk, jax.random.PRNGKey(19))
    v = rand_vec(sch, 16)
    ct = sch.encrypt_values(pk, v, jax.random.PRNGKey(20))
    out = sch.decrypt(sk, sch.conjugate(ct, ck))
    np.testing.assert_allclose(out, v, atol=1e-4)  # real input: conj == id


def test_proxy_reencryption(sch):
    """A encrypts; server re-encrypts to B's domain with a key derived from
    A's secret + B's *public* key only; B decrypts (changeCipherDomain)."""
    sk_a, pk_a = sch.keygen(jax.random.PRNGKey(30))
    sk_b, pk_b = sch.keygen(jax.random.PRNGKey(31))
    rekey = sch.rekey_gen(sk_a, pk_b, jax.random.PRNGKey(32))
    v = rand_vec(sch, 17)
    ct_a = sch.encrypt_values(pk_a, v, jax.random.PRNGKey(33))
    ct_b = sch.re_encrypt(ct_a, rekey)
    np.testing.assert_allclose(sch.decrypt(sk_b, ct_b), v, atol=1e-4)
    # and B's ct is NOT decryptable by A (sanity)
    wrong = sch.decrypt(sk_a, ct_b)
    assert np.abs(wrong - v).max() > 1e-2


def test_proxy_reencryption_indcca(sch):
    """PREMode INDCCA (test_s_CC.cpp's second allowed mode): ReEncrypt
    re-randomizes with Enc_pk_B(0) + flooding noise, so (a) B still decrypts
    correctly, (b) two re-encryptions of the SAME ciphertext differ, and
    (c) omitting the target pubkey is an error."""
    import dataclasses

    sch_cca = CkksScheme(dataclasses.replace(sch.params, pre_mode="INDCCA"))
    sk_a, pk_a = sch_cca.keygen(jax.random.PRNGKey(60))
    sk_b, pk_b = sch_cca.keygen(jax.random.PRNGKey(61))
    rekey = sch_cca.rekey_gen(sk_a, pk_b, jax.random.PRNGKey(62))
    v = rand_vec(sch_cca, 23)
    ct_a = sch_cca.encrypt_values(pk_a, v, jax.random.PRNGKey(63))
    ct_b1 = sch_cca.re_encrypt(ct_a, rekey, pk_to=pk_b, rng_key=jax.random.PRNGKey(64))
    ct_b2 = sch_cca.re_encrypt(ct_a, rekey, pk_to=pk_b, rng_key=jax.random.PRNGKey(65))
    # correctness under flooding: default pre_flood_bits=30 (reference ss=30
    # parity) at Δ=2^40, N=256 → ≈ √(N/2)·2^-10 ≈ 0.01 slot error per hop
    np.testing.assert_allclose(sch_cca.decrypt(sk_b, ct_b1), v, atol=0.1)
    np.testing.assert_allclose(sch_cca.decrypt(sk_b, ct_b2), v, atol=0.1)
    # unlinkability: identical input, different fresh randomness → different cts
    assert not np.array_equal(np.asarray(ct_b1.data), np.asarray(ct_b2.data))
    with pytest.raises(ValueError, match="INDCCA"):
        sch_cca.re_encrypt(ct_a, rekey)


def test_pre_then_aggregate(sch):
    """The reference server round: PRE C1→C2 domain, EvalAdd, EvalMult 0.5,
    PRE back to C1 (run_round, SURVEY.md §3.1)."""
    sk1, pk1 = sch.keygen(jax.random.PRNGKey(40))
    sk2, pk2 = sch.keygen(jax.random.PRNGKey(41))
    rk_1to2 = sch.rekey_gen(sk1, pk2, jax.random.PRNGKey(42))
    rk_2to1 = sch.rekey_gen(sk2, pk1, jax.random.PRNGKey(43))
    v1, v2 = rand_vec(sch, 18), rand_vec(sch, 19)
    ct1 = sch.encrypt_values(pk1, v1, jax.random.PRNGKey(44))
    ct2 = sch.encrypt_values(pk2, v2, jax.random.PRNGKey(45))
    ct1_in2 = sch.re_encrypt(ct1, rk_1to2)
    agg = sch.mult_scalar(sch.add(ct1_in2, ct2), 0.5)
    want = (v1 + v2) / 2
    np.testing.assert_allclose(sch.decrypt(sk2, agg), want, atol=1e-4)
    agg_in1 = sch.re_encrypt(agg, rk_2to1)
    np.testing.assert_allclose(sch.decrypt(sk1, agg_in1), want, atol=1e-4)


def test_inner_product(sch, keys):
    sk, pk = keys
    rk = sch.relin_key_gen(sk, jax.random.PRNGKey(50))
    slots = sch.encoder.slots
    rots = [1 << i for i in range(int(np.log2(slots)))]
    rot_keys = sch.rotation_key_gen(sk, rots, jax.random.PRNGKey(51))
    v1, v2 = rand_vec(sch, 20) * 0.1, rand_vec(sch, 21) * 0.1
    ct1 = sch.encrypt_values(pk, v1, jax.random.PRNGKey(52))
    ct2 = sch.encrypt_values(pk, v2, jax.random.PRNGKey(53))
    out = sch.inner_product(ct1, ct2, rk, rot_keys)
    want = float(np.dot(v1, v2))
    got = sch.decrypt(sk, out)
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_sparse_packing(sch, keys):
    sk, pk = keys
    v = rand_vec(sch, 22)[:10]
    ct = sch.encrypt_values(pk, v, jax.random.PRNGKey(54))
    out = sch.decrypt(sk, ct, num=10)
    np.testing.assert_allclose(out, v, atol=1e-6)


# ---------------------------------------------------------------------------
# Four-step NTT backend: the full scheme must work identically in the
# kernel eval order (rotations are order-corrected via ctx.galois_perm).
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sch4():
    from ppqsflhe.ckks.params import CkksParams

    params = CkksParams.generate(n=256, mult_depth=2, scale_bits=40, dnum=2,
                                 ntt_backend="fourstep")
    return CkksScheme(params)


def test_fourstep_backend_full_round(sch4):
    sk1, pk1 = sch4.keygen(jax.random.PRNGKey(60))
    sk2, pk2 = sch4.keygen(jax.random.PRNGKey(61))
    rk = sch4.rekey_gen(sk1, pk2, jax.random.PRNGKey(62))
    v1, v2 = rand_vec(sch4, 60), rand_vec(sch4, 61)
    ct1 = sch4.encrypt_values(pk1, v1, jax.random.PRNGKey(63))
    ct2 = sch4.encrypt_values(pk2, v2, jax.random.PRNGKey(64))
    agg = sch4.mult_scalar(sch4.add(sch4.re_encrypt(ct1, rk), ct2), 0.5)
    np.testing.assert_allclose(sch4.decrypt(sk2, agg), (v1 + v2) / 2, atol=1e-4)


def test_fourstep_backend_rotation(sch4):
    sk, pk = sch4.keygen(jax.random.PRNGKey(70))
    rot_keys = sch4.rotation_key_gen(sk, [1, 5], jax.random.PRNGKey(71))
    v = rand_vec(sch4, 70)
    ct = sch4.encrypt_values(pk, v, jax.random.PRNGKey(72))
    for r in (1, 5):
        out = sch4.decrypt(sk, sch4.rotate(ct, r, rot_keys))
        np.testing.assert_allclose(out, np.roll(v, -r), atol=1e-4)


def test_fourstep_backend_ct_mult(sch4):
    sk, pk = sch4.keygen(jax.random.PRNGKey(80))
    rk = sch4.relin_key_gen(sk, jax.random.PRNGKey(81))
    v1, v2 = rand_vec(sch4, 80), rand_vec(sch4, 81)
    ct1 = sch4.encrypt_values(pk, v1, jax.random.PRNGKey(82))
    ct2 = sch4.encrypt_values(pk, v2, jax.random.PRNGKey(83))
    out = sch4.mult(ct1, ct2, rk)
    np.testing.assert_allclose(sch4.decrypt(sk, out), v1 * v2, atol=1e-4)


# ---------------------------------------------------------------------------
# FLEXIBLEAUTOEXT (the reference's rs=3 scaling technique)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sch_ext():
    params = CkksParams.generate(n=256, mult_depth=2, scale_bits=40, dnum=2,
                                 extra_mod_bits=20)
    assert params.flexible_ext and params.num_q == 4
    return CkksScheme(params)


def test_flexext_fresh_roundtrip(sch_ext):
    sk, pk = sch_ext.keygen(jax.random.PRNGKey(90))
    v = rand_vec(sch_ext, 90)
    ct = sch_ext.encrypt_values(pk, v, jax.random.PRNGKey(91))
    assert ct.nlimbs == 4 and ct.scale > 2.0**55  # Δ·q_ext
    np.testing.assert_allclose(sch_ext.decrypt(sk, ct), v, atol=1e-6)


def test_flexext_depth2(sch_ext):
    """4-tower chain supports depth 2 like OpenFHE FLEXIBLEAUTOEXT: the ext
    limb is auto-dropped before the first mult."""
    sk, pk = sch_ext.keygen(jax.random.PRNGKey(92))
    rk = sch_ext.relin_key_gen(sk, jax.random.PRNGKey(93))
    v1, v2 = rand_vec(sch_ext, 92), rand_vec(sch_ext, 93)
    ct1 = sch_ext.encrypt_values(pk, v1, jax.random.PRNGKey(94))
    ct2 = sch_ext.encrypt_values(pk, v2, jax.random.PRNGKey(95))
    prod = sch_ext.mult(ct1, ct2, rk)       # auto-drops ext, then mult+rescale
    assert prod.nlimbs == 2
    out = sch_ext.mult_scalar(prod, 0.25)   # second level
    assert out.nlimbs == 1
    np.testing.assert_allclose(sch_ext.decrypt(sk, out), v1 * v2 * 0.25, atol=1e-3)


def test_flexext_fedavg(sch_ext):
    """add works at the extension level; EvalMult(·,0.5) drops it."""
    sk, pk = sch_ext.keygen(jax.random.PRNGKey(96))
    v1, v2 = rand_vec(sch_ext, 96), rand_vec(sch_ext, 97)
    ct1 = sch_ext.encrypt_values(pk, v1, jax.random.PRNGKey(97))
    ct2 = sch_ext.encrypt_values(pk, v2, jax.random.PRNGKey(98))
    avg = sch_ext.mult_scalar(sch_ext.add(ct1, ct2), 0.5)
    assert avg.nlimbs == 2
    np.testing.assert_allclose(sch_ext.decrypt(sk, avg), (v1 + v2) / 2, atol=1e-5)


def test_mult_scale_mismatch_raises(sch, keys):
    """A Δ² operand against a fresh Δ one is a caller bug (the product's
    noise analysis no longer holds) — mult must raise, not silently record
    a composite scale (VERDICT r2 weak #6)."""
    sk, pk = keys
    rk = sch.relin_key_gen(sk, jax.random.PRNGKey(40))
    v1, v2 = rand_vec(sch, 40), rand_vec(sch, 41)
    ct1 = sch.encrypt_values(pk, v1, jax.random.PRNGKey(41))
    ct2 = sch.encrypt_values(pk, v2, jax.random.PRNGKey(42))
    bad = sch.mult_plain(ct2, sch.make_plaintext(np.ones(sch.encoder.slots)),
                         rescale_after=False)
    assert bad.scale > ct1.scale * 1e6     # Δ² vs Δ
    with pytest.raises(ValueError, match="scale mismatch"):
        sch.mult(ct1, bad, rk)


def test_insecure_params_warning():
    """Context build surfaces the HE-standard security estimate when the
    chain falls below 128-bit (params.security_bits is live, not dead
    diagnostic code)."""
    from ppqsflhe.ckks.params import CkksContext, SecurityWarning

    tiny = CkksParams.generate(n=256, mult_depth=2, scale_bits=40, dnum=2)
    with pytest.warns(SecurityWarning, match="below 128-bit"):
        CkksContext(tiny)
    # the reference-sized chain (N=16384, ~280-bit QP) is fine: no warning
    import warnings

    ref = CkksParams.reference()
    with warnings.catch_warnings():
        warnings.simplefilter("error", SecurityWarning)
        CkksContext(ref)


def test_ksk_mont_form(sch, keys):
    """Montgomery-form key-switch keys (ev.ksk_to_mont) produce bit-identical
    keyswitch results via ONE mont_mul per inner-product element."""
    from ppqsflhe.ckks import eval as ev

    sk, pk = keys
    rk = sch.relin_key_gen(sk, jax.random.PRNGKey(77))
    v = rand_vec(sch, 77)
    ct = sch.encrypt_values(pk, v, jax.random.PRNGKey(78))
    l = ct.nlimbs
    d0a, d1a = ev.keyswitch(sch.ctx, ct.data[1], rk, l)
    rkm = ev.ksk_to_mont(sch.ctx, rk)
    assert rkm.mont and not rk.mont
    d0b, d1b = ev.keyswitch(sch.ctx, ct.data[1], rkm, l)
    assert np.array_equal(np.asarray(d0a), np.asarray(d0b))
    assert np.array_equal(np.asarray(d1a), np.asarray(d1b))
    # idempotent
    assert ev.ksk_to_mont(sch.ctx, rkm) is rkm


def test_seeded_rotation_key_serialization():
    """Self-generated KSKs (rotation/relin/conj) serialize seeded: b rows +
    a 16-byte seed, ~2x smaller; the reloaded key rotates correctly and
    byte-stably re-serializes. PRE keys reject seeding (pk-based rows)."""
    import json as _json

    import jax

    from ppqsflhe.ckks import eval as ev
    from ppqsflhe.ckks import serialize as ser

    sch = CkksScheme(CkksParams.generate(n=128, mult_depth=2, scale_bits=40,
                                         dnum=2))
    sk, pk = sch.keygen(jax.random.PRNGKey(1))
    L = sch.params.num_q
    g = ev.rot_to_galois(1, sch.params.n)
    seed = bytes(range(16))
    s_rot = ev.automorphism(sch.ctx, sk.s_eval[:L], g)
    rk = ev.keyswitch_key_gen(sch.ctx, s_rot, jax.random.PRNGKey(2),
                              sk_to=sk, a_seed=seed)

    doc = ser.serialize_ksk(rk, a_seed=seed)
    dense = len(_json.dumps(ser.serialize_ksk(rk)))
    seeded = len(_json.dumps(doc))
    assert dense / seeded > 1.8, (dense, seeded)
    back = ser.deserialize_ksk(doc, sch.ctx)
    np.testing.assert_array_equal(np.asarray(back.data), np.asarray(rk.data))

    v = np.linspace(-1, 1, sch.encoder.slots)
    ct = sch.encrypt_values(pk, v, jax.random.PRNGKey(3))
    got = sch.decrypt(sk, ev.rotate(sch.ctx, ct, 1, back))
    np.testing.assert_allclose(np.asarray(got), np.roll(v, -1), atol=1e-4)

    with pytest.raises(ValueError):
        ev.keyswitch_key_gen(sch.ctx, s_rot, jax.random.PRNGKey(4),
                             pk_to=pk, a_seed=seed)


def test_corrupt_ciphertext_blob_clear_error():
    """A corrupted/foreign blob raises ValueError('bad ciphertext magic...')
    from BOTH entry points — not a bare AssertionError from deep inside the
    OpenFHE cereal parser (found by the r5 verify probe)."""
    from ppqsflhe.ckks import serialize as ser

    blob = b"XXXX" + bytes(64)
    with pytest.raises(ValueError, match="bad ciphertext magic"):
        ser.ciphertext_from_bytes(b"PQTX" + bytes(64))
    with pytest.raises(ValueError, match="bad ciphertext magic"):
        ser.ciphertext_from_bytes_any(blob)

"""Exact modular arithmetic vs Python big ints (SURVEY.md §7.1 step 1)."""

import numpy as np
import jax.numpy as jnp
import pytest

from ppqsflhe.core import primes, modarith

# The reference parameter set's actual moduli (SURVEY.md §2.3) plus edge sizes.
MODULI = [
    1152921504606748673,  # ~2^60 (reference q0)
    1099510054913,        # ~2^40 (reference q1)
    1099511922689,        # ~2^40 (reference q2)
    557057,               # ~2^19 (reference FLEXIBLEAUTOEXT extra prime)
    (1 << 62) - 57,       # near the 2^63 Montgomery bound (prime)
]


def rand_residues(q, n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, q, size=n, dtype=np.uint64)


@pytest.mark.parametrize("q", MODULI)
def test_addsub(q):
    a = rand_residues(q, 512, 1)
    b = rand_residues(q, 512, 2)
    got = np.asarray(modarith.modadd(jnp.asarray(a), jnp.asarray(b), jnp.uint64(q)))
    want = (a.astype(object) + b.astype(object)) % q
    assert (got.astype(object) == want).all()
    got = np.asarray(modarith.modsub(jnp.asarray(a), jnp.asarray(b), jnp.uint64(q)))
    want = (a.astype(object) - b.astype(object)) % q
    assert (got.astype(object) == want).all()


@pytest.mark.parametrize("q", MODULI)
def test_montgomery_modmul(q):
    if not primes.is_prime(q):
        pytest.skip("needs prime")
    a = rand_residues(q, 512, 3)
    b = rand_residues(q, 512, 4)
    qinv = jnp.uint64(primes.mont_qinv_neg(q))
    r2 = jnp.uint64(primes.mont_r2(q))
    got = np.asarray(modarith.modmul(jnp.asarray(a), jnp.asarray(b), jnp.uint64(q), qinv, r2))
    want = (a.astype(object) * b.astype(object)) % q
    assert (got.astype(object) == want).all()


@pytest.mark.parametrize("q", MODULI)
def test_shoup_mul(q):
    a = rand_residues(q, 512, 5)
    rng = np.random.default_rng(6)
    w = int(rng.integers(0, q))
    ws = primes.shoup_precompute(w, q)
    got = np.asarray(modarith.shoup_mul(jnp.asarray(a), jnp.uint64(w), jnp.uint64(ws), jnp.uint64(q)))
    want = (a.astype(object) * w) % q
    assert (got.astype(object) == want).all()


def test_mul_hi():
    rng = np.random.default_rng(7)
    a = rng.integers(0, 1 << 64, size=256, dtype=np.uint64)
    b = rng.integers(0, 1 << 64, size=256, dtype=np.uint64)
    got = np.asarray(modarith.mul_hi(jnp.asarray(a), jnp.asarray(b)))
    want = np.array([(int(x) * int(y)) >> 64 for x, y in zip(a, b)], dtype=np.uint64)
    assert (got == want).all()


def test_reference_prime_properties():
    # The checked-in context's moduli are NTT-friendly for 2N = 32768
    for q in MODULI[:4]:
        assert primes.is_prime(q)
        assert (q - 1) % 32768 == 0


def test_root_of_unity_matches_openfhe_convention():
    """OpenFHE serializes the minimal primitive 2N-th root (SURVEY.md §2.3);
    our derivation must reproduce every root in the checked-in key artifacts."""
    from ppqsflhe.ckks.params import REFERENCE_MODULI, REFERENCE_ROOTS

    for q, want in zip(REFERENCE_MODULI, REFERENCE_ROOTS):
        got = primes.root_of_unity(32768, q)
        assert primes.is_primitive_root_of_unity(got, 32768, q)
        assert got == want, (q, got, want)


def test_security_estimate():
    from ppqsflhe.ckks.params import CkksParams

    p = CkksParams.generate(n=1 << 14, mult_depth=2, scale_bits=40)
    # ~160-bit Q + ~120-bit P at N=16384 → comfortably 128-bit classical
    assert p.security_bits() >= 128
    tiny = CkksParams.generate(n=256, mult_depth=2, scale_bits=40)
    assert tiny.security_bits() == 0  # toy ring: no security, as expected

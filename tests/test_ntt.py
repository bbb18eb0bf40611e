"""Negacyclic NTT correctness (SURVEY.md §7.1 step 2).

- NTT∘iNTT = identity over the RNS limb stack.
- Pointwise product in eval domain == schoolbook negacyclic convolution
  (exact big-int reference).
"""

import numpy as np
import jax.numpy as jnp

from ppqsflhe.core import primes
from ppqsflhe.core.ntt import NttBasis, bit_reverse_indices


def negacyclic_mul_exact(a, b, q, n):
    """Schoolbook negacyclic convolution with Python ints."""
    out = [0] * n
    for i in range(n):
        ai = int(a[i])
        if ai == 0:
            continue
        for j in range(n):
            k = i + j
            p = ai * int(b[j])
            if k >= n:
                out[k - n] -= p
            else:
                out[k] += p
    return np.array([v % q for v in out], dtype=np.uint64)


def make_basis(n):
    moduli = [primes.first_prime_down(59, 2 * n)] + primes.prime_chain(40, 2, 2 * n)
    return NttBasis(n, moduli)


def test_roundtrip():
    n = 256
    basis = make_basis(n)
    rng = np.random.default_rng(0)
    a = np.stack([rng.integers(0, q, n, dtype=np.uint64) for q in basis.moduli])
    fwd = basis.ntt(jnp.asarray(a))
    back = np.asarray(basis.intt(fwd))
    assert (back == a).all()


def test_roundtrip_batched():
    n = 128
    basis = make_basis(n)
    rng = np.random.default_rng(1)
    a = np.stack(
        [np.stack([rng.integers(0, q, n, dtype=np.uint64) for q in basis.moduli]) for _ in range(3)]
    )
    back = np.asarray(basis.intt(basis.ntt(jnp.asarray(a))))
    assert (back == a).all()


def test_negacyclic_convolution():
    n = 64
    basis = make_basis(n)
    rng = np.random.default_rng(2)
    a = np.stack([rng.integers(0, q, n, dtype=np.uint64) for q in basis.moduli])
    b = np.stack([rng.integers(0, q, n, dtype=np.uint64) for q in basis.moduli])
    fa = basis.ntt(jnp.asarray(a))
    fb = basis.ntt(jnp.asarray(b))
    from ppqsflhe.core.modarith import modmul, U64
    qv = basis.q_vec
    qinv = jnp.asarray(
        np.array([primes.mont_qinv_neg(q) for q in basis.moduli], np.uint64).reshape(-1, 1), U64)
    r2 = jnp.asarray(
        np.array([primes.mont_r2(q) for q in basis.moduli], np.uint64).reshape(-1, 1), U64)
    prod = np.asarray(basis.intt(modmul(fa, fb, qv, qinv, r2)))
    for i, q in enumerate(basis.moduli):
        want = negacyclic_mul_exact(a[i], b[i], q, n)
        assert (prod[i] == want).all(), f"limb {i}"


def test_ntt_matches_direct_evaluation():
    """Eval-domain value at bit-reversed position k is m(psi^(2*brev(k)+1))."""
    n = 32
    q = primes.first_prime_down(40, 2 * n)
    basis = NttBasis(n, [q])
    rng = np.random.default_rng(3)
    a = rng.integers(0, q, n, dtype=np.uint64)
    fwd = np.asarray(basis.ntt(jnp.asarray(a[None, :])))[0]
    psi = basis.psis[0]
    rev = bit_reverse_indices(n)
    for k in range(n):
        root = pow(psi, 2 * int(rev[k]) + 1, q)
        want = 0
        for j in range(n - 1, -1, -1):
            want = (want * root + int(a[j])) % q
        assert fwd[k] == want, k


def test_bit_reverse():
    idx = bit_reverse_indices(8)
    assert list(idx) == [0, 4, 2, 6, 1, 5, 3, 7]

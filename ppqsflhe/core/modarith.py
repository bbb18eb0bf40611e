"""Vectorized 64-bit modular arithmetic on integer lanes.

This is the scalar-engine of the DCRTPoly replacement (reference: OpenFHE's
``intnat::NativeIntegerT`` Barrett/Montgomery routines, linked via
``-lOPENFHEcore`` — SURVEY.md §2.2). Everything is expressed over ``uint64``
jnp arrays; :mod:`ppqsflhe.ops.u32pair` implements the same contracts
on explicit 32-bit lanes for the four-step NTT bodies.

Design notes:
- No data-dependent control flow — all branches are ``jnp.where`` selects.
- No 128-bit type exists anywhere: 64x64→128 products are synthesized from
  32-bit halves (``_mul128``), which XLA maps onto native 32-bit multiplies.
- General modmul uses Montgomery reduction with R = 2^64 (requires q < 2^63;
  the chain's largest modulus is < 2^60).
- Multiplication by *precomputed* constants (NTT twiddles, scalar encodings)
  uses Shoup's trick — one mulhi + one mullo + one conditional subtract.
"""

from __future__ import annotations

import jax.numpy as jnp

U64 = jnp.uint64
_M32 = jnp.uint64(0xFFFFFFFF)
_32 = jnp.uint64(32)


def u64(x) -> jnp.ndarray:
    return jnp.asarray(x, dtype=U64)


def _mul128(a, b):
    """Full 64x64 -> 128-bit product as (hi, lo) uint64 pair."""
    a_lo = a & _M32
    a_hi = a >> _32
    b_lo = b & _M32
    b_hi = b >> _32
    ll = a_lo * b_lo
    lh = a_lo * b_hi
    hl = a_hi * b_lo
    hh = a_hi * b_hi
    mid = (ll >> _32) + (lh & _M32) + (hl & _M32)  # <= 3*(2^32-1), no overflow
    lo = (mid << _32) | (ll & _M32)
    hi = hh + (lh >> _32) + (hl >> _32) + (mid >> _32)
    return hi, lo


def mul_hi(a, b):
    """High 64 bits of the 128-bit product."""
    return _mul128(a, b)[0]


def modadd(a, b, q):
    s = a + b  # < 2^61 + 2^61, no wraparound for q < 2^63
    return jnp.where(s >= q, s - q, s)


def modsub(a, b, q):
    return jnp.where(a >= b, a - b, a + q - b)


def modneg(a, q):
    return jnp.where(a == 0, a, q - a)


def mont_mul(a, b, q, qinv_neg):
    """Montgomery product a*b*R^{-1} mod q (R = 2^64), inputs reduced mod q.

    ``qinv_neg`` = -q^{-1} mod 2^64 (``primes.mont_qinv_neg``).
    """
    t_hi, t_lo = _mul128(a, b)
    m = t_lo * qinv_neg  # low 64 bits; m*q ≡ -t_lo (mod 2^64)
    mq_hi, _ = _mul128(m, q)
    carry = (t_lo != 0).astype(U64)  # t_lo + mq_lo is 0 or exactly 2^64
    u = t_hi + mq_hi + carry
    return jnp.where(u >= q, u - q, u)


def modmul(a, b, q, qinv_neg, r2):
    """Exact a*b mod q via two Montgomery products (r2 = R^2 mod q)."""
    return mont_mul(mont_mul(a, r2, q, qinv_neg), b, q, qinv_neg)


def shoup_mul(a, w, w_shoup, q):
    """a*w mod q where w is a constant with Shoup companion w_shoup.

    w_shoup = floor(w * 2^64 / q) (``primes.shoup_precompute``). Requires
    a < q and q < 2^63.
    """
    hi = mul_hi(a, w_shoup)
    r = a * w - hi * q  # low 64 bits; r in [0, 2q)
    return jnp.where(r >= q, r - q, r)


def shoup_mul_wide(a, w, w_shoup, q):
    """a*w mod q for UNREDUCED a < 2^62 (w a constant with Shoup companion).

    With h = ⌊a·w_shoup/2^64⌋, r = a·w − h·q ∈ [0, q·(a/2^64) + 2q) < 3q
    for a < 2^62 — two conditional subtracts restore [0, q). Half the cost
    of the Montgomery ``modmul`` for constant multiplicands whose other
    operand may exceed q (base extension, cross-limb reductions)."""
    hi = mul_hi(a, w_shoup)
    r = a * w - hi * q
    r = jnp.where(r >= q + q, r - q - q, r)
    return jnp.where(r >= q, r - q, r)


def modpow_const(a, e: int, q, qinv_neg, r2):
    """a^e mod q for a *static python int* exponent (square-and-multiply,
    unrolled at trace time). Used only in precompute paths."""
    result = jnp.ones_like(a)
    base = a
    while e > 0:
        if e & 1:
            result = modmul(result, base, q, qinv_neg, r2)
        base = modmul(base, base, q, qinv_neg, r2)
        e >>= 1
    return result


def to_signed_center(a, q):
    """Map residues [0,q) to the centered representatives (-q/2, q/2] as f64.

    Host/CPU-only helper (f64) used at decode boundaries.
    """
    a = a.astype(jnp.float64)
    qf = float(q)
    return jnp.where(a > qf / 2, a - qf, a)

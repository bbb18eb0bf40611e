"""64-bit modular arithmetic on explicit 32-bit lane pairs.

Every u64 residue is carried as an (lo, hi) u32 pair and products are
synthesized from 16-bit digits (16x16→32 is exact in a u32 lane). These are
plain jnp functions; the four-step NTT (ops/fourstep.py) and the digit-matmul
NTT (ops/mxu_ntt.py) build their transform bodies on them.
"""

from __future__ import annotations

import jax.numpy as jnp

U32 = jnp.uint32
# Python-int constants (not device scalars): they fold into the op stream as
# weak-typed immediates.
M16 = 0xFFFF
S16 = 16


def split64(x64):
    """u64 array → (lo, hi) u32 pair (host/boundary helper)."""
    return (x64 & jnp.uint64(0xFFFFFFFF)).astype(U32), (x64 >> jnp.uint64(32)).astype(U32)


def join64(lo, hi):
    return lo.astype(jnp.uint64) | (hi.astype(jnp.uint64) << jnp.uint64(32))


def mul32_wide(a, b):
    """u32 × u32 → (hi, lo) u32 pair via 16-bit digit products."""
    al = a & M16
    ah = a >> S16
    bl = b & M16
    bh = b >> S16
    ll = al * bl
    lh = al * bh
    hl = ah * bl
    hh = ah * bh
    mid = (ll >> S16) + (lh & M16) + (hl & M16)          # ≤ 3·(2^16-1) < 2^18
    lo = (mid << S16) | (ll & M16)
    hi = hh + (lh >> S16) + (hl >> S16) + (mid >> S16)
    return hi, lo


def add64(alo, ahi, blo, bhi):
    """64-bit add with carry, u32 pairs."""
    lo = alo + blo
    carry = (lo < alo).astype(U32)
    hi = ahi + bhi + carry
    return lo, hi


def sub64(alo, ahi, blo, bhi):
    lo = alo - blo
    borrow = (alo < blo).astype(U32)
    hi = ahi - bhi - borrow
    return lo, hi


def geq64(alo, ahi, blo, bhi):
    """a >= b (u64 compare on pairs)."""
    return (ahi > bhi) | ((ahi == bhi) & (alo >= blo))


def mul64_wide(alo, ahi, blo, bhi):
    """64×64 → 128-bit product as four u32 words (w0..w3, little-endian)."""
    # partial products
    p0h, p0l = mul32_wide(alo, blo)        # contributes to w0,w1
    p1h, p1l = mul32_wide(alo, bhi)        # w1,w2
    p2h, p2l = mul32_wide(ahi, blo)        # w1,w2
    p3h, p3l = mul32_wide(ahi, bhi)        # w2,w3
    w0 = p0l
    # w1 = p0h + p1l + p2l  (collect carries into w2)
    s1 = p0h + p1l
    c1 = (s1 < p0h).astype(U32)
    w1 = s1 + p2l
    c1 = c1 + (w1 < s1).astype(U32)
    # w2 = p1h + p2h + p3l + c1
    s2 = p1h + p2h
    c2 = (s2 < p1h).astype(U32)
    w2 = s2 + p3l
    c2 = c2 + (w2 < s2).astype(U32)
    w2c = w2 + c1
    c2 = c2 + (w2c < w2).astype(U32)
    w3 = p3h + c2
    return w0, w1, w2c, w3


def mulhi64(alo, ahi, blo, bhi):
    """High 64 bits of the 128-bit product, as a u32 pair (lo=w2, hi=w3)."""
    w0, w1, w2, w3 = mul64_wide(alo, ahi, blo, bhi)
    return w2, w3


def mullo64(alo, ahi, blo, bhi):
    """Low 64 bits of the product (mod 2^64), as a u32 pair."""
    p0h, p0l = mul32_wide(alo, blo)
    lo = p0l
    hi = p0h + alo * bhi + ahi * blo     # low-32 products suffice for w1
    return lo, hi


def shoup_mul64(alo, ahi, wlo, whi, wslo, wshi, qlo, qhi):
    """a·w mod q with Shoup precomputation w_shoup = floor(w·2^64/q).

    All operands are u32 pairs; requires a < q < 2^63.
    r = a·w − mulhi(a, w_shoup)·q  (low 64 bits), then one conditional sub.
    """
    hlo, hhi = mulhi64(alo, ahi, wslo, wshi)
    awlo, awhi = mullo64(alo, ahi, wlo, whi)
    hqlo, hqhi = mullo64(hlo, hhi, qlo, qhi)
    rlo, rhi = sub64(awlo, awhi, hqlo, hqhi)
    over = geq64(rlo, rhi, qlo, qhi)
    slo, shi = sub64(rlo, rhi, qlo, qhi)
    return jnp.where(over, slo, rlo), jnp.where(over, shi, rhi)


def shoup_mul64_lazy(alo, ahi, wlo, whi, wslo, wshi, qlo, qhi):
    """a·w mod q with result in [0, 2q) — Harvey's lazy variant: skips the
    final conditional subtract. Valid for a < 4q (the estimate h =
    ⌊a·w_shoup/2^64⌋ is then off by at most 1 from ⌊a·w/q⌋, so
    r = a·w − h·q < 2q). Requires q < 2^62."""
    hlo, hhi = mulhi64(alo, ahi, wslo, wshi)
    awlo, awhi = mullo64(alo, ahi, wlo, whi)
    hqlo, hqhi = mullo64(hlo, hhi, qlo, qhi)
    return sub64(awlo, awhi, hqlo, hqhi)


def lazy_diff64(alo, ahi, blo, bhi, q2lo, q2hi):
    """a − b + 2q (no reduction) — in (0, 4q) for a, b < 2q. Two carries,
    no compare/select (vs modsub64's compare + select pair)."""
    tlo, thi = add64(alo, ahi, q2lo, q2hi)
    return sub64(tlo, thi, blo, bhi)


def csub64(alo, ahi, qlo, qhi):
    """One conditional subtract: a − q if a ≥ q (maps [0,2q) → [0,q))."""
    over = geq64(alo, ahi, qlo, qhi)
    dlo, dhi = sub64(alo, ahi, qlo, qhi)
    return jnp.where(over, dlo, alo), jnp.where(over, dhi, ahi)


def modadd64(alo, ahi, blo, bhi, qlo, qhi):
    slo, shi = add64(alo, ahi, blo, bhi)   # < 2q < 2^64: no overflow
    over = geq64(slo, shi, qlo, qhi)
    dlo, dhi = sub64(slo, shi, qlo, qhi)
    return jnp.where(over, dlo, slo), jnp.where(over, dhi, shi)


def modsub64(alo, ahi, blo, bhi, qlo, qhi):
    under = ~geq64(alo, ahi, blo, bhi)
    plo, phi = add64(alo, ahi, qlo, qhi)
    slo = jnp.where(under, plo, alo)
    shi = jnp.where(under, phi, ahi)
    return sub64(slo, shi, blo, bhi)


def mont_mul64_lazy(alo, ahi, blo, bhi, qlo, qhi, qinvlo, qinvhi):
    """Montgomery product a·b·2^{-64} mod q WITHOUT the final conditional
    subtract — result in [0, 2q). Valid for a < 4q, b < q, q < 2^62
    (u = (t + m·q)/2^64 < 4q²/2^64 + q < 2q). With b stored as
    w·2^64 mod q this computes a·w mod q lazily — the 2-table twin of
    shoup_mul64_lazy (which needs 4 tables: w and its Shoup constant)."""
    w0, w1, w2, w3 = mul64_wide(alo, ahi, blo, bhi)
    mlo, mhi = mullo64(w0, w1, qinvlo, qinvhi)
    mq2, mq3 = mulhi64(mlo, mhi, qlo, qhi)
    carry = ((w0 | w1) != 0).astype(U32)
    ulo, uhi = add64(w2, w3, mq2, mq3)
    ulo2 = ulo + carry
    uhi2 = uhi + (ulo2 < ulo).astype(U32)
    return ulo2, uhi2


def mont_mul64(alo, ahi, blo, bhi, qlo, qhi, qinvlo, qinvhi):
    """Montgomery product a·b·2^{-64} mod q on u32 pairs (qinv = -q^{-1} mod 2^64)."""
    w0, w1, w2, w3 = mul64_wide(alo, ahi, blo, bhi)
    t_lo, t_hi_lo = w0, w1              # low 64 of t
    mlo, mhi = mullo64(w0, w1, qinvlo, qinvhi)
    mq2, mq3 = mulhi64(mlo, mhi, qlo, qhi)
    carry = ((w0 | w1) != 0).astype(U32)
    ulo, uhi = add64(w2, w3, mq2, mq3)
    ulo2 = ulo + carry
    uhi2 = uhi + (ulo2 < ulo).astype(U32)
    over = geq64(ulo2, uhi2, qlo, qhi)
    dlo, dhi = sub64(ulo2, uhi2, qlo, qhi)
    return jnp.where(over, dlo, ulo2), jnp.where(over, dhi, uhi2)

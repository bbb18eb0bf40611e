"""RNS (residue number system) basis utilities.

The CRT compose/decompose pair (host-side, exact big-int — used at the
encode/decode boundaries and in tests) plus the device-side approximate base
extension used by hybrid key switching (HPS-style, float-estimated correction
term). Replaces OpenFHE's DCRTPoly CRT machinery (SURVEY.md §2.2).
"""

from __future__ import annotations

from typing import Sequence

import jax.numpy as jnp
import numpy as np

from . import primes
from .modarith import U64, modadd, modsub


# ---------------------------------------------------------------------------
# Host-side exact compose/decompose (Python big ints via object arrays)
# ---------------------------------------------------------------------------

def decompose_int(values, moduli: Sequence[int]) -> np.ndarray:
    """Integers (possibly negative, arbitrary precision) → residues u64[L, N]."""
    vals = np.asarray(values, dtype=object)
    out = np.zeros((len(moduli),) + vals.shape, dtype=np.uint64)
    for i, q in enumerate(moduli):
        out[i] = np.array([int(v) % q for v in vals.ravel()], dtype=np.uint64).reshape(vals.shape)
    return out


def compose_int(residues, moduli: Sequence[int]) -> np.ndarray:
    """Residues u64[L, N] → exact integers in [0, Q) as an object array."""
    res = np.asarray(residues)
    L = len(moduli)
    Q = 1
    for q in moduli:
        Q *= q
    coeffs = []
    for i, q in enumerate(moduli):
        Qi = Q // q
        coeffs.append((Qi * primes.mod_inverse(Qi % q, q)) % Q)
    flat = res.reshape(L, -1)
    n = flat.shape[1]
    out = np.zeros(n, dtype=object)
    for i in range(L):
        ci = coeffs[i]
        col = flat[i]
        for j in range(n):
            out[j] += int(col[j]) * ci
    for j in range(n):
        out[j] %= Q
    return out.reshape(res.shape[1:])


def compose_centered(residues, moduli: Sequence[int]) -> np.ndarray:
    """Residues → centered integers in (-Q/2, Q/2] (object array)."""
    Q = 1
    for q in moduli:
        Q *= q
    vals = compose_int(residues, moduli)
    flat = vals.ravel()
    for j in range(flat.size):
        if flat[j] > Q // 2:
            flat[j] -= Q
    return vals


# ---------------------------------------------------------------------------
# Device-side approximate base extension (coefficient domain)
# ---------------------------------------------------------------------------

class BaseExtender:
    """Fast base extension from basis ``src`` to basis ``dst`` (HPS 2016).

    Given residues of x (|x| reduced mod D = prod(src), balanced by the
    float-estimated multiple-of-D correction), produce residues of the same
    integer mod every prime in ``dst``. The correction term alpha =
    round(sum_i y_i / d_i) is estimated in f64 — exact for the limb counts
    used here (<= 8 limbs, error probability ~2^-40 per coefficient, and any
    slip contributes a bounded additive D to the key-switch noise).

    All tensors are precomputed at context build; ``extend`` is pure jnp.
    """

    def __init__(self, src: Sequence[int], dst: Sequence[int]):
        self.src = tuple(int(q) for q in src)
        self.dst = tuple(int(q) for q in dst)
        D = 1
        for q in self.src:
            D *= q
        ls, ld = len(self.src), len(self.dst)

        dhat_inv = np.zeros((ls, 1), np.uint64)       # [ (D/d_i)^{-1} ]_{d_i}
        dhat_mod_dst = np.zeros((ld, ls), np.uint64)  # [ D/d_i ]_{p_j}
        d_mod_dst = np.zeros((ld, 1), np.uint64)      # [ D ]_{p_j}
        for i, q in enumerate(self.src):
            Di = D // q
            dhat_inv[i, 0] = primes.mod_inverse(Di % q, q)
        for j, p in enumerate(self.dst):
            d_mod_dst[j, 0] = D % p
            for i, q in enumerate(self.src):
                dhat_mod_dst[j, i] = (D // q) % p

        # host numpy constants: BaseExtenders are built lazily (possibly
        # inside a jit trace) and cached on the context — device arrays here
        # would leak tracers across traces.
        self.dhat_inv = dhat_inv
        self.dhat_inv_shoup = np.array(
            [[primes.shoup_precompute(int(dhat_inv[i, 0]), self.src[i])]
             for i in range(ls)], np.uint64)
        self.dhat_mod_dst = dhat_mod_dst
        self.d_mod_dst = d_mod_dst
        # Shoup companions for the dst-side constants (consumed by the
        # wide-Shoup path in extend(): the y_i operands exceed the smaller
        # dst moduli, so the 2-csub variant applies)
        self.dhat_mod_dst_shoup = np.array(
            [[primes.shoup_precompute(int(dhat_mod_dst[j, i]), self.dst[j])
              for i in range(ls)] for j in range(ld)], np.uint64)
        self.d_mod_dst_shoup = np.array(
            [[primes.shoup_precompute(int(d_mod_dst[j, 0]), self.dst[j])]
             for j in range(ld)], np.uint64)
        self.src_q = np.array(self.src, np.uint64).reshape(ls, 1)
        self.src_qinv = np.array([primes.mont_qinv_neg(q) for q in self.src],
                                 np.uint64).reshape(ls, 1)
        self.src_r2 = np.array([primes.mont_r2(q) for q in self.src],
                               np.uint64).reshape(ls, 1)
        self.dst_q = np.array(self.dst, np.uint64).reshape(ld, 1)
        self.dst_qinv = np.array([primes.mont_qinv_neg(q) for q in self.dst],
                                 np.uint64).reshape(ld, 1)
        self.dst_r2 = np.array([primes.mont_r2(q) for q in self.dst],
                               np.uint64).reshape(ld, 1)
        self.src_q_f = np.array(self.src, np.float64).reshape(ls, 1)
        # Q0.64 fixed-point reciprocals round(2^64/d_i) for the integer alpha
        # estimate: integer-only, no f64 on the device (see extend()).
        self.recip_fix = np.array(
            [((1 << 64) + q // 2) // q for q in self.src], np.uint64
        ).reshape(ls, 1)

    def extend(self, x):
        """x: u64[..., ls, N] residues (coeff domain) → u64[..., ld, N]."""
        from .modarith import shoup_mul

        # y_i = [x_i * dhat_inv_i]_{d_i}
        y = shoup_mul(x, self.dhat_inv, self.dhat_inv_shoup, self.src_q)
        # alpha ≈ round(sum_i y_i / d_i), the number of multiples of D to
        # remove. Integer Q0.64 fixed point: frac_i = y_i·round(2^64/d_i)
        # mod 2^64 (y_i < d_i ⇒ the true product < ~2^64, so the wrapped
        # low-64 product IS the fraction; per-term error ≤ y_i/2^65 < 2^-5,
        # within the approximate-extension noise bound exactly like the f64
        # rounding slip it replaces). Sum with carry counting (ls ≤ 8), then
        # alpha = carry + round-bit.
        frac = y * self.recip_fix                       # wrapping u64 mullo
        ls = len(self.src)
        acc = frac[..., 0:1, :]
        carry = jnp.zeros_like(acc)
        for i in range(1, ls):
            nxt = acc + frac[..., i : i + 1, :]         # wrapping
            carry = carry + (nxt < acc).astype(U64)
            acc = nxt
        alpha = carry + (acc >> jnp.uint64(63))         # + round(frac of acc)
        # z_j = sum_i y_i * [D/d_i]_{p_j} - alpha * [D]_{p_j}  (mod p_j)
        # Wide-Shoup constant multiplies (shoup_mul_wide): y_i < d_i may
        # exceed the smaller dst moduli, so the 2-csub variant applies —
        # half the Montgomery modmul's cost.
        from .modarith import shoup_mul_wide

        acc = jnp.zeros(x.shape[:-2] + (len(self.dst), x.shape[-1]), U64)
        for i in range(ls):
            term = shoup_mul_wide(
                jnp.broadcast_to(y[..., i : i + 1, :], acc.shape),
                self.dhat_mod_dst[:, i : i + 1],
                self.dhat_mod_dst_shoup[:, i : i + 1], self.dst_q,
            )
            acc = modadd(acc, term, self.dst_q)
        corr = shoup_mul_wide(
            jnp.broadcast_to(alpha, acc.shape),
            self.d_mod_dst, self.d_mod_dst_shoup, self.dst_q,
        )
        return modsub(acc, corr, self.dst_q)

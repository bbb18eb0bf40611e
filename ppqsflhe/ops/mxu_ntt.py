"""Digit-matmul four-step NTT — the integer-matrix-product formulation.

The four-step factorization's column transforms ARE m×m matrix multiplies
mod q (m = n1, n2 ≤ 256). The u32-pair path (ops/fourstep.py) pays ~1000
scalar ops/coefficient for them; this module instead runs them as EXACT
int8 matrix products via 7-bit digit slicing (the AI-ASIC
multi-precision-systolic technique, PAPERS.md: "Low-Cost Multi-Precision
Systolic Arrays for Accelerating FHE NTTs on AI ASICs"):

- operand residues x < 4q split into nd = ceil((bits(q)+2)/7) digits of
  7 bits (values 0..127 — int8-exact);
- the transform matrix M is premultiplied per input digit,
  V_d = M·2^{7d} mod q, and each V_d is itself digit-sliced, giving an
  int8 tensor A[e, k, (d, j)];
- ONE int8 dot (int32 accumulation) contracts (d, j): the largest
  contraction is 9·256 = 2304 with products ≤ 127², so partial sums stay
  < 2^31 — bit-exact on any int8 matrix unit;
- the nd output planes P_e < 2^26 recompose elementwise as
  Σ 2^{7e}·P_e mod q.

Design rules:

- ALL elementwise glue is explicit u32-pair arithmetic (ops/u32pair.py);
  u64 appears only at the API boundary (split64/join64).
- Harvey-lazy chaining: recompose outputs stay in [0, 4q) (no Barrett for
  q ≥ ~2^30: the low plane-group is already < 4q and the high group rides
  ONE lazy Shoup multiply by 2^{7·split} mod q); the next digitization
  tolerates any value < 2^{7·nd}, and the single elementwise twiddle is a
  lazy Shoup multiply (valid for inputs < 4q). Exact residues are restored
  by two conditional subtracts at the very end of the transform.
- transpose-free: the second stage contracts the MINOR axis
  (einsum 'ekJ,...rJ->...ekr'), so the inter-stage transpose of the
  classic four-step dissolves into the matrix product's own dataflow.

The twist is GONE as a separate pass: ψ^{j1·n2} folds into the stage-1
matrix (negacyclic ψ1^{j1(2k1+1)}) and ψ^{j2} into the stage-2 matrix,
leaving exactly one elementwise twiddle T[r, j2] = ω^{j2·rev1(r)} between
the matmuls (genuinely rank-coupled — not a matrix product).

Output ordering is identical to ops/fourstep.py's kernel order
(u = rev2(k2)·n1 + rev1(k1)), so this backend is bit-exact interchangeable
with the 'xla' implementation.

Pure jnp: XLA lowers the int8 dot with int32 accumulation to an integer
GEMM on the GPU and to vector int8 multiplies on CPU (tests run everywhere).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from ..core import primes
from ..core.ntt import bit_reverse_indices
from . import u32pair as up

DIGIT_BITS = 7
DIGIT_MASK = (1 << DIGIT_BITS) - 1


def _digit_count(q: int) -> int:
    # operands may be lazy (< 4q), so cover bits(q) + 2
    return -(-(int(q).bit_length() + 2) // DIGIT_BITS)


def _slice_matrix(m_modq: np.ndarray, q: int, nd: int) -> np.ndarray:
    """M (k×j, mod q) → int8 A[e, k, (d·j_dim + j)]: digit e of M·2^{7d}."""
    k_dim, j_dim = m_modq.shape
    a = np.zeros((nd, k_dim, nd * j_dim), np.int8)
    for d in range(nd):
        vd = (m_modq.astype(object) * (1 << (DIGIT_BITS * d))) % q
        for e in range(nd):
            dig = ((vd >> (DIGIT_BITS * e)) & DIGIT_MASK).astype(np.int8)
            a[e, :, d * j_dim : (d + 1) * j_dim] = dig
    return a


def _pow_table(base: int, exps: np.ndarray, q: int) -> np.ndarray:
    """base^exps mod q elementwise (exps may be negative → inverse base)."""
    inv = primes.mod_inverse(base % q, q)
    flat = [pow(base if e >= 0 else inv, abs(int(e)), q) for e in exps.ravel()]
    return np.array(flat, np.uint64).reshape(exps.shape)


def _pair_split(x64: np.ndarray):
    return ((x64 & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (x64 >> np.uint64(32)).astype(np.uint32))


def _shoup_quad(w: np.ndarray, q: int):
    """(wlo, whi, wslo, wshi) u32 tables for lazy Shoup multiplies."""
    sh = np.array([(int(x) << 64) // q for x in w.ravel()],
                  np.uint64).reshape(w.shape)
    wlo, whi = _pair_split(w.astype(np.uint64))
    slo, shi = _pair_split(sh)
    return wlo, whi, slo, shi


@dataclass
class _Recompose:
    """Static per-modulus plan for plane recomposition (see module doc).

    'redc' (the normal path): the digit matrices carry an extra factor
    R = 2^{7·split} mod q, and recomposition is
        Y ≡ REDC_R(Σ_{e<split} 2^{7e}·P_e) + Σ_{e≥split} 2^{7(e-split)}·P_e
    — ONE Montgomery reduction by R ≤ 2^28 (two 32-bit widening multiplies)
    instead of a Shoup or Barrett step; output < 4q (planner-verified).
    'barrett' is the fallback for exotic moduli where the bounds fail."""

    mode: str               # 'redc' | 'barrett'
    split: int              # first plane of the high group ('redc')
    qinv_r: int             # -q^{-1} mod 2^{7·split} ('redc')
    mu_pair: tuple          # ⌊2^64/q⌋ as u32 pair ('barrett')


@dataclass
class MxuNttTables:
    """Per-modulus precompute for forward+inverse MXU transforms."""

    n: int
    n1: int
    n2: int
    q: int
    nd: int
    a1: np.ndarray        # int8 [nd, n1, nd·n1]   stage-1 fwd (negacyclic ψ1)
    a2: np.ndarray        # int8 [nd, n2, nd·n2]   stage-2 fwd (ω2·ψ^{j2})
    a2i: np.ndarray       # int8 [nd, n2, nd·n2]   stage-1 inv
    a1i: np.ndarray       # int8 [nd, n1, nd·n1]   stage-2 inv (N^{-1} folded)
    t1: tuple             # u32 quad (n1, n2): ω^{j2·rev1(r)}
    t1i: tuple            # u32 quad (n2, n1): ω^{-j2·rev1(r1)}
    q_pair: tuple         # (qlo, qhi) u32 scalars
    q2_pair: tuple        # (2q lo, hi)
    plan: _Recompose

    @staticmethod
    def build(n: int, q: int, psi: int) -> "MxuNttTables":
        n1 = 1 << ((n.bit_length() - 1) // 2)
        n2 = n // n1
        q = int(q)
        psi = int(psi)
        nd = _digit_count(q)
        rev1 = bit_reverse_indices(n1)
        rev2 = bit_reverse_indices(n2)
        j1 = np.arange(n1)
        j2 = np.arange(n2)

        psi1 = pow(psi, n2, q)          # primitive 2·n1-th root
        om2 = pow(psi, 2 * n1, q)       # primitive n2-th root
        ninv = primes.mod_inverse(n % q, q)

        # stage-1 fwd: M1[r, j1] = ψ1^{j1·(2·rev1[r]+1)}  (negacyclic: the
        # ψ^{j1·n2} half of the twist lives in the "+1")
        m1 = _pow_table(psi1, np.outer(2 * rev1 + 1, j1), q)
        # stage-2 fwd: M2[r2, j2] = ψ^{j2}·ω2^{j2·rev2[r2]}  (the ψ^{j2}
        # half of the twist folds in as a column scale)
        m2 = _pow_table(om2, np.outer(rev2, j2), q)
        colscale = _pow_table(psi, j2, q)
        m2 = ((m2.astype(object) * colscale.astype(object)[None, :]) % q
              ).astype(np.uint64)
        # inverse stage-1: M2i[j2, r2] = ψ^{-j2}·ω2^{-j2·rev2[r2]}
        m2i = _pow_table(om2, -np.outer(j2, rev2), q)
        icolscale = _pow_table(psi, -j2, q)
        m2i = ((m2i.astype(object) * icolscale.astype(object)[:, None]) % q
               ).astype(np.uint64)
        # inverse stage-2: M1i[j1, r1] = N^{-1}·ψ1^{-j1·(2·rev1[r1]+1)}
        m1i = _pow_table(psi1, -np.outer(j1, 2 * rev1 + 1), q)
        m1i = ((m1i.astype(object) * ninv) % q).astype(np.uint64)

        # the surviving elementwise twiddle ω^{±j2·k1} (ω = ψ²)
        t1 = _pow_table(psi, 2 * np.outer(rev1, j2), q)
        t1i = _pow_table(psi, -2 * np.outer(j2, rev1), q)

        # recompose plan: plane magnitude bound from the widest contraction.
        # split=4 is tried FIRST (even when nd < 4 — the high group is then
        # empty and the single REDC covers everything) so every limb of a
        # chain shares one plan.
        pmax = 127 * 127 * nd * max(n1, n2)
        redc_fold = 1
        plan = None
        for split in (4, 3, 2, 1):
            r_bits = DIGIT_BITS * split
            lo_max = sum(pmax << (DIGIT_BITS * e)
                         for e in range(min(split, nd)))
            hi_max = sum(pmax << (DIGIT_BITS * (e - split))
                         for e in range(split, nd))
            if lo_max < (1 << r_bits) * q \
                    and (lo_max >> r_bits) + q + hi_max < 4 * q \
                    and DIGIT_BITS * max(0, nd - 1 - split) <= 38:
                plan = _Recompose(
                    mode="redc", split=split,
                    qinv_r=(-primes.mod_inverse(q % (1 << r_bits),
                                                1 << r_bits)) % (1 << r_bits),
                    mu_pair=(np.uint32(0), np.uint32(0)))
                redc_fold = pow(2, r_bits, q)  # folded into the matrices
                break
        if plan is None:
            mu = (1 << 64) // q
            plan = _Recompose(
                mode="barrett", split=0, qinv_r=0,
                mu_pair=(np.uint32(mu & 0xFFFFFFFF), np.uint32(mu >> 32)))
        if redc_fold != 1:
            for m in (m1, m2, m2i, m1i):
                m[...] = ((m.astype(object) * redc_fold) % q).astype(np.uint64)

        return MxuNttTables(
            n=n, n1=n1, n2=n2, q=q, nd=nd,
            a1=_slice_matrix(m1, q, nd), a2=_slice_matrix(m2, q, nd),
            a2i=_slice_matrix(m2i, q, nd), a1i=_slice_matrix(m1i, q, nd),
            t1=_shoup_quad(t1, q), t1i=_shoup_quad(t1i, q),
            q_pair=(np.uint32(q & 0xFFFFFFFF), np.uint32(q >> 32)),
            q2_pair=(np.uint32((2 * q) & 0xFFFFFFFF), np.uint32((2 * q) >> 32)),
            plan=plan,
        )


# ---------------------------------------------------------------------------
# Runtime (pure jnp on u32 pairs; per-limb static shapes)
# ---------------------------------------------------------------------------

def _digitize(lo, hi, nd: int, axis: int):
    """u32 pair (value < 2^{7·nd}) → int8 digits concatenated d-major along
    ``axis`` (must be -1 or -2), matching :func:`_slice_matrix`'s (d, j)
    contraction layout."""
    digs = []
    for d in range(nd):
        s = DIGIT_BITS * d
        if s + DIGIT_BITS <= 32:
            v = (lo >> s) & DIGIT_MASK
        elif s >= 32:
            v = (hi >> (s - 32)) & DIGIT_MASK
        else:
            v = ((lo >> s) | (hi << (32 - s))) & DIGIT_MASK
        digs.append(v.astype(jnp.int8))
    return jnp.concatenate(digs, axis=axis)


def _shl_pair(p, s: int):
    """(u32 value p < 2^26, 0) << s for 0 ≤ s ≤ 38 → u32 pair."""
    if s == 0:
        return p, jnp.zeros_like(p)
    if s >= 32:
        return jnp.zeros_like(p), p << (s - 32)
    return p << s, p >> (32 - s)


def _recompose(planes_i32, tabs: MxuNttTables):
    """int32 planes (..., nd, k, c) → u32 pair (..., k, c), value < 4q
    ('lazy') or < 2q ('barrett'). Pure u32-pair arithmetic."""
    nd = tabs.nd
    qlo, qhi = tabs.q_pair
    p = planes_i32.astype(jnp.uint32)
    plan = tabs.plan

    def group_sum(lo_e, hi_e):
        """Σ_{e in [lo_e, hi_e)} P_e << 7(e - lo_e), as a u32 pair."""
        slo, shi = _shl_pair(p[..., lo_e, :, :], 0)
        for e in range(lo_e + 1, hi_e):
            tlo, thi = _shl_pair(p[..., e, :, :], DIGIT_BITS * (e - lo_e))
            slo, shi = up.add64(slo, shi, tlo, thi)
        return slo, shi

    if plan.mode == "redc":
        # the matrices carry an extra 2^{7·split} mod q, cancelled here by
        # ONE Montgomery reduction of the low plane group (R = 2^{7·split}):
        #   u = (S_lo + m·q) >> 7s,  m = S_lo·(-q^{-1}) mod R
        # u < S_lo/R + q; plus the high group (plain shifts) < 4q total.
        rs = DIGIT_BITS * plan.split
        mask = np.uint32((1 << rs) - 1)
        slo, shi = group_sum(0, min(plan.split, nd))
        m = (slo & mask) * np.uint32(plan.qinv_r & 0xFFFFFFFF) & mask
        h1, l1 = up.mul32_wide(m, qlo)
        h2, l2 = up.mul32_wide(m, qhi)
        w0 = slo + l1
        c0 = (w0 < slo).astype(jnp.uint32)
        t = shi + h1
        c1 = (t < shi).astype(jnp.uint32)
        t2 = t + l2
        c1 = c1 + (t2 < t).astype(jnp.uint32)
        w1 = t2 + c0
        c1 = c1 + (w1 < t2).astype(jnp.uint32)
        w2 = h2 + c1
        ulo = (w0 >> rs) | (w1 << (32 - rs))
        uhi = (w1 >> rs) | (w2 << (32 - rs))
        if plan.split < nd:
            glo, ghi = group_sum(plan.split, nd)
            return up.add64(ulo, uhi, glo, ghi)
        return ulo, uhi
    # barrett fallback: x < 2^63 → x - ⌊x·μ/2^64⌋·q ∈ [0, 2q)
    slo, shi = group_sum(0, nd)
    mlo, mhi = plan.mu_pair
    hlo, hhi = up.mulhi64(slo, shi, mlo, mhi)
    hqlo, hqhi = up.mullo64(hlo, hhi, qlo, qhi)
    return up.sub64(slo, shi, hqlo, hqhi)                 # < 2q


def _strict(lo, hi, tabs: MxuNttTables):
    """[0, 4q) → exact residues [0, q) (two conditional subtracts)."""
    qlo, qhi = tabs.q_pair
    q2lo, q2hi = tabs.q2_pair
    lo, hi = up.csub64(lo, hi, q2lo, q2hi)
    return up.csub64(lo, hi, qlo, qhi)


def _stage(lo, hi, a_int8, tabs: MxuNttTables, contract_axis: int):
    """One digit-matmul column transform. contract_axis ∈ {-2, -1}:
    -2 contracts the row axis ('ekJ,...Jc->...ekc'), -1 the minor axis
    ('ekJ,...rJ->...ekr') — the latter absorbs the four-step transpose."""
    digs = _digitize(lo, hi, tabs.nd, axis=contract_axis)
    eq = "ekj,...jc->...ekc" if contract_axis == -2 else "ekj,...cj->...ekc"
    p = jnp.einsum(eq, a_int8, digs, preferred_element_type=jnp.int32)
    return _recompose(p, tabs)


def _lazy_tmul(lo, hi, quad, tabs: MxuNttTables):
    qlo, qhi = tabs.q_pair
    wlo, whi, wslo, wshi = (jnp.asarray(t) for t in quad)
    return up.shoup_mul64_lazy(lo, hi, wlo, whi, wslo, wshi, qlo, qhi)


def mxu_ntt_limb(x, tabs: MxuNttTables):
    """Forward negacyclic NTT, one limb: u64 (..., N) coeff (natural order)
    → u64 (..., N) eval (kernel order). Bit-exact ≡ fourstep.ntt_body."""
    n1, n2 = tabs.n1, tabs.n2
    y = x.reshape(x.shape[:-1] + (n1, n2))
    lo, hi = up.split64(y)
    lo, hi = _stage(lo, hi, jnp.asarray(tabs.a1), tabs, -2)   # (..., n1, n2)
    lo, hi = _lazy_tmul(lo, hi, tabs.t1, tabs)
    lo, hi = _stage(lo, hi, jnp.asarray(tabs.a2), tabs, -1)   # (..., n2, n1)
    lo, hi = _strict(lo, hi, tabs)
    return up.join64(lo, hi).reshape(x.shape[:-1] + (tabs.n,))


def mxu_intt_limb(x, tabs: MxuNttTables):
    """Inverse, one limb: kernel-order eval → natural-order coefficients."""
    n1, n2 = tabs.n1, tabs.n2
    y = x.reshape(x.shape[:-1] + (n2, n1))
    lo, hi = up.split64(y)
    lo, hi = _stage(lo, hi, jnp.asarray(tabs.a2i), tabs, -2)  # (..., n2, n1)
    lo, hi = _lazy_tmul(lo, hi, tabs.t1i, tabs)
    lo, hi = _stage(lo, hi, jnp.asarray(tabs.a1i), tabs, -1)  # (..., n1, n2)
    lo, hi = _strict(lo, hi, tabs)
    return up.join64(lo, hi).reshape(x.shape[:-1] + (tabs.n,))

"""Homomorphic evaluation: add, mult, rescale, hybrid key switching,
relinearization, Galois rotations (with hoisting).

Replaces OpenFHE's LeveledSHE/AdvancedSHE for CKKS-RNS (reference call sites:
EvalAdd/EvalMult — server/src/aggregateEncryptedWeights.cpp:82-83; ReEncrypt
key switching — server/src/changeCipherDomain.cpp:74).

Key-switch design (HYBRID, dnum digits, special primes P — SURVEY.md §2.3):
the KSK for digit j encrypts P·t·Q̂_j where Q̂_j = Q_full/D_j is the *full*
basis CRT cofactor. The level-l decomposition multiplies the ciphertext's
group-j residues by [Q̂_j^{-1}]_{q_i} before base extension, which makes
    Σ_j Q̂_j · [c·Q̂_j^{-1}]_{D_j∩active} ≡ c  (mod Q_l)
hold with level-independent key material — one KSK serves every level.

Galois rotations act in the evaluation domain as precomputed index gathers
(bin k holds the value at root ψ^{2·bitrev(k)+1}; the automorphism X→X^g is
a permutation of those bins), so a rotation costs one gather + one key
switch — no NTTs. Hoisting shares the decompose+extend across rotations.
"""

from __future__ import annotations

import functools
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..core import primes, sampling
from ..core.modarith import U64, modadd, modsub, modneg, modmul, shoup_mul
from ..core.ntt import bit_reverse_indices
from .params import CkksContext, _const_stack
from .types import Ciphertext, KeySwitchKey, Plaintext, PublicKey, SecretKey


# ---------------------------------------------------------------------------
# Linear ops
# ---------------------------------------------------------------------------

def _match(ct1: Ciphertext, ct2: Ciphertext):
    l = min(ct1.nlimbs, ct2.nlimbs)
    if not np.isclose(ct1.scale, ct2.scale, rtol=1e-10):
        raise ValueError(f"scale mismatch: {ct1.scale} vs {ct2.scale}")
    return ct1.data[:, :l], ct2.data[:, :l], l


def add(ctx: CkksContext, ct1: Ciphertext, ct2: Ciphertext) -> Ciphertext:
    d1, d2, l = _match(ct1, ct2)
    q, _, _ = ctx.limb_consts(ctx.q_idx(l))
    return Ciphertext(data=modadd(d1, d2, q), scale=ct1.scale)


def sub(ctx: CkksContext, ct1: Ciphertext, ct2: Ciphertext) -> Ciphertext:
    d1, d2, l = _match(ct1, ct2)
    q, _, _ = ctx.limb_consts(ctx.q_idx(l))
    return Ciphertext(data=modsub(d1, d2, q), scale=ct1.scale)


def negate(ctx: CkksContext, ct: Ciphertext) -> Ciphertext:
    q, _, _ = ctx.limb_consts(ctx.q_idx(ct.nlimbs))
    return ct.with_data(modneg(ct.data, q))


def add_plain(ctx: CkksContext, ct: Ciphertext, pt: Plaintext) -> Ciphertext:
    l = min(ct.nlimbs, pt.nlimbs)
    q, _, _ = ctx.limb_consts(ctx.q_idx(l))
    c0 = modadd(ct.data[0, :l], pt.data[:l], q)
    return Ciphertext(data=ct.data[:, :l].at[0].set(c0), scale=ct.scale)


def mult_plain(ctx: CkksContext, ct: Ciphertext, pt: Plaintext) -> Ciphertext:
    """Pointwise eval-domain product; scales multiply (rescale separately)."""
    l = min(ct.nlimbs, pt.nlimbs)
    idx = ctx.q_idx(l)
    q, qinv, r2 = ctx.limb_consts(idx)
    return Ciphertext(
        data=modmul(ct.data[:, :l], pt.data[None, :l], q, qinv, r2),
        scale=ct.scale * pt.scale,
    )


def mult_scalar(ctx: CkksContext, ct: Ciphertext, c: float, rescale_after: bool = True) -> Ciphertext:
    """EvalMult(ct, double) — the reference's aggregation op
    (aggregateEncryptedWeights.cpp:83, c = 0.5, then ÷ by rescale).

    The constant encodes exactly (no FFT) at scale q_last, so after the
    mandatory rescale the ciphertext scale is *unchanged* — the
    FLEXIBLEAUTO behavior. With rescale_after=False it encodes at Δ and the
    scale picks up a Δ factor.
    """
    l = ct.nlimbs
    idx = ctx.q_idx(l)
    q, _, _ = ctx.limb_consts(idx)
    enc_scale = float(ctx.moduli_qp[l - 1]) if rescale_after else ctx.params.scale
    m = int(round(c * enc_scale))
    res = [m % ctx.moduli_qp[i] for i in idx]
    residues = _const_stack(res)
    sh = _const_stack([primes.shoup_precompute(r_, ctx.moduli_qp[i])
                       for r_, i in zip(res, idx)])
    out = ct.with_data(shoup_mul(ct.data, residues[None], sh[None], q))
    out = Ciphertext(out.data, scale=ct.scale * enc_scale)
    return rescale(ctx, out) if rescale_after else out


# ---------------------------------------------------------------------------
# Rescale (drop the highest active limb, centered exact-division)
# ---------------------------------------------------------------------------

def _reduce_into(x, q, qinv, r2):
    """Reduce arbitrary u64 residues into [0, q) per-limb (x may exceed q).
    Wide Shoup by the constant 1 (= Barrett): valid for x < 2^62."""
    from ..core.modarith import shoup_mul_wide

    ones = jnp.ones_like(q)
    # Shoup companion of 1 is ⌊2^64/q⌋ — derivable on host from q? q is a
    # traced/np array here; compute companions via the float-free identity
    # ⌊2^64/q⌋ = ⌊(2^64−1)/q⌋ for non-power-of-two q (q odd prime > 2).
    sh = (~jnp.uint64(0)) // q
    return shoup_mul_wide(x, ones, sh, q)


def rescale(ctx: CkksContext, ct: Ciphertext) -> Ciphertext:
    l = ct.nlimbs
    if l < 2:
        raise ValueError("cannot rescale a single-limb ciphertext")
    ql = ctx.moduli_qp[l - 1]
    rem_idx = ctx.q_idx(l - 1)
    q, qinv, r2 = ctx.limb_consts(rem_idx)
    qlinv, qlinv_sh, ql_mod, _ = ctx.rescale_consts(l)

    # NOTE: n from the array, not ctx.params.n — inside a shard_map body
    # (parallel/sharded_scheme.py) the local trailing dim is N/D.
    last_coeff = ctx.intt(ct.data[:, l - 1 : l, :], (l - 1,))      # (k,1,n)
    r = jnp.broadcast_to(last_coeff,
                         ct.data.shape[:1] + (l - 1, ct.data.shape[-1]))
    pos = _reduce_into(r, q, qinv, r2)
    # centered lift: r - ql when r > ql/2
    lifted = jnp.where(r > jnp.uint64(ql // 2), modsub(pos, ql_mod, q), pos)
    lifted_eval = ctx.ntt(lifted, rem_idx)
    diff = modsub(ct.data[:, : l - 1], lifted_eval, q)
    out = shoup_mul(diff, qlinv, qlinv_sh, q)
    return Ciphertext(data=out, scale=ct.scale / float(ql))


def level_reduce(ctx: CkksContext, ct: Ciphertext, target_nlimbs: int) -> Ciphertext:
    """Drop limbs without scaling (modulus reduction)."""
    return Ciphertext(data=ct.data[:, :target_nlimbs], scale=ct.scale)


# ---------------------------------------------------------------------------
# Hybrid key switching
# ---------------------------------------------------------------------------

def _ks_decomp_consts(ctx: CkksContext, nlimbs: int):
    """Per active-group constants [Q̂_j^{-1}]_{q_i} (i in group j).

    Cached on the context itself (not a module-global registry) so contexts
    are garbage-collectable — long-running orchestrators that build many
    schemes (param sweeps) must not leak key-switch precomputes.
    """
    cache = ctx._ks_decomp_cache
    if nlimbs in cache:
        return cache[nlimbs]
    L = ctx.params.num_q
    QF = 1
    for i in range(L):
        QF *= ctx.moduli_qp[i]
    groups = [tuple(i for i in g if i < nlimbs) for g in ctx.digit_groups]
    groups = [g for g in groups if g]
    out = []
    for g_full, g in zip(ctx.digit_groups, groups):
        Dj = 1
        for i in g_full:
            Dj *= ctx.moduli_qp[i]
        Qhat = QF // Dj
        inv = [primes.mod_inverse(Qhat % ctx.moduli_qp[i], ctx.moduli_qp[i]) for i in g]
        qs = [ctx.moduli_qp[i] for i in g]
        out.append((
            _const_stack(inv),
            np.array([primes.shoup_precompute(v, q) for v, q in zip(inv, qs)],
                     np.uint64).reshape(-1, 1),
        ))
    cache[nlimbs] = (groups, out)
    return groups, out


def keyswitch_core(ctx: CkksContext, c_eval, nlimbs: int):
    """Decompose+extend a single eval-domain poly c (u64[l, n]) into the list
    of digit polys over the extended basis (active Q + P), eval domain.

    This is the expensive, *hoistable* half of a key switch.
    """
    l = nlimbs
    idx_q = ctx.q_idx(l)
    idx_p = ctx.p_idx()
    idx_ext = tuple(idx_q) + idx_p
    groups, consts = _ks_decomp_consts(ctx, l)
    c_coeff = ctx.intt(c_eval, idx_q)
    digits = []
    for g, (ghat_inv, ghat_inv_sh) in zip(groups, consts):
        sel = np.asarray(g, dtype=np.int32)
        qg = ctx.q_vec[sel]
        other = tuple(i for i in idx_ext if i not in g)
        d = shoup_mul(c_coeff[sel], ghat_inv, ghat_inv_sh, qg)
        ext = ctx.extender(g, other).extend(d)
        ext_eval = ctx.ntt(ext, other)
        # own-group rows never leave the eval domain: multiplying by the
        # constant [Q̂_j^{-1}]_{q_i} commutes with the NTT, so compute them
        # from c_eval directly instead of NTT-ing d back (saves one
        # limb-transform per own row — ~17% of the key-switch NTT count).
        d_eval = shoup_mul(c_eval[sel], ghat_inv, ghat_inv_sh, qg)
        rows = []
        gi = oi = 0
        for i in idx_ext:
            if i in g:
                rows.append(d_eval[gi : gi + 1])
                gi += 1
            else:
                rows.append(ext_eval[oi : oi + 1])
                oi += 1
        digits.append(jnp.concatenate(rows, axis=0))
    return digits


def ksk_to_mont(ctx: CkksContext, ksk: KeySwitchKey) -> KeySwitchKey:
    """Convert a key-switch key to Montgomery form (k·2^64 mod q per limb):
    the per-ciphertext inner product in :func:`keyswitch_apply` then costs
    ONE mont_mul per element instead of a full modmul (two). One device
    pass per key — rekeys/relin/rotation keys are loaded once and reused
    across every ciphertext of a round, so this always amortizes.
    (k·R mod q = mont_mul(k, R² mod q).)"""
    from ..core.modarith import mont_mul

    if ksk.mont:
        return ksk
    all_idx = tuple(range(len(ctx.moduli_qp)))
    q, qinv, r2 = ctx.limb_consts(all_idx)
    return KeySwitchKey(data=mont_mul(ksk.data, r2, q, qinv), mont=True)


def keyswitch_apply(ctx: CkksContext, digits, ksk: KeySwitchKey, nlimbs: int):
    """Inner-product digits with the KSK and ModDown by P.
    Returns (d0, d1) over the active Q limbs, eval domain."""
    acc0, acc1 = keyswitch_ip(ctx, digits, ksk, nlimbs)
    # one batched ModDown for both components (leading stack dim rides
    # through the NTTs/extension — better lane utilization than two calls)
    both = _mod_down(ctx, jnp.stack([acc0, acc1]), nlimbs)
    return both[0], both[1]


def keyswitch_ip(ctx: CkksContext, digits, ksk: KeySwitchKey, nlimbs: int):
    """The KSK inner product alone: (Σ_j d_j·k_j0, Σ_j d_j·k_j1) over the
    EXTENDED basis (active Q + P), eval domain — no ModDown. Split out so
    double-hoisted rotation sums (rotate_sum_hoisted) can accumulate in
    the extended basis and pay ONE deferred ModDown."""
    from ..core.modarith import mont_mul

    l = nlimbs
    idx_q = ctx.q_idx(l)
    idx_p = ctx.p_idx()
    sel_ext = np.asarray(tuple(idx_q) + tuple(idx_p), dtype=np.int32)
    q_ext, qinv_ext, r2_ext = ctx.limb_consts(sel_ext)
    acc0 = None
    for j, dig in enumerate(digits):
        k0 = ksk.data[j, 0][sel_ext]
        k1 = ksk.data[j, 1][sel_ext]
        if ksk.mont:
            t0 = mont_mul(dig, k0, q_ext, qinv_ext)
            t1 = mont_mul(dig, k1, q_ext, qinv_ext)
        else:
            t0 = modmul(dig, k0, q_ext, qinv_ext, r2_ext)
            t1 = modmul(dig, k1, q_ext, qinv_ext, r2_ext)
        if acc0 is None:
            acc0, acc1 = t0, t1
        else:
            acc0 = modadd(acc0, t0, q_ext)
            acc1 = modadd(acc1, t1, q_ext)
    return acc0, acc1


def _mod_down(ctx: CkksContext, c_ext, nlimbs: int):
    """(c mod Q_l*P) → round(c/P) mod Q_l (approximate, integer-alpha
    centered correction). Accepts leading batch dims: c_ext[..., L+K, n]."""
    l = nlimbs
    k = ctx.params.num_p
    idx_q = ctx.q_idx(l)
    idx_p = ctx.p_idx()
    q, qinv, r2 = ctx.limb_consts(idx_q)
    pinv, pinv_sh = ctx.moddown_consts(l)
    part_p = ctx.intt(c_ext[..., l : l + k, :], idx_p)
    ext = ctx.extender(idx_p, tuple(idx_q)).extend(part_p)
    ext_eval = ctx.ntt(ext, idx_q)
    diff = modsub(c_ext[..., :l, :], ext_eval, q)
    return shoup_mul(diff, pinv, pinv_sh, q)


def keyswitch(ctx: CkksContext, c_eval, ksk: KeySwitchKey, nlimbs: int):
    return keyswitch_apply(ctx, keyswitch_core(ctx, c_eval, nlimbs), ksk, nlimbs)


# ---------------------------------------------------------------------------
# Key-switch key generation (from secret key, or from a public key for PRE)
# ---------------------------------------------------------------------------

def _ks_target_factors(ctx: CkksContext):
    """[P·Q̂_j]_{q_i} for all full-basis groups j and Q limbs i: u64[nd, L, 1]."""
    L = ctx.params.num_q
    QF = 1
    for i in range(L):
        QF *= ctx.moduli_qp[i]
    P = 1
    for p in ctx.params.p_moduli:
        P *= p
    out = np.zeros((len(ctx.digit_groups), L, 1), np.uint64)
    for j, g in enumerate(ctx.digit_groups):
        Dj = 1
        for i in g:
            Dj *= ctx.moduli_qp[i]
        f = (P * (QF // Dj))
        for i in range(L):
            out[j, i, 0] = f % ctx.moduli_qp[i]
    return out


def _ksk_digit_seed(a_seed: bytes, j: int) -> bytes:
    import hashlib

    return hashlib.blake2b(a_seed + j.to_bytes(2, "little"),
                           digest_size=16).digest()


def keyswitch_key_gen(
    ctx: CkksContext,
    target_eval_q,            # u64[L, n] eval-domain poly to be "keyed" (s², σ_g(s), s_A…)
    rng_key,
    sk_to: SecretKey | None = None,
    pk_to: PublicKey | None = None,
    a_seed: bytes | None = None,
) -> KeySwitchKey:
    """With ``a_seed`` (16 bytes, sk_to path only) each digit's uniform
    a_j expands from a per-digit PRF seed — serialize_ksk then ships only
    the b rows + the seed (~2x smaller self-generated rotation/relin/conj
    keys). PRE keys (pk_to) cannot be seeded: their rows are encryptions
    under the delegatee's public key, not uniform samples."""
    import jax

    if a_seed is not None and pk_to is not None:
        raise ValueError("a_seed applies to secret-key KSKs only (the pk "
                         "path's rows are not uniform)")

    n = ctx.params.n
    L = ctx.params.num_q
    K = ctx.params.num_p
    all_idx = tuple(range(L + K))
    q_all, qinv_all, r2_all = ctx.limb_consts(all_idx)
    factors = _ks_target_factors(ctx)
    nd = len(ctx.digit_groups)
    from .rlwe import _poly_mul, _signed_to_eval

    rows = []
    keys = jax.random.split(rng_key, nd)
    for j in range(nd):
        # message over QP: rows 0..L-1 carry [P·Q̂_j]_{q_i}·target_i ; P rows 0
        m_q = modmul(target_eval_q, factors[j], ctx.q_vec[:L], ctx.qinv_vec[:L], ctx.r2_vec[:L])
        m = jnp.concatenate([m_q, jnp.zeros((K, n), U64)], axis=0)
        if pk_to is not None:
            k_u, k_e0, k_e1 = jax.random.split(keys[j], 3)
            u = _signed_to_eval(ctx, sampling.ternary(k_u, n), all_idx)
            e0 = _signed_to_eval(ctx, sampling.discrete_gaussian(k_e0, n, ctx.params.sigma), all_idx)
            e1 = _signed_to_eval(ctx, sampling.discrete_gaussian(k_e1, n, ctx.params.sigma), all_idx)
            b = modadd(modadd(_poly_mul(ctx, pk_to.data[0], u, all_idx), e0, q_all), m, q_all)
            a = modadd(_poly_mul(ctx, pk_to.data[1], u, all_idx), e1, q_all)
        else:
            k_a, k_e = jax.random.split(keys[j])
            if a_seed is not None:
                from .rlwe import expand_a

                a = expand_a(ctx, _ksk_digit_seed(a_seed, j),
                             len(ctx.moduli_qp))
            else:
                a = ctx.ntt(sampling.uniform_rns(k_a, ctx.moduli_qp, n), all_idx)
            e = _signed_to_eval(ctx, sampling.discrete_gaussian(k_e, n, ctx.params.sigma), all_idx)
            b = modadd(
                modadd(modneg(_poly_mul(ctx, a, sk_to.s_eval, all_idx), q_all), e, q_all),
                m, q_all,
            )
        rows.append(jnp.stack([b, a]))
    return KeySwitchKey(data=jnp.stack(rows))


# ---------------------------------------------------------------------------
# ct×ct multiply + relinearization
# ---------------------------------------------------------------------------

def mult(ctx: CkksContext, ct1: Ciphertext, ct2: Ciphertext,
         relin_key: KeySwitchKey | None = None, rescale_after: bool = True) -> Ciphertext:
    d1, d2, l = _match_scales_any(ct1, ct2)
    idx = ctx.q_idx(l)
    q, qinv, r2 = ctx.limb_consts(idx)
    c0 = modmul(d1[0], d2[0], q, qinv, r2)
    c1 = modadd(modmul(d1[0], d2[1], q, qinv, r2), modmul(d1[1], d2[0], q, qinv, r2), q)
    c2 = modmul(d1[1], d2[1], q, qinv, r2)
    out = Ciphertext(data=jnp.stack([c0, c1, c2]), scale=ct1.scale * ct2.scale)
    if relin_key is not None:
        out = relinearize(ctx, out, relin_key)
    if rescale_after:
        out = rescale(ctx, out)
    return out


def _match_scales_any(ct1, ct2):
    """Operand check for ct×ct multiply: limbs truncate to the common level
    and scales must agree to FLEXIBLEAUTO drift (Δ²/q vs Δ differs by <0.1%
    for ~Δ-sized rescale primes).  A gross mismatch (e.g. a pre-rescale Δ²
    operand against a fresh Δ one) is a caller bug — the product's noise
    analysis no longer holds — so raise instead of silently producing a
    result whose recorded scale masks the imbalance."""
    l = min(ct1.nlimbs, ct2.nlimbs)
    if not np.isclose(ct1.scale, ct2.scale, rtol=0.05):
        raise ValueError(
            f"mult operand scale mismatch: {ct1.scale} vs {ct2.scale} "
            "(rescale/level-adjust the larger operand first)")
    return ct1.data[:, :l], ct2.data[:, :l], l


def relinearize(ctx: CkksContext, ct: Ciphertext, relin_key: KeySwitchKey) -> Ciphertext:
    if ct.num_components != 3:
        return ct
    l = ct.nlimbs
    q, _, _ = ctx.limb_consts(ctx.q_idx(l))
    d0, d1 = keyswitch(ctx, ct.data[2], relin_key, l)
    out = jnp.stack([modadd(ct.data[0], d0, q), modadd(ct.data[1], d1, q)])
    return Ciphertext(data=out, scale=ct.scale)


# ---------------------------------------------------------------------------
# Galois rotations (eval-domain permutations) + hoisting
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _galois_perm(n: int, g: int) -> np.ndarray:
    """perm with new_eval[k] = old_eval[perm[k]] for the automorphism X→X^g
    acting on bit-reversed eval bins (bin k ↔ root exponent 2·bitrev(k)+1)."""
    rev = bit_reverse_indices(n)
    inv_rev = np.argsort(rev)  # bitrev is an involution, but argsort is safe
    exps = 2 * rev + 1
    m = 2 * n
    target = (exps * g) % m
    perm = inv_rev[((target - 1) // 2)]
    return perm.astype(np.int32)


def rot_to_galois(r: int, n: int) -> int:
    """Slot rotation by r ↔ Galois element 5^r mod 2N (r may be negative)."""
    m = 2 * n
    return pow(5, r % (n // 2), m)


CONJ_GALOIS = -1  # sentinel: conjugation is g = 2N-1


def automorphism(ctx: CkksContext, data_eval, g: int):
    n = ctx.params.n
    if g == CONJ_GALOIS:
        g = 2 * n - 1
    return jnp.take(data_eval, ctx.galois_perm(g), axis=-1)


def rotate(ctx: CkksContext, ct: Ciphertext, r: int, rot_key: KeySwitchKey) -> Ciphertext:
    """Rotate packed slots left by r (EvalRotate equivalent)."""
    g = rot_to_galois(r, ctx.params.n)
    l = ct.nlimbs
    q, _, _ = ctx.limb_consts(ctx.q_idx(l))
    # ONE batched bin permutation for both components: one gather over the
    # whole stack instead of one per component
    both = automorphism(ctx, ct.data[:, :l], g)
    d0, d1 = keyswitch(ctx, both[1], rot_key, l)
    return Ciphertext(data=jnp.stack([modadd(both[0], d0, q), d1]), scale=ct.scale)


def _split_rows(rot, row_counts):
    out, off = [], 0
    for rc in row_counts:
        out.append(rot[off : off + rc])
        off += rc
    return out, rot[off:]


def rotate_hoisted(ctx: CkksContext, ct: Ciphertext, rotations: Sequence[int],
                   rot_keys: dict) -> list:
    """Hoisted rotations: decompose+extend ct.data[1] ONCE, then for each
    rotation apply the (cheap) automorphism to the extended digits and the
    c0 part. North-star requirement (BASELINE.json config 3).

    Valid because base extension is coefficient-wise and the automorphism is
    a (signed) permutation of coefficients — they commute; in the eval domain
    the automorphism is the same bin permutation on the digit polys.

    Each rotation's permutations (all digit rows + c0) run as ONE batched
    take instead of one gather per row.
    """
    l = ct.nlimbs
    q, _, _ = ctx.limb_consts(ctx.q_idx(l))
    digits = keyswitch_core(ctx, ct.data[1], l)
    row_counts = [d.shape[0] for d in digits]
    stacked = jnp.concatenate(list(digits) + [ct.data[0, :l]], axis=0)
    # The per-rotation tail (inner product + ModDown) runs once per
    # rotation; batching it over all rotations with one vmap is the
    # alternative, not measured on the GPU.
    out = []
    for r in rotations:
        g = rot_to_galois(r, ctx.params.n)
        dig_rot, c0p = _split_rows(automorphism(ctx, stacked, g), row_counts)
        d0, d1 = keyswitch_apply(ctx, dig_rot, rot_keys[r], l)
        out.append(Ciphertext(data=jnp.stack([modadd(c0p, d0, q), d1]), scale=ct.scale))
    return out


def rotate_sum_hoisted(ctx: CkksContext, ct: Ciphertext,
                       rotations: Sequence[int], rot_keys: dict) -> Ciphertext:
    """Σ_r rotate(ct, r) with DOUBLE hoisting (Halevi–Shoup): one shared
    decompose+extend AND one deferred ModDown. Per rotation only the
    batched bin permutation + the KSK inner product run; the R inner
    products accumulate in the extended basis (and the permuted c0 parts
    in Q), then a single ModDown finishes. Valid because ModDown is
    linear and commutes with the automorphism (both are coefficient-maps).

    This is the hoisting that matters for packed matrix-vector /
    baby-step-giant-step workloads, where the result IS a rotation sum
    (VERDICT r4 weak #3 / BASELINE.json config 3)."""
    l = ct.nlimbs
    idx_q = ctx.q_idx(l)
    sel_ext = np.asarray(tuple(idx_q) + tuple(ctx.p_idx()), dtype=np.int32)
    q_ext, _, _ = ctx.limb_consts(sel_ext)
    q, _, _ = ctx.limb_consts(idx_q)
    digits = keyswitch_core(ctx, ct.data[1], l)
    row_counts = [d.shape[0] for d in digits]
    stacked = jnp.concatenate(list(digits) + [ct.data[0, :l]], axis=0)
    acc0 = acc1 = c0_acc = None
    for r in rotations:
        g = rot_to_galois(r, ctx.params.n)
        dig_rot, c0p = _split_rows(automorphism(ctx, stacked, g), row_counts)
        t0, t1 = keyswitch_ip(ctx, dig_rot, rot_keys[r], l)
        if acc0 is None:
            acc0, acc1, c0_acc = t0, t1, c0p
        else:
            acc0 = modadd(acc0, t0, q_ext)
            acc1 = modadd(acc1, t1, q_ext)
            c0_acc = modadd(c0_acc, c0p, q)
    both = _mod_down(ctx, jnp.stack([acc0, acc1]), l)
    return Ciphertext(data=jnp.stack([modadd(c0_acc, both[0], q), both[1]]),
                      scale=ct.scale)


def conjugate(ctx: CkksContext, ct: Ciphertext, conj_key: KeySwitchKey) -> Ciphertext:
    n = ctx.params.n
    l = ct.nlimbs
    q, _, _ = ctx.limb_consts(ctx.q_idx(l))
    g = 2 * n - 1
    both = automorphism(ctx, ct.data[:, :l], g)   # one batched permutation
    d0, d1 = keyswitch(ctx, both[1], conj_key, l)
    return Ciphertext(data=jnp.stack([modadd(both[0], d0, q), d1]), scale=ct.scale)

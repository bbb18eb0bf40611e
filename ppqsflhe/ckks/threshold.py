"""Threshold multiparty CKKS — joint key generation and distributed
decryption as device collectives: additive N-of-N shares, plus t-of-N
decryption availability via Shamir sharing of the additive shares.

The reference enables OpenFHE's MULTIPARTY feature in its CryptoContext
(server/src/genCC.cpp:71-76, feature mask 63 = … | MULTIPARTY) but never
calls the multiparty API: its protocol routes everything through proxy
re-encryption instead (SURVEY.md §0). This module supplies the capability
the flag promises, mirroring OpenFHE's multiparty surface
(MultipartyKeyGen / MultipartyDecryptLead / MultipartyDecryptMain /
MultipartyDecryptFusion) with an additive N-of-N sharing:

- every party i samples a ternary share s_i; the joint secret is
  s = Σ_i s_i (never materialized anywhere);
- a public common random polynomial ``a`` (derived from a shared seed) is
  fixed first; party i publishes b_i = -a·s_i + e_i; the joint public key
  is (Σ_i b_i, a) — a valid RLWE key for s;
- decryption of ct = (c0, c1) is distributed: party i publishes the partial
  p_i = c1·s_i + e_i^flood (smudging noise for statistical security of the
  share); the fusion step computes c0 + Σ_i p_i and decodes.

Device mapping: both Σ_i reductions are ``jax.lax.psum`` over the
``client`` mesh axis (``joint_public_key_sharded`` /
``partial_decrypt_psum``) — the same collective pattern as the encrypted
FedAvg in :mod:`ppqsflhe.ckks.multikey`.

Protocol value for the FL pipeline: clients encrypt under the JOINT key, so
the server round is pure aggregation — the two PRE key switches of the
reference's ``changeCipherDomain`` disappear entirely; the price is one
round of partial decryptions at the end (see
``orchestration.Orchestrator(protocol="threshold")``).
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..core import sampling
from ..core.modarith import modadd, modmul, modneg
from .params import CkksContext
from .rlwe import _poly_mul, _signed_to_eval
from .types import Ciphertext, PublicKey, SecretKey

# Statistical-security smudging. ``smudging_bits`` is an ABSOLUTE flood
# magnitude: partial decryptions carry uniform noise in ±2^bits. By the
# smudging lemma (Asharov et al., EUROCRYPT'12), flooding a quantity whose
# noise is bounded by B with uniform ±F noise gives statistical distance
# ≤ B/F — so the achieved statistical security is
# (smudging_bits − decryption_noise_bits), NOT smudging_bits itself.
#
# The reference context pins ss=30 (SURVEY.md §2.3). At its parameters
# (N=2^14, σ=3.19) the decryption noise of a fresh/aggregated ciphertext is
# bounded by ≈2^13 (decryption_noise_bits), so the default 2^30 flood yields
# ≈17 bits of statistical distance. Achieving the FULL ss=30 requires
# flood ≈ 2^(30+13) = 2^43 > Δ=2^40, which erases the payload at the
# reference modulus chain — the same reason OpenFHE's NOISE_FLOODING_MULTIPARTY
# mode adds extra towers to Q before flooding. Callers with a larger Δ (or an
# extra tower) can pass ``smudging_bits=flood_bits_for_ss(ctx, ss)`` to get a
# derived flood that honestly meets a target ss; the precision cost is
# ≈ √(N/2)·2^(bits)/Δ absolute per slot (docs/SECURITY.md).
DEFAULT_SMUDGING_BITS = 30


def decryption_noise_bits(ctx: CkksContext) -> int:
    """Conservative high-probability bound (bits) on the decryption noise
    |c0 + c1·s − Δm| of a fresh pk-encryption at these parameters: three
    terms (u·e_pk, e0, s·e1), each a sum of N ternary×Gaussian products of
    std σ√(2N/3), bounded at 6 standard deviations. FedAvg aggregation
    (Σct)·(1/N) keeps the noise at this order, so the bound also covers the
    aggregate the FL pipeline threshold-decrypts."""
    import math

    n = ctx.params.n
    sigma = ctx.params.sigma
    per_term = 6.0 * sigma * math.sqrt(2.0 * n / 3.0)
    return max(1, math.ceil(math.log2(3.0 * per_term)))


def flood_bits_for_ss(ctx: CkksContext, ss: int,
                      noise_bits: int | None = None) -> int:
    """Flood magnitude (bits) that achieves ``ss`` bits of statistical
    distance for partial decryptions: decryption-noise bound + ss (smudging
    lemma: distance ≤ B/F = 2^noise_bits / 2^(noise_bits+ss) = 2^-ss)."""
    if noise_bits is None:
        noise_bits = decryption_noise_bits(ctx)
    return noise_bits + ss


def smudging_noise(key, n: int, bits: int) -> jnp.ndarray:
    """Uniform flooding noise in [-2^bits, 2^bits] (int64 lanes)."""
    return sampling.uniform_signed(key, n, bits)


def common_random_poly(ctx: CkksContext, seed: int) -> jax.Array:
    """The CRS polynomial ``a``: uniform over the full QP basis, eval domain.
    Deterministic in ``seed`` so every party derives the identical ``a``."""
    all_idx = tuple(range(len(ctx.moduli_qp)))
    key = jax.random.PRNGKey(seed & 0x7FFFFFFFFFFFFFFF)
    return ctx.ntt(sampling.uniform_rns(key, ctx.moduli_qp, ctx.params.n), all_idx)


def partial_keygen(ctx: CkksContext, a: jax.Array, rng_key) -> tuple[SecretKey, jax.Array]:
    """Party i's round-1 message: (secret share s_i, public share
    b_i = -a·s_i + e_i over QP, eval domain)."""
    n = ctx.params.n
    all_idx = tuple(range(len(ctx.moduli_qp)))
    k_s, k_e = jax.random.split(rng_key)
    s_int = sampling.ternary(k_s, n)
    s_eval = _signed_to_eval(ctx, s_int, all_idx)
    e = _signed_to_eval(ctx, sampling.discrete_gaussian(k_e, n, ctx.params.sigma), all_idx)
    q = ctx.q_vec
    b_i = modadd(modneg(_poly_mul(ctx, a, s_eval, all_idx), q), e, q)
    return SecretKey(s_eval=s_eval, s_int=np.asarray(s_int, np.int8)), b_i


def joint_public_key(ctx: CkksContext, a: jax.Array, b_shares: Sequence[jax.Array]) -> PublicKey:
    """Combine public shares: pk = (Σ b_i mod q, a). Host/driver-side
    reduction (N small); the mesh variant is joint_public_key_sharded."""
    q = ctx.q_vec
    b = b_shares[0]
    for bi in b_shares[1:]:
        b = modadd(b, bi, q)
    return PublicKey(data=jnp.stack([b, a]))


def partial_decrypt(ctx: CkksContext, sk_share: SecretKey, ct: Ciphertext,
                    rng_key, smudging_bits: int = DEFAULT_SMUDGING_BITS,
                    lead: bool = False) -> jax.Array:
    """Party i's decryption share p_i = c1·s_i + e_i^flood (eval domain,
    active limbs). ``lead=True`` folds in c0 (OpenFHE's
    MultipartyDecryptLead vs …Main split) so fusion is a plain Σ.

    Only 2-component ciphertexts are decryptable this way (relinearize
    before distributing — s² shares would need pairwise interaction)."""
    if ct.num_components != 2:
        raise ValueError("threshold decryption requires a 2-component ciphertext")
    l = ct.nlimbs
    idx = ctx.q_idx(l)
    q, _, _ = ctx.limb_consts(idx)
    e = _signed_to_eval(ctx, smudging_noise(rng_key, ctx.params.n, smudging_bits), idx)
    p = modadd(_poly_mul(ctx, ct.data[1], sk_share.s_eval[:l], idx), e, q)
    if lead:
        p = modadd(p, ct.data[0], q)
    return p


def fuse_partial_decryptions(ctx: CkksContext, ct: Ciphertext,
                             partials: Sequence[jax.Array],
                             include_c0: bool = True) -> jax.Array:
    """MultipartyDecryptFusion: coefficient residues of the plaintext
    polynomial = iNTT(c0 + Σ p_i). Set include_c0=False when one partial was
    produced with lead=True."""
    l = ct.nlimbs
    idx = ctx.q_idx(l)
    q, _, _ = ctx.limb_consts(idx)
    acc = ct.data[0] if include_c0 else None
    for p in partials:
        acc = p if acc is None else modadd(acc, p, q)
    return ctx.intt(acc, idx)


def threshold_decrypt(ctx: CkksContext, ct: Ciphertext,
                      sk_shares: Sequence[SecretKey], rng_key, encoder,
                      num: int | None = None,
                      smudging_bits: int = DEFAULT_SMUDGING_BITS):
    """Reference-free convenience: run all parties' partial decryptions and
    fuse (for tests / single-host simulation of the N-party protocol)."""
    from .rlwe import decode_coeffs

    keys = jax.random.split(rng_key, len(sk_shares))
    partials = [
        partial_decrypt(ctx, sk, ct, k, smudging_bits)
        for sk, k in zip(sk_shares, keys)
    ]
    coeffs = fuse_partial_decryptions(ctx, ct, partials)
    return decode_coeffs(ctx, coeffs, ct, encoder, num)


# ---------------------------------------------------------------------------
# t-of-N threshold decryption (Shamir over the additive shares)
# ---------------------------------------------------------------------------
#
# Key generation stays the N-of-N protocol above (all parties contribute
# s = Σ s_i). Availability becomes t-of-N by Shamir-sharing each party's
# ADDITIVE share: party i samples a degree-(t−1) polynomial
# f_i(x) = s_i + Σ_m c_{i,m}·x^m with uniform ring-element coefficients and
# sends f_i(j) to party j; party j keeps σ_j = Σ_i f_i(j) = F(j) where
# F(0) = s. Any subset T, |T| = t, reconstructs inside the decryption:
# Σ_{j∈T} λ_j^T·σ_j = F(0) = s with the Lagrange-at-zero scalars
# λ_j^T = Π_{j'∈T, j'≠j} j'·(j'−j)^{-1}. Shamir shares are EXACT field
# elements (coefficient-wise over each RNS prime), so no extra noise enters
# the ciphertext: the fusion still decrypts c0 + c1·s + Σ smudging.
#
# FL value: client dropouts no longer block the final decryption — any t of
# the N clients finish the round (the orchestrator's min_clients semantics
# extended to the threshold protocol).


def shamir_share_secret(ctx: CkksContext, sk_share: SecretKey,
                        n_parties: int, t: int, rng_key):
    """Party i's outgoing Shamir shares of its additive secret share:
    u64[n_parties, L+K, N] — row j-1 goes to party j (x-coordinate j).
    Shares are eval-domain residue vectors (sharing is linear with scalar
    coefficients, so it commutes with the NTT)."""
    if not (1 <= t <= n_parties):
        raise ValueError(f"need 1 <= t <= N, got t={t}, N={n_parties}")
    all_idx = tuple(range(len(ctx.moduli_qp)))
    q, qinv, r2 = ctx.limb_consts(all_idx)
    n = ctx.params.n
    coeffs = []
    for m in range(t - 1):
        coeffs.append(ctx.ntt(sampling.uniform_rns(
            jax.random.fold_in(rng_key, m), ctx.moduli_qp, n), all_idx))
    rows = []
    for j in range(1, n_parties + 1):
        acc = sk_share.s_eval
        for m, c in enumerate(coeffs, start=1):
            jm = _const_residues(ctx, pow(j, m))
            acc = modadd(acc, modmul(c, jm, q, qinv, r2), q)
        rows.append(acc)
    return jnp.stack(rows)


def _const_residues(ctx: CkksContext, v: int):
    """Integer constant → (L+K, 1) residue column."""
    return jnp.asarray(np.array(
        [[v % m] for m in ctx.moduli_qp], np.uint64))


def aggregate_received_shares(ctx: CkksContext, incoming) -> jax.Array:
    """σ_j = Σ_i f_i(j): sum the shares party j received from every party.
    ``incoming``: u64[n_parties, L+K, N]."""
    q = ctx.q_vec
    acc = incoming[0]
    for i in range(1, incoming.shape[0]):
        acc = modadd(acc, incoming[i], q)
    return acc


def lagrange_at_zero(ctx: CkksContext, party_set: Sequence[int], j: int):
    """λ_j^T = Π_{j'∈T, j'≠j} j'·(j'−j)^{-1} as (L+K, 1) residues."""
    from ..core import primes as _p

    out = []
    for m in ctx.moduli_qp:
        lam = 1
        for jp in party_set:
            if jp == j:
                continue
            lam = lam * jp % m
            lam = lam * _p.mod_inverse((jp - j) % m, m) % m
        out.append([lam])
    return jnp.asarray(np.array(out, np.uint64))


def partial_decrypt_t(ctx: CkksContext, sigma_j, ct: Ciphertext,
                      party_set: Sequence[int], j: int, rng_key,
                      smudging_bits: int = DEFAULT_SMUDGING_BITS,
                      lead: bool = False) -> jax.Array:
    """Party j's t-of-N decryption share for the participating set T:
    p_j = c1·(λ_j^T·σ_j) + e_flood (+ c0 when lead). Fusing the t shares
    with :func:`fuse_partial_decryptions` recovers the plaintext."""
    if ct.num_components != 2:
        raise ValueError("threshold decryption requires a 2-component ciphertext")
    if j not in party_set:
        raise ValueError(f"party {j} not in the participating set {party_set}")
    l = ct.nlimbs
    idx = ctx.q_idx(l)
    q, qinv, r2 = ctx.limb_consts(idx)
    lam = lagrange_at_zero(ctx, party_set, j)[np.asarray(idx)]
    s_scaled = modmul(sigma_j[:l], lam, q, qinv, r2)
    e = _signed_to_eval(ctx, smudging_noise(rng_key, ctx.params.n, smudging_bits), idx)
    p = modadd(_poly_mul(ctx, ct.data[1], s_scaled, idx), e, q)
    if lead:
        p = modadd(p, ct.data[0], q)
    return p


def threshold_decrypt_t(ctx: CkksContext, ct: Ciphertext, sigmas: dict,
                        party_set: Sequence[int], rng_key, encoder,
                        num: int | None = None,
                        smudging_bits: int = DEFAULT_SMUDGING_BITS):
    """Convenience: any t parties (``party_set``, 1-based ids) decrypt using
    their aggregated Shamir shares ``sigmas[j]`` (single-host simulation of
    the t-of-N protocol for tests / local deployments)."""
    from .rlwe import decode_coeffs

    keys = jax.random.split(rng_key, len(party_set))
    partials = [
        partial_decrypt_t(ctx, sigmas[j], ct, party_set, j, k, smudging_bits)
        for j, k in zip(party_set, keys)
    ]
    coeffs = fuse_partial_decryptions(ctx, ct, partials)
    return decode_coeffs(ctx, coeffs, ct, encoder, num)


# ---------------------------------------------------------------------------
# Mesh-sharded variants (client axis collectives)
# ---------------------------------------------------------------------------

def _psum_mod(x, q, axis_name: str):
    """Modular psum (shared shape with multikey._psum_mod): raw u64 psum of
    < 16 shards of residues < 2^60 cannot wrap; fold back into [0, q)."""
    s = jax.lax.psum(x, axis_name)
    for shift in (3, 2, 1, 0):
        step = q * jnp.uint64(1 << shift)
        s = jnp.where(s >= step, s - step, s)
    return s


def joint_public_key_sharded(ctx: CkksContext, a: jax.Array, b_local,
                             mesh, axis: str = "client") -> PublicKey:
    """psum the local b_i shares over the client mesh axis → replicated pk.
    ``b_local``: (clients_local, L+K, N) per-shard stack of public shares."""
    from jax.sharding import PartitionSpec as P

    q = ctx.q_vec

    def shard_fn(local):
        acc = local[0]
        for i in range(1, local.shape[0]):
            s = acc + local[i]
            acc = jnp.where(s >= q, s - q, s)
        return _psum_mod(acc, q, axis)

    b = jax.jit(jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(axis, None, None),), out_specs=P(None, None),
    ))(b_local)
    return PublicKey(data=jnp.stack([b, a]))


def partial_decrypt_psum(ctx: CkksContext, ct: Ciphertext, s_eval_local,
                         rng_local, mesh, axis: str = "client",
                         smudging_bits: int = DEFAULT_SMUDGING_BITS):
    """All parties' partial decryptions + fusion as ONE collective: each
    shard computes Σ_{local i} c1·s_i + e_i, one modular psum over the
    client axis, then iNTT. Returns plaintext coefficient residues.

    ``s_eval_local``: (clients_local, L+K, N) secret-share stack per shard;
    ``rng_local``: (clients_local, 2) uint32 PRNG keys per shard."""
    from jax.sharding import PartitionSpec as P

    l = ct.nlimbs
    idx = ctx.q_idx(l)
    q, _, _ = ctx.limb_consts(idx)
    c1 = ct.data[1]

    def shard_fn(s_stack, keys):
        acc = None
        for i in range(s_stack.shape[0]):
            e = _signed_to_eval(
                ctx, smudging_noise(keys[i], ctx.params.n, smudging_bits), idx)
            p = modadd(_poly_mul(ctx, c1, s_stack[i, :l], idx), e, q)
            acc = p if acc is None else modadd(acc, p, q)
        return _psum_mod(acc, q, axis)

    psum_p = jax.jit(jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(axis, None, None), P(axis, None)), out_specs=P(None, None),
    ))(s_eval_local, rng_local)
    acc = modadd(ct.data[0], psum_p, q)
    return ctx.intt(acc, idx)

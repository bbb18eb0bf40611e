"""RLWE key generation, encryption, decryption.

Replaces OpenFHE's ``cc->KeyGen()`` / ``cc->Encrypt()`` / ``cc->Decrypt()``
(reference call sites: client/src/keyGen.cpp:33,
client/src/encryptModelWeights.cpp:83, client/src/decryptModelWeights.cpp:81).

Keys live over the full QP basis (Q = ciphertext chain, P = key-switch
special primes) so that proxy re-encryption key generation — which encrypts
under the *delegatee's public key* in the QP basis (INDCPA PRE, SURVEY.md
§2.2) — needs no secret-dependent lifting. Fresh ciphertexts use only the Q
part. Everything is in the evaluation (NTT) domain at rest, matching the
reference's serialized `f=0` format (SURVEY.md §2.3).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core import sampling
from ..core.modarith import modadd, modsub, modmul, modneg
from .params import CkksContext
from .types import Ciphertext, Plaintext, PublicKey, SecretKey


def _poly_mul(ctx: CkksContext, a, b, idx):
    q, qinv, r2 = ctx.limb_consts(idx)
    return modmul(a, b, q, qinv, r2)


def _signed_to_eval(ctx: CkksContext, v_int, idx):
    """Small signed int32[N] → eval-domain residues over limbs `idx`."""
    moduli = [ctx.moduli_qp[i] for i in idx]
    coeff = sampling.signed_to_rns(v_int, moduli)
    return ctx.ntt(coeff, idx)


def keygen(ctx: CkksContext, rng_key,
           a_seed: bytes | None = None) -> tuple[SecretKey, PublicKey]:
    """Ternary secret, pk = (b, a) with b = -a*s + e over QP. With
    ``a_seed`` (16 bytes), a = expand_a(seed) — the serialized public key
    then ships only b + the seed (~2x smaller pubkey wire)."""
    n = ctx.params.n
    all_idx = tuple(range(len(ctx.moduli_qp)))
    k_s, k_a, k_e = jax.random.split(rng_key, 3)
    s_int = sampling.ternary(k_s, n)
    s_eval = _signed_to_eval(ctx, s_int, all_idx)
    if a_seed is not None:
        a = expand_a(ctx, a_seed, len(ctx.moduli_qp))
    else:
        a = ctx.ntt(sampling.uniform_rns(k_a, ctx.moduli_qp, n), all_idx)
    e = _signed_to_eval(ctx, sampling.discrete_gaussian(k_e, n, ctx.params.sigma), all_idx)
    q = ctx.q_vec
    b = modadd(modneg(_poly_mul(ctx, a, s_eval, all_idx), q), e, q)
    sk = SecretKey(s_eval=s_eval, s_int=s_int.astype(jnp.int8))
    pk = PublicKey(data=jnp.stack([b, a]))
    return sk, pk


def encrypt(ctx: CkksContext, pk: PublicKey, pt: Plaintext, rng_key) -> Ciphertext:
    """ct = (b*u + e0 + m, a*u + e1) over the plaintext's active Q limbs."""
    n = ctx.params.n
    l = pt.nlimbs
    idx = ctx.q_idx(l)
    q, _, _ = ctx.limb_consts(idx)
    k_u, k_e0, k_e1 = jax.random.split(rng_key, 3)
    u = _signed_to_eval(ctx, sampling.ternary(k_u, n), idx)
    e0 = _signed_to_eval(ctx, sampling.discrete_gaussian(k_e0, n, ctx.params.sigma), idx)
    e1 = _signed_to_eval(ctx, sampling.discrete_gaussian(k_e1, n, ctx.params.sigma), idx)
    b = pk.data[0, :l]
    a = pk.data[1, :l]
    c0 = modadd(modadd(_poly_mul(ctx, b, u, idx), e0, q), pt.data, q)
    c1 = modadd(_poly_mul(ctx, a, u, idx), e1, q)
    return Ciphertext(data=jnp.stack([c0, c1]), scale=pt.scale)


def expand_a(ctx: CkksContext, seed: bytes, nlimbs: int):
    """Deterministic uniform eval-domain poly over the first ``nlimbs`` Q
    limbs from a 16-byte PRF seed (Philox 128-bit key — host-side numpy, so
    the expansion is bit-identical on every backend/platform forever).

    This is the seed-expansion primitive behind the compact wire format
    (VERDICT r3 #6): a fresh secret-key ciphertext's c1 IS uniform, so the
    wire ships the 16-byte seed instead of l·N·8 bytes."""
    return expand_a_batch(ctx, [seed], nlimbs)[0]


def _expand_coeff(ctx: CkksContext, seed: bytes, nlimbs: int) -> np.ndarray:
    if len(seed) != 16:
        raise ValueError("expand_a seed must be 16 bytes")
    rng = np.random.Generator(np.random.Philox(
        key=np.frombuffer(seed, dtype=np.uint64)))
    return np.stack([
        rng.integers(0, int(ctx.moduli_qp[i]), ctx.params.n, dtype=np.uint64)
        for i in ctx.q_idx(nlimbs)
    ])


def expand_a_batch(ctx: CkksContext, seeds, nlimbs: int):
    """Expand many seeds with ONE jitted transform call (cached per level
    on the context): an EAGER ntt dispatches op-by-op, and per-ct calls
    additionally pay one dispatch each."""
    idx = ctx.q_idx(nlimbs)
    coeff = np.stack([_expand_coeff(ctx, sd, nlimbs) for sd in seeds])
    cache = getattr(ctx, "_expand_a_jit", None)
    if cache is None:
        cache = ctx._expand_a_jit = {}
    f = cache.get(nlimbs)
    if f is None:
        f = cache[nlimbs] = jax.jit(lambda c: ctx.ntt(c, idx))
    return f(jnp.asarray(coeff))


def encrypt_sk(ctx: CkksContext, sk: SecretKey, pt: Plaintext, rng_key,
               a_seed: bytes) -> Ciphertext:
    """Symmetric (secret-key) encryption with a seed-expanded mask:
    ct = (-a·s + e + m, a) with a = expand_a(a_seed). Decrypts identically
    to pk-encryption (c0 + c1·s = m + e) and all homomorphic/PRE ops apply
    unchanged; the wire can drop c1 entirely (serialize v3). Noise is
    LOWER than pk-encryption (one error term instead of e0 + u·e1)."""
    l = pt.nlimbs
    idx = ctx.q_idx(l)
    q, _, _ = ctx.limb_consts(idx)
    a = expand_a(ctx, a_seed, l)
    e = _signed_to_eval(ctx, sampling.discrete_gaussian(rng_key, ctx.params.n,
                                                        ctx.params.sigma), idx)
    s = sk.s_eval[:l]
    c0 = modadd(modadd(modneg(_poly_mul(ctx, a, s, idx), q), e, q), pt.data, q)
    return Ciphertext(data=jnp.stack([c0, a]), scale=pt.scale)


def encrypt_zero(ctx: CkksContext, pk: PublicKey, nlimbs: int, rng_key,
                 flood_bits: int = 0):
    """Fresh pk-encryption of zero over the first ``nlimbs`` Q limbs, with
    optional uniform flooding noise of magnitude 2^flood_bits added to the
    c0 component. This is the re-randomizer for HRA-secure proxy
    re-encryption (INDCCA PREMode): ct' = keyswitch(ct) + Enc_pk(0) makes
    the output statistically independent of the input ciphertext's
    randomness. Returns raw (2, nlimbs, n) eval-domain data."""
    n = ctx.params.n
    idx = ctx.q_idx(nlimbs)
    q, _, _ = ctx.limb_consts(idx)
    k_u, k_e0, k_e1, k_f = jax.random.split(rng_key, 4)
    u = _signed_to_eval(ctx, sampling.ternary(k_u, n), idx)
    e0 = _signed_to_eval(ctx, sampling.discrete_gaussian(k_e0, n, ctx.params.sigma), idx)
    e1 = _signed_to_eval(ctx, sampling.discrete_gaussian(k_e1, n, ctx.params.sigma), idx)
    b = pk.data[0, :nlimbs]
    a = pk.data[1, :nlimbs]
    c0 = modadd(_poly_mul(ctx, b, u, idx), e0, q)
    c1 = modadd(_poly_mul(ctx, a, u, idx), e1, q)
    if flood_bits > 0:
        f = _signed_to_eval(ctx, sampling.uniform_signed(k_f, n, flood_bits), idx)
        c0 = modadd(c0, f, q)
    return jnp.stack([c0, c1])


def decrypt_to_coeffs(ctx: CkksContext, s_eval, ct: Ciphertext):
    """⟨ct, (1, s, s², …)⟩ then iNTT → coefficient-domain residues u64[l, N].

    ``s_eval`` is the full-basis secret eval stack (sk.s_eval) or a
    SecretKey (convenience)."""
    if isinstance(s_eval, SecretKey):
        s_eval = s_eval.s_eval
    l = ct.nlimbs
    idx = ctx.q_idx(l)
    q, _, _ = ctx.limb_consts(idx)
    s = s_eval[:l]
    acc = ct.data[0]
    s_pow = s
    for k in range(1, ct.num_components):
        acc = modadd(acc, _poly_mul(ctx, ct.data[k], s_pow, idx), q)
        if k + 1 < ct.num_components:
            s_pow = _poly_mul(ctx, s_pow, s, idx)
    return ctx.intt(acc, idx)


def decode_coeffs(ctx: CkksContext, coeffs, ct: Ciphertext, encoder,
                  num: int | None = None, exact: bool = False):
    """Coefficient residues → centered integers → slot values (host).

    Fast path: rescaling always drops the *highest* limb, so limb 0 is the
    60-bit first modulus q0 at every level; any valid message polynomial has
    |coeff| ≈ Δ·|z| ≪ q0/2, so the centered limb-0 residue IS the integer
    coefficient — an O(N) int64 centering instead of big-int CRT. ``exact``
    forces the full CRT compose (for tests / adversarial inputs).
    """
    coeffs = np.asarray(jax.device_get(coeffs))
    l = ct.nlimbs
    moduli = [ctx.moduli_qp[i] for i in range(l)]
    if exact and l > 1:
        from ..core.rns import compose_centered

        centered = compose_centered(coeffs, moduli).astype(np.float64)
    else:
        q0 = moduli[0]
        r = coeffs[0]
        centered = np.where(
            r > np.uint64(q0 // 2),
            (r - np.uint64(q0)).view(np.int64) if r.dtype == np.uint64 else r - q0,
            r.view(np.int64) if r.dtype == np.uint64 else r,
        ).astype(np.float64)
    z = encoder.decode(centered, ct.scale, num)
    return z.real


def decrypt(ctx: CkksContext, sk: SecretKey, ct: Ciphertext, encoder, num: int | None = None):
    """Full decrypt → decode to real slot values (host, f64/big-int)."""
    coeffs = decrypt_to_coeffs(ctx, sk.s_eval, ct)
    return decode_coeffs(ctx, coeffs, ct, encoder, num)

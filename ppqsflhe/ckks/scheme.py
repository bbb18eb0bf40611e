"""High-level CKKS facade — the OpenFHE ``CryptoContext<DCRTPoly>``
equivalent (reference API surface: SURVEY.md §1 L2 row).

One object bundles params + NTT tables + encoder and exposes the full
user-facing API: MakeCKKSPackedPlaintext → ``make_plaintext``, KeyGen,
Encrypt/Decrypt, EvalAdd/EvalMult/EvalRotate, ReKeyGen/ReEncrypt, plus
context serialization hooks (ckks.serialize).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from . import eval as ev
from . import rlwe
from .encoding import Encoder
from .params import CkksContext, CkksParams
from .types import Ciphertext, EvalKey, KeySwitchKey, Plaintext, PublicKey, SecretKey


class CkksScheme:
    def __init__(self, params: CkksParams):
        self.params = params
        self.ctx = CkksContext(params)
        self.encoder = Encoder(params.n, params.slots or params.n // 2)
        self._jit_cache: dict = {}

    def _jit(self, key, make_fn):
        """Per-instance jitted-op cache: each (op, static-config) compiles one
        fused XLA graph, reused across all calls/shapes-compatible ciphertexts.
        Keeps the op count per call at 1 launch instead of hundreds of eager
        dispatches, and amortizes XLA compiles."""
        if key not in self._jit_cache:
            self._jit_cache[key] = jax.jit(make_fn())
        return self._jit_cache[key]

    # -- encoding -----------------------------------------------------------

    def make_plaintext(self, values, nlimbs: int | None = None,
                       scale: float | None = None) -> Plaintext:
        """Real vector → eval-domain plaintext over the first `nlimbs` Q limbs
        (MakeCKKSPackedPlaintext, encryptModelWeights.cpp:82). Under
        FLEXIBLEAUTOEXT, fresh full-level plaintexts encode at Δ·q_ext."""
        l = nlimbs or self.params.num_q
        if scale is None:
            scale = self.params.scale
            if self.params.flexible_ext and l == self.params.num_q:
                scale *= float(self.params.q_moduli[-1])
        coeffs = self.encoder.encode(values, scale)
        moduli = [self.ctx.moduli_qp[i] for i in range(l)]
        rns = jnp.asarray(self.encoder.to_rns(coeffs, moduli))
        return Plaintext(data=self.ctx.ntt(rns, self.ctx.q_idx(l)), scale=scale)

    def decode(self, coeffs_centered, scale: float, num: int | None = None):
        return self.encoder.decode(coeffs_centered, scale, num).real

    # -- keys ---------------------------------------------------------------

    def keygen(self, rng_key,
               a_seed: bytes | None = None) -> tuple[SecretKey, PublicKey]:
        if a_seed is not None:
            return rlwe.keygen(self.ctx, rng_key, a_seed)
        return self._jit("keygen", lambda: lambda k: rlwe.keygen(self.ctx, k))(rng_key)

    def relin_key_gen(self, sk: SecretKey, rng_key) -> KeySwitchKey:
        L = self.params.num_q

        def mk():
            def f(sk_, k):
                s = sk_.s_eval[:L]
                s2 = rlwe._poly_mul(self.ctx, s, s, tuple(range(L)))
                return ev.keyswitch_key_gen(self.ctx, s2, k, sk_to=sk_)
            return f
        return self._jit("relin_key_gen", mk)(sk, rng_key)

    def rotation_key_gen(self, sk: SecretKey, rotations, rng_key) -> dict:
        """Keys for slot rotations (EvalRotateKeyGen)."""
        L = self.params.num_q
        keys = jax.random.split(rng_key, max(len(rotations), 1))
        out = {}
        for r, k in zip(rotations, keys):
            g = ev.rot_to_galois(r, self.params.n)

            def mk(g=g):
                def f(sk_, k_):
                    s_rot = ev.automorphism(self.ctx, sk_.s_eval[:L], g)
                    return ev.keyswitch_key_gen(self.ctx, s_rot, k_, sk_to=sk_)
                return f
            out[r] = self._jit(("rot_key_gen", g), mk)(sk, k)
        return out

    def conjugation_key_gen(self, sk: SecretKey, rng_key) -> KeySwitchKey:
        L = self.params.num_q
        g = 2 * self.params.n - 1

        def mk():
            def f(sk_, k_):
                s_conj = ev.automorphism(self.ctx, sk_.s_eval[:L], g)
                return ev.keyswitch_key_gen(self.ctx, s_conj, k_, sk_to=sk_)
            return f
        return self._jit("conj_key_gen", mk)(sk, rng_key)

    def rekey_gen(self, sk_from: SecretKey, pk_to: PublicKey, rng_key) -> KeySwitchKey:
        """Proxy re-encryption key A→B from A's secret and B's *public* key
        (INDCPA PRE — cc->ReKeyGen, client/src/REkeyGen.cpp:52)."""
        L = self.params.num_q

        def mk():
            def f(s_eval, k_, pk_):
                return ev.keyswitch_key_gen(self.ctx, s_eval[:L], k_, pk_to=pk_)
            return f
        return self._jit("rekey_gen", mk)(sk_from.s_eval, rng_key, pk_to)

    # -- encrypt / decrypt --------------------------------------------------

    def encrypt(self, pk: PublicKey, pt: Plaintext, rng_key) -> Ciphertext:
        return self._jit(
            "encrypt", lambda: lambda p, t, k: rlwe.encrypt(self.ctx, p, t, k)
        )(pk, pt, rng_key)

    def encrypt_values(self, pk: PublicKey, values, rng_key,
                       nlimbs: int | None = None) -> Ciphertext:
        return self.encrypt(pk, self.make_plaintext(values, nlimbs), rng_key)

    def decrypt(self, sk: SecretKey, ct: Ciphertext, num: int | None = None):
        coeffs = self._jit(
            "decrypt_core",
            lambda: lambda s, c: rlwe.decrypt_to_coeffs(self.ctx, s, c),
        )(sk.s_eval, ct)
        return rlwe.decode_coeffs(self.ctx, coeffs, ct, self.encoder, num)

    def _maybe_drop_ext(self, ct):
        """FLEXIBLEAUTOEXT: drop the extension limb before any mult."""
        if self.params.flexible_ext and ct.nlimbs == self.params.num_q:
            return self.rescale(ct)
        return ct

    # -- homomorphic ops ----------------------------------------------------

    def add(self, ct1, ct2):
        return self._jit("add", lambda: lambda a, b: ev.add(self.ctx, a, b))(ct1, ct2)

    def sub(self, ct1, ct2):
        return self._jit("sub", lambda: lambda a, b: ev.sub(self.ctx, a, b))(ct1, ct2)

    def add_plain(self, ct, pt):
        return self._jit("add_plain", lambda: lambda a, p: ev.add_plain(self.ctx, a, p))(ct, pt)

    def mult_plain(self, ct, pt, rescale_after=True):
        ct = self._maybe_drop_ext(ct)

        def mk():
            def f(a, p):
                out = ev.mult_plain(self.ctx, a, p)
                return ev.rescale(self.ctx, out) if rescale_after else out
            return f
        return self._jit(("mult_plain", rescale_after), mk)(ct, pt)

    def mult_scalar(self, ct, c: float, rescale_after=True):
        ct = self._maybe_drop_ext(ct)
        return self._jit(
            ("mult_scalar", float(c), rescale_after),
            lambda: lambda a: ev.mult_scalar(self.ctx, a, c, rescale_after),
        )(ct)

    def mult(self, ct1, ct2, relin_key, rescale_after=True):
        ct1 = self._maybe_drop_ext(ct1)
        ct2 = self._maybe_drop_ext(ct2)
        return self._jit(
            ("mult", rescale_after),
            lambda: lambda a, b, rk: ev.mult(self.ctx, a, b, rk, rescale_after),
        )(ct1, ct2, relin_key)

    def rescale(self, ct):
        return self._jit("rescale", lambda: lambda a: ev.rescale(self.ctx, a))(ct)

    def rotate(self, ct, r: int, rot_keys):
        key = rot_keys[r] if isinstance(rot_keys, dict) else rot_keys
        return self._jit(
            ("rotate", r), lambda: lambda a, k: ev.rotate(self.ctx, a, r, k)
        )(ct, key)

    def rotate_hoisted(self, ct, rotations, rot_keys):
        return ev.rotate_hoisted(self.ctx, ct, rotations, rot_keys)

    def rotate_sum_hoisted(self, ct, rotations, rot_keys):
        """Σ_r rotate(ct, r) with double hoisting (one shared
        decompose+extend AND one deferred ModDown — ev.rotate_sum_hoisted);
        the hoisting that matters for packed matvec/BSGS workloads."""
        return ev.rotate_sum_hoisted(self.ctx, ct, rotations, rot_keys)

    def conjugate(self, ct, conj_key):
        return self._jit(
            "conjugate", lambda: lambda a, k: ev.conjugate(self.ctx, a, k)
        )(ct, conj_key)

    # -- PRE ----------------------------------------------------------------

    def re_encrypt(self, ct: Ciphertext, rekey: KeySwitchKey,
                   pk_to: PublicKey | None = None, rng_key=None) -> Ciphertext:
        """changeCipherDomain: move ct from key A's domain to key B's
        (cc->ReEncrypt, server/src/changeCipherDomain.cpp:74).

        INDCPA PREMode (the reference's configured mode): one key switch.
        INDCCA PREMode: additionally re-randomize with a fresh encryption of
        zero under the TARGET public key + flooding noise (pre_flood_bits),
        mirroring OpenFHE's ReEncrypt(ct, evalKey, publicKey) HRA overload —
        ``pk_to`` and ``rng_key`` become required."""
        from ..core.modarith import modadd

        indcca = self.params.pre_mode == "INDCCA"
        if indcca and (pk_to is None or rng_key is None):
            raise ValueError(
                "PREMode INDCCA requires the target public key and an rng key "
                "for re-encryption re-randomization")

        def mk():
            def f(c, rk, pk=None, k=None):
                l = c.nlimbs
                q, _, _ = self.ctx.limb_consts(self.ctx.q_idx(l))
                d0, d1 = ev.keyswitch(self.ctx, c.data[1], rk, l)
                out = jnp.stack([modadd(c.data[0], d0, q), d1])
                if indcca:
                    z = rlwe.encrypt_zero(self.ctx, pk, l, k,
                                          flood_bits=self.params.pre_flood_bits)
                    out = modadd(out, z, q)
                return Ciphertext(data=out, scale=c.scale)
            return f
        if indcca:
            return self._jit(("re_encrypt", "INDCCA"), mk)(ct, rekey, pk_to, rng_key)
        return self._jit("re_encrypt", mk)(ct, rekey)

    # -- inner product (packed weight vectors, BASELINE.json config 3) ------

    def inner_product(self, ct1: Ciphertext, ct2: Ciphertext,
                      relin_key: KeySwitchKey, rot_keys: dict) -> Ciphertext:
        """⟨v1, v2⟩ replicated in every slot: elementwise mult then
        log2(slots) hoisted rotate-and-add tree."""
        prod = self.mult(ct1, ct2, relin_key)
        r = 1
        slots = self.encoder.slots
        while r < slots:
            prod = self.add(prod, self.rotate(prod, r, rot_keys))
            r *= 2
        return prod

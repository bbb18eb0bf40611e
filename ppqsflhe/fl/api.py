"""Federated-learning workload layer — the reference's 7 CLI binaries as
Python APIs with identical file contracts (SURVEY.md §2.1, §2.4).

| reference binary             | here                          |
|------------------------------|-------------------------------|
| server/src/genCC.cpp         | gen_cc                        |
| client/src/keyGen.cpp        | key_gen                       |
| client/src/REkeyGen.cpp      | rekey_gen                     |
| client/src/encryptModelWeights.cpp  | encrypt_weights        |
| client/src/decryptModelWeights.cpp  | decrypt_weights        |
| server/src/changeCipherDomain.cpp   | change_cipher_domain   |
| server/src/aggregateEncryptedWeights.cpp | aggregate_encrypted_weights |

Weights JSON schema (produced by train/, consumed here — c_trainAndUpdate.py
:175-190): {"weights_summary": [{layer, shape, mean, std_dev, values[]}…]}.
Encrypted schema: mean/std_dev → Base64 ciphertext strings, values → list of
Base64 ciphertext-chunk strings (encryptModelWeights.cpp:63-119).

Batching: every per-file operation stacks its ciphertexts into one
(B, k, L, N) array and runs a single vmapped device computation — the
reference's flat 27-iteration loops (encryptModelWeights.cpp:100,
changeCipherDomain.cpp:99) become one batched kernel launch.
"""

from __future__ import annotations

import functools
import json
import math
import os
from typing import Dict, List, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..ckks import serialize as ser
from ..ckks.params import CkksParams, canonical_ntt_impl
from ..ckks.scheme import CkksScheme
from ..ckks.types import Ciphertext

OPTIMIZER_PREFIX = "optimizer"  # layers skipped at encrypt time (encryptModelWeights.cpp:71-74)


@functools.lru_cache(maxsize=4)
def _scheme_for(params: CkksParams) -> CkksScheme:
    return CkksScheme(params)


def load_scheme(cc_path: str) -> CkksScheme:
    return _scheme_for(ser.load_params(cc_path))


def _rng(seed: int | None):
    """PRNG key for key material / encryption randomness.

    With no explicit seed, all long-term secrets (sk, rekeys, threshold
    shares) derive from 128 bits of OS entropy wrapped into a 128-bit-state
    'rbg' key — a 64-bit threefry PRNGKey would cap the effective secret-key
    space at 2^64 regardless of parameter security. Explicit seeds keep the
    deterministic threefry path for tests/reproducibility."""
    if seed is not None:
        return jax.random.PRNGKey(seed)
    data = np.frombuffer(os.urandom(16), dtype=np.uint32)
    return jax.random.wrap_key_data(jnp.asarray(data), impl="rbg")


# ---------------------------------------------------------------------------
# Context / key generation
# ---------------------------------------------------------------------------

def gen_cc(config: Dict | str, cc_out: str) -> CkksParams:
    """Build + serialize the shared context. Accepts the reference's
    config_cc.json schema: {multiplicative_depth, scaling_mod_size,
    batch_size, PREMode} (genCC.cpp:46-66), plus optional ring_dim /
    first_mod_size / dnum / use_reference_chain extensions."""
    if isinstance(config, str):
        with open(config) as f:
            config = json.load(f)

    def pick(*names, default=None):
        for nm in names:
            if nm in config:
                return config[nm]
        return default

    depth = int(pick("multiplicative_depth", "mult_depth", default=2))
    scale_bits = int(pick("scaling_mod_size", "scale_bits", default=40))
    batch = int(pick("batch_size", "slots", default=0))
    n = int(pick("ring_dim", default=1 << 14))
    pre_mode = pick("PREMode", "pre_mode", default="INDCPA")
    # the reference's tested parameter bounds (test/server/src/test_s_CC.cpp:43-65)
    if not 1 <= depth <= 20:
        raise ValueError(f"multiplicative_depth {depth} outside [1, 20]")
    if not 30 < scale_bits < 100:
        raise ValueError(f"scaling_mod_size {scale_bits} outside (30, 100)")
    if batch and not 0 < batch <= n // 2:
        raise ValueError(f"batch_size {batch} outside (0, ring_dim/2={n // 2}]")
    # the reference's tested mode set (test/server/src/test_s_CC.cpp:
    # PREMode ∈ {INDCPA, INDCCA}); the committed config uses INDCPA
    if pre_mode not in ("INDCPA", "INDCCA"):
        raise ValueError(f"unsupported PREMode {pre_mode} (INDCPA or INDCCA)")
    if pick("use_reference_chain", default=False):
        import dataclasses

        params = dataclasses.replace(
            CkksParams.reference(slots=batch or 8192),
            ntt_backend=pick("ntt_backend", default="radix2"),
            ntt_impl=canonical_ntt_impl(pick("ntt_impl", default="xla")))
    else:
        params = CkksParams.generate(
            n=n, mult_depth=depth, scale_bits=scale_bits,
            first_mod_bits=int(pick("first_mod_size", default=60)),
            dnum=int(pick("dnum", default=2)), slots=batch,
            ntt_backend=pick("ntt_backend", default="radix2"),
            ntt_impl=canonical_ntt_impl(pick("ntt_impl", default="xla")),
        )
    if pre_mode != params.pre_mode:
        import dataclasses

        params = dataclasses.replace(params, pre_mode=pre_mode)
    ser.save_params(params, cc_out)
    return params


def _derived_seed(seed: int | None, tag: str) -> bytes:
    """16-byte PRF seed: from OS entropy, or deterministically from an
    explicit test seed."""
    if seed is None:
        return os.urandom(16)
    import hashlib

    return hashlib.blake2b(f"{tag}:{seed}".encode(), digest_size=16).digest()


def key_gen(cc_path: str, pub_out: str, priv_out: str, seed: int | None = None) -> None:
    """cc->KeyGen() + serialize both halves (keyGen.cpp:33,41-48). The
    public key's uniform ``a`` half is seed-expanded (rlwe.expand_a) so the
    pubkey wire ships b + a 16-byte seed — ~2x smaller."""
    sch = load_scheme(cc_path)
    a_seed = _derived_seed(seed, "pk_a")
    sk, pk = sch.keygen(_rng(seed), a_seed=a_seed)
    ser.save_json(ser.serialize_public_key(pk, a_seed=a_seed), pub_out)
    ser.save_json(ser.serialize_secret_key(sk), priv_out)


def rekey_gen(cc_path: str, own_priv: str, peer_pub: str, rekey_out: str,
              seed: int | None = None) -> None:
    """cc->ReKeyGen(own_sk, peer_pk) (REkeyGen.cpp:52): PRE key own→peer."""
    sch = load_scheme(cc_path)
    sk = ser.deserialize_secret_key(ser.load_json(own_priv), sch.ctx)
    pk = ser.deserialize_public_key(ser.load_json(peer_pub), sch.ctx)
    rk = sch.rekey_gen(sk, pk, _rng(seed))
    ser.save_json(ser.serialize_ksk(rk), rekey_out)


# ---------------------------------------------------------------------------
# Weight encryption / decryption
# ---------------------------------------------------------------------------

def encrypt_weights(cc_path: str, pub_path: str, weights_in: str, enc_out: str,
                    seed: int | None = None, wire: str = "native",
                    container: str = "json") -> Dict:
    """Per layer: encrypt scalar mean/std_dev and batch-chunked values
    (encryptModelWeights.cpp:67-119). All chunks of all layers are encrypted
    as ONE batched device op. ``wire='openfhe'`` emits the ciphertext fields
    as Base64(cereal-BINARY) — byte-compatible with the reference's wire.

    Compact wire (VERDICT r3 #6): pass the client's SECRET key file as
    ``pub_path`` (auto-detected) — each chunk is then sk-encrypted with a
    seed-expanded uniform c1 and the native wire ships only c0 + a 16-byte
    seed per ciphertext (~2x smaller uploads; decrypt/PRE/aggregate are
    unchanged).

    ``container='bin'`` (r5, VERDICT r4 weak #4) writes the PQWD raw-binary
    document instead of JSON+Base64 (~25% smaller again; both transports
    move opaque files). Downstream tools auto-detect and PRESERVE the
    container, so one flag here makes the whole round binary."""
    sch = load_scheme(cc_path)
    keydoc = ser.load_json(pub_path)
    sk_mode = keydoc.get("type") == "ckks_secret_key"
    # The seeded compact ct (c0 + 16-byte seed) is native-wire only; with
    # wire='openfhe' a secret key still works — sk-encrypt, emit both
    # components dense on the reference's cereal wire (ADVICE r4: this used
    # to die in deserialize_public_key with an opaque KeyError).
    seeded = sk_mode and wire != "openfhe"
    if sk_mode:
        sk_enc = ser.deserialize_secret_key(keydoc, sch.ctx)
    else:
        pk = ser.deserialize_public_key(keydoc, sch.ctx)
    with open(weights_in) as f:
        weights = json.load(f)

    batch = sch.encoder.slots
    plain_vecs: List[np.ndarray] = []   # every plaintext vector to encrypt
    layout = []                          # (layer_meta, n_value_chunks)
    for entry in weights["weights_summary"]:
        if entry["layer"].startswith(OPTIMIZER_PREFIX):
            continue
        values = np.asarray(entry["values"], dtype=np.float64)
        plain_vecs.append(np.array([entry["mean"]], np.float64))
        plain_vecs.append(np.array([entry["std_dev"]], np.float64))
        nchunks = max(1, math.ceil(values.size / batch))
        for c in range(nchunks):
            chunk = values[c * batch : (c + 1) * batch]
            plain_vecs.append(chunk)  # zero-padding happens in encode
        layout.append((entry, nchunks))

    if sk_mode:
        seeds = [_derived_seed(seed if seed is None else seed + 7919 * j,
                               f"ct_a:{j}") for j in range(len(plain_vecs))]
        cts = _encrypt_batch_sk(sch, sk_enc, plain_vecs, _rng(seed), seeds)
        if not seeded:                      # openfhe wire: ship dense c0,c1
            seeds = [None] * len(plain_vecs)
    else:
        seeds = [None] * len(plain_vecs)
        cts = _encrypt_batch(sch, pk, plain_vecs, _rng(seed))
    out = {"weights_summary": []}
    i = 0
    for entry, nchunks in layout:
        rec = {
            "layer": entry["layer"],
            "shape": entry["shape"],
            "mean": _ct_to_wire(cts[i], sch, wire, seeds[i]),
            "std_dev": _ct_to_wire(cts[i + 1], sch, wire, seeds[i + 1]),
            "values": [_ct_to_wire(cts[i + 2 + c], sch, wire, seeds[i + 2 + c])
                       for c in range(nchunks)],
        }
        i += 2 + nchunks
        out["weights_summary"].append(rec)
    ser.save_enc_doc(out, enc_out,
                     binary=(container == "bin" and wire != "openfhe"))
    return out


def _jit_ntt(sch: CkksScheme, nlimbs: int):
    """Jitted batched forward transform (cached per level on the scheme's
    context): eager ctx.ntt dispatches op-by-op, one launch per op."""
    cache = getattr(sch.ctx, "_api_ntt_jit", None)
    if cache is None:
        cache = sch.ctx._api_ntt_jit = {}
    f = cache.get(nlimbs)
    if f is None:
        idx = sch.ctx.q_idx(nlimbs)
        f = cache[nlimbs] = jax.jit(lambda c: sch.ctx.ntt(c, idx))
    return f


def _encrypt_batch(sch: CkksScheme, pk, vecs: Sequence[np.ndarray], rng) -> List[Ciphertext]:
    """Encode on host, then one batched encrypt on device."""
    from ..ckks import rlwe

    l = sch.params.num_q
    idx = sch.ctx.q_idx(l)
    moduli = [sch.ctx.moduli_qp[i] for i in idx]
    scale = sch.params.scale
    rns = sch.encoder.to_rns_batch(
        sch.encoder.encode_batch(vecs, scale), moduli)  # (B, l, n)
    pts_eval = _jit_ntt(sch, l)(jnp.asarray(rns))

    def enc_one(pt_data, key):
        from ..ckks.types import Plaintext

        return rlwe.encrypt(sch.ctx, pk, Plaintext(pt_data, scale=scale), key).data

    keys = jax.random.split(rng, len(vecs))
    data = jax.jit(jax.vmap(enc_one))(pts_eval, keys)  # (B, 2, l, n)
    data = np.asarray(jax.device_get(data))
    # keep the cts HOST-resident: they feed straight into serialization —
    # wrapping in jnp.asarray would copy the payload back to the device
    # only for the pack step to fetch it again
    return [Ciphertext(d, scale=scale) for d in data]


def _encrypt_batch_sk(sch: CkksScheme, sk, vecs: Sequence[np.ndarray], rng,
                      seeds: Sequence[bytes]) -> List[Ciphertext]:
    """Seeded symmetric encryption, batched: ONE host expansion of all the
    uniform c1 polys (Philox) + one batched c0 computation on device."""
    from ..ckks import rlwe

    l = sch.params.num_q
    idx = sch.ctx.q_idx(l)
    moduli = [sch.ctx.moduli_qp[i] for i in idx]
    scale = sch.params.scale
    rns = sch.encoder.to_rns_batch(
        sch.encoder.encode_batch(vecs, scale), moduli)  # (B, l, n)
    pts_eval = _jit_ntt(sch, l)(jnp.asarray(rns))
    a_stack = jnp.stack([rlwe.expand_a(sch.ctx, sd, l) for sd in seeds])

    def enc_one(pt_data, a, key):
        from ..ckks.types import Plaintext

        return _encrypt_sk_with_a(sch.ctx, sk, Plaintext(pt_data, scale=scale),
                                  key, a)

    keys = jax.random.split(rng, len(vecs))
    data = jax.jit(jax.vmap(enc_one))(pts_eval, a_stack, keys)
    data = np.asarray(jax.device_get(data))
    # keep the cts HOST-resident (see _encrypt_batch)
    return [Ciphertext(d, scale=scale) for d in data]


def _encrypt_sk_with_a(ctx, sk, pt, rng_key, a):
    """rlwe.encrypt_sk body with the mask poly precomputed (vmap-friendly)."""
    from ..ckks.rlwe import _poly_mul, _signed_to_eval
    from ..core import sampling
    from ..core.modarith import modadd, modneg

    l = pt.nlimbs
    idx = ctx.q_idx(l)
    q, _, _ = ctx.limb_consts(idx)
    e = _signed_to_eval(ctx, sampling.discrete_gaussian(rng_key, ctx.params.n,
                                                        ctx.params.sigma), idx)
    s = sk.s_eval[:l]
    c0 = modadd(modadd(modneg(_poly_mul(ctx, a, s, idx), q), e, q), pt.data, q)
    return jnp.stack([c0, a])


def decrypt_weights(cc_path: str, priv_path: str, enc_in: str, plain_out: str) -> Dict:
    """Inverse of encrypt_weights with pad-trim to prod(shape)
    (decryptModelWeights.cpp:97-118). All ciphertexts of a level decrypt
    as ONE batched device call (a per-ct loop pays one dispatch + one
    device-to-host copy each)."""
    from ..ckks.rlwe import decode_coeffs, decrypt_to_coeffs

    sch = load_scheme(cc_path)
    sk = ser.deserialize_secret_key(ser.load_json(priv_path), sch.ctx)
    enc = ser.load_enc_doc(enc_in)

    slots, cts = _load_all_cts(enc, sch)
    # batch decrypt-to-coeffs per (nlimbs, k) group, one jitted vmap each
    coeffs = [None] * len(cts)
    groups: Dict[tuple, List[int]] = {}
    for i, ct in enumerate(cts):
        groups.setdefault((ct.nlimbs, ct.num_components, float(ct.scale)),
                          []).append(i)
    for (l, k, _), idxs in groups.items():
        stack = jnp.stack([cts[i].data for i in idxs])
        # NOTE: the secret key is an ARGUMENT, not a closure capture — the
        # jitted fn is cached per (level, k) on the scheme and must serve
        # every client's key
        fn = sch._jit(("decrypt_batch", l, k), lambda: jax.vmap(
            lambda c, s: decrypt_to_coeffs(sch.ctx, s,
                                           Ciphertext(c, scale=1.0)),
            in_axes=(0, None)))
        batch = np.asarray(jax.device_get(fn(stack, sk.s_eval)))
        for i, co in zip(idxs, batch):
            coeffs[i] = co
    vals = {
        i: decode_coeffs(sch.ctx, coeffs[i], cts[i], sch.encoder)
        for i in range(len(cts))
    }

    out = {"weights_summary": []}
    by_entry: Dict[int, Dict] = {}
    for i, (entry, field, vi) in enumerate(slots):
        rec = by_entry.get(id(entry))
        if rec is None:
            rec = by_entry[id(entry)] = {
                "layer": entry["layer"], "shape": entry["shape"],
                "mean": 0.0, "std_dev": 0.0, "_vals": {}}
            out["weights_summary"].append(rec)
        if field == "values":
            rec["_vals"][vi] = vals[i]
        else:
            rec[field if field == "mean" else "std_dev"] = float(vals[i][0])
    for rec in out["weights_summary"]:
        size = int(np.prod(rec["shape"]))
        flat = np.concatenate([rec["_vals"][j]
                               for j in sorted(rec["_vals"])])[:size]
        rec["values"] = [float(x) for x in flat]
        del rec["_vals"]
    with open(plain_out, "w") as f:
        json.dump(out, f)
    return out


# ---------------------------------------------------------------------------
# Server-side: PRE + aggregation
# ---------------------------------------------------------------------------

# Device-resident rekey cache: a production server applies the SAME
# long-lived re-encryption key every round, but the file-contract API is
# called per round with a path. Cache the deserialized + Montgomery-form
# KSK on device, keyed by (path, mtime, size) — repeated rounds then skip
# both the host parse and the H2D upload + conversion pass.
_REKEY_CACHE: Dict[tuple, object] = {}


def _load_rekey_mont(sch: CkksScheme, rekey_path: str):
    from ..ckks import eval as ev

    st = os.stat(rekey_path)
    # Keyed on the scheme's (hashable) params, not id(sch): after
    # _scheme_for's lru_cache evicts a scheme, CPython can recycle its id —
    # a stale id key could then serve a Montgomery-form KSK built under a
    # different context (ADVICE r4). Identical params ⇒ identical context.
    key = (os.path.abspath(rekey_path), st.st_mtime_ns, st.st_size, sch.params)
    rk = _REKEY_CACHE.get(key)
    if rk is None:
        if len(_REKEY_CACHE) > 16:          # bound device memory
            _REKEY_CACHE.clear()
        rk = ev.ksk_to_mont(sch.ctx,
                            ser.deserialize_ksk(ser.load_json(rekey_path), sch.ctx))
        _REKEY_CACHE[key] = rk
    return rk


def _ct_to_wire(ct: Ciphertext, sch: CkksScheme, wire: str,
                a_seed: bytes | None = None) -> str:
    """'native' → PQTC blobs (v3 seeded when ``a_seed`` is given);
    'openfhe' → Base64(cereal-BINARY), the reference's exact ciphertext
    wire (encryptModelWeights.cpp:85-86)."""
    if wire == "openfhe":
        return ser.ciphertext_to_b64_openfhe(ct, sch.ctx)
    return ser.ciphertext_to_b64(ct, a_seed=a_seed)


def _ct_from_any(payload, ctx) -> Ciphertext:
    """One ciphertext from any wire payload: Base64 str or raw bytes
    (binary-container documents), PQTC v1/v2/v3 or OpenFHE cereal-BINARY."""
    import base64 as _b64

    raw = (payload if isinstance(payload, (bytes, bytearray))
           else _b64.b64decode(payload))
    return ser.ciphertext_from_bytes_any(raw, ctx)


def _load_all_cts(enc: Dict, sch: CkksScheme | None = None) -> tuple[list, list[Ciphertext]]:
    """Flatten an encrypted-weights document into (slots, ciphertexts).
    All wire formats are accepted (auto-detected per field). Seeded v3
    blobs are expanded in BATCHES — one jitted transform call per level
    group instead of one per ciphertext (27 dispatches → 1)."""
    import base64 as _b64

    ctx = sch.ctx if sch is not None else None
    slots, cts = [], []
    seeded = []                     # (out_index, c0, seed, scale, l)
    for entry in enc["weights_summary"]:
        fields = [(f, entry[f]) for f in ("mean", "std_dev")]
        fields += [("values", s) for s in entry["values"]]
        vi = 0
        for field, payload in fields:
            slots.append((entry, field, vi if field == "values" else None))
            if field == "values":
                vi += 1
            raw = (payload if isinstance(payload, (bytes, bytearray))
                   else _b64.b64decode(payload))
            parts = ser.ciphertext_seeded_parts(raw)
            if parts is not None and ctx is not None:
                c0, seed, scale = parts
                seeded.append((len(cts), c0, seed, scale, c0.shape[0]))
                cts.append(None)
            elif raw[:4] == ser.MAGIC:
                cts.append(ser.ciphertext_from_bytes(raw, ctx))
            else:                     # OpenFHE cereal-BINARY wire
                cts.append(ser.ciphertext_from_bytes_any(raw, ctx))
    if seeded:
        from ..ckks import rlwe

        by_l: Dict[int, list] = {}
        for rec in seeded:
            by_l.setdefault(rec[4], []).append(rec)
        for l, recs in by_l.items():
            a_all = np.asarray(jax.device_get(
                rlwe.expand_a_batch(ctx, [r[2] for r in recs], l)))
            for (pos, c0, _, scale, _), a in zip(recs, a_all):
                cts[pos] = Ciphertext(
                    data=jnp.asarray(np.stack([c0, a])), scale=scale)
    return slots, cts


def _store_all_cts(slots, cts: Sequence[Ciphertext],
                   sch: CkksScheme | None = None, wire: str = "native",
                   raw: bool = False) -> None:
    """``raw=True`` (binary-container destinations) stores raw PQTC bytes —
    skipping a Base64 encode that save_enc_doc would immediately decode."""
    for (entry, field, i), ct in zip(slots, cts):
        if wire != "native":
            b64 = _ct_to_wire(ct, sch, wire)
        elif raw:
            b64 = ser.ciphertext_to_bytes(ct)
        else:
            b64 = ser.ciphertext_to_b64(ct)
        if field == "values":
            entry["values"][i] = b64
        else:
            entry[field] = b64


def change_cipher_domain(cc_path: str, rekey_path: str, enc_in: str, enc_out: str,
                         pub_path: str | None = None,
                         seed: int | None = None,
                         drop_limbs: int = 0, wire: str = "native",
                         keep_limbs: int | None = None) -> Dict:
    """cc->ReEncrypt on every ciphertext field (changeCipherDomain.cpp:74,89,
    105) — executed as one batched key switch over all B ciphertexts.
    Under PREMode INDCCA ``pub_path`` (the TARGET domain's public key) is
    required: every output is re-randomized with Enc_pk(0) + flooding.

    ``drop_limbs`` applies LevelReduce (free top-limb truncation — an exact
    modulus switch) before the key switch: each dropped limb removes a large
    share of the switch's NTT work AND shrinks the output payload, at zero
    precision cost while message+noise ≪ Q_small (lazy level management;
    the reference keeps full level throughout). ``keep_limbs`` is the
    absolute form (reduce to exactly that many towers, whatever the input
    level) — the orchestrator's lazy downlink uses keep_limbs=1: a
    decrypt-only artifact needs just q0 = 2^60 ≫ Δ·m + noise."""
    sch = load_scheme(cc_path)
    from ..ckks import eval as ev

    # one Montgomery-form conversion of the (long-lived) rekey halves the
    # inner-product multiplies of every key switch below (ev.ksk_to_mont)
    rekey = _load_rekey_mont(sch, rekey_path)
    indcca = sch.params.pre_mode == "INDCCA"
    if indcca and pub_path is None:
        raise ValueError("PREMode INDCCA: changeCipherDomain needs the target "
                         "domain's public key (pub_path)")
    pk = (ser.deserialize_public_key(ser.load_json(pub_path), sch.ctx)
          if indcca else None)
    enc = ser.load_enc_doc(enc_in)
    slots, cts = _load_all_cts(enc, sch)
    stack = jnp.stack([ct.data for ct in cts])  # (B, 2, l, n)
    if keep_limbs is not None:
        if not 1 <= keep_limbs <= stack.shape[2]:
            raise ValueError(
                f"keep_limbs={keep_limbs} outside [1, {stack.shape[2]}]")
        drop_limbs = stack.shape[2] - keep_limbs
    if drop_limbs:
        if drop_limbs >= stack.shape[2]:
            raise ValueError(f"cannot drop {drop_limbs} of {stack.shape[2]} limbs")
        stack = stack[:, :, : stack.shape[2] - drop_limbs]
    scale = cts[0].scale

    if indcca:
        keys = jax.random.split(_rng(seed), len(cts))

        def re_enc_one(d, k):
            return sch.re_encrypt(Ciphertext(d, scale=scale), rekey,
                                  pk_to=pk, rng_key=k).data

        out_data = np.asarray(jax.device_get(
            jax.jit(jax.vmap(re_enc_one))(stack, keys)))
    else:
        def re_enc_one(d):
            return sch.re_encrypt(Ciphertext(d, scale=scale), rekey).data

        out_data = np.asarray(jax.device_get(jax.jit(jax.vmap(re_enc_one))(stack)))
    new_cts = [Ciphertext(d, scale=scale) for d in out_data]  # host-resident (see _encrypt_batch note)
    binary = ser.doc_is_binary(enc_in) and wire != "openfhe"
    _store_all_cts(slots, new_cts, sch, wire, raw=binary)
    ser.save_enc_doc(enc, enc_out, binary=binary)
    return enc


# ---------------------------------------------------------------------------
# Threshold multiparty protocol (MULTIPARTY feature — the reference enables
# the flag, genCC.cpp:71-76, but never implements it; see ckks/threshold.py)
# ---------------------------------------------------------------------------

def threshold_keygen(cc_path: str, crs_seed: int, priv_share_out: str,
                     pub_share_out: str, seed: int | None = None) -> None:
    """Party-side MultipartyKeyGen round 1: derive the CRS polynomial from
    ``crs_seed``, sample a secret share, write (secret share, public
    b-share). The secret share uses the standard secret-key format so
    existing tooling can inspect it."""
    from ..ckks import threshold as th

    sch = load_scheme(cc_path)
    a = th.common_random_poly(sch.ctx, crs_seed)
    sk_i, b_i = th.partial_keygen(sch.ctx, a, _rng(seed))
    ser.save_json(ser.serialize_secret_key(sk_i), priv_share_out)
    ser.save_json({
        "type": "ckks_public_share",
        "crs_seed": int(crs_seed),
        "shape": list(b_i.shape),
        "data": ser._arr_to_b64(b_i),
    }, pub_share_out)


def threshold_combine_pubkey(cc_path: str, crs_seed: int,
                             pub_share_paths: Sequence[str],
                             joint_pub_out: str) -> None:
    """Server-side combine: joint pk = (Σ b_i, a), written in the standard
    public-key format — ``encrypt_weights`` consumes it unchanged."""
    from ..ckks import threshold as th

    sch = load_scheme(cc_path)
    a = th.common_random_poly(sch.ctx, crs_seed)
    shares = []
    for p in pub_share_paths:
        d = ser.load_json(p)
        if int(d.get("crs_seed", crs_seed)) != int(crs_seed):
            raise ValueError(f"{p}: public share was generated for a "
                             "different CRS seed")
        shares.append(jnp.asarray(ser._b64_to_arr(d["data"], d["shape"])))
    pk = th.joint_public_key(sch.ctx, a, shares)
    ser.save_json(ser.serialize_public_key(pk), joint_pub_out)


def threshold_partial_decrypt(cc_path: str, priv_share_path: str, enc_in: str,
                              partial_out: str, seed: int | None = None,
                              smudging_bits: int | None = None) -> Dict:
    """Party-side MultipartyDecryptMain over a whole encrypted-weights
    document: one batched device op computes p_i = c1·s_i + e^flood for
    every ciphertext field."""
    from ..ckks import threshold as th

    sch = load_scheme(cc_path)
    sk = ser.deserialize_secret_key(ser.load_json(priv_share_path), sch.ctx)
    if smudging_bits is None:
        smudging_bits = th.DEFAULT_SMUDGING_BITS
    enc = ser.load_enc_doc(enc_in)
    slots, cts = _load_all_cts(enc, sch)
    stack = jnp.stack([ct.data for ct in cts])          # (B, 2, l, n)
    scale = cts[0].scale
    keys = jax.random.split(_rng(seed), len(cts))

    def part_one(d, k):
        return th.partial_decrypt(sch.ctx, sk, Ciphertext(d, scale=scale), k,
                                  smudging_bits=smudging_bits)

    parts = np.asarray(jax.device_get(jax.jit(jax.vmap(part_one))(stack, keys)))
    out = {"type": "ckks_partial_decryptions", "limbs": int(parts.shape[1]),
           "n": int(parts.shape[2]), "weights_summary": []}
    i = 0
    for entry in enc["weights_summary"]:
        rec = {"layer": entry["layer"], "shape": entry["shape"],
               "mean": ser._arr_to_b64(parts[i]),
               "std_dev": ser._arr_to_b64(parts[i + 1]),
               "values": [ser._arr_to_b64(parts[i + 2 + c])
                          for c in range(len(entry["values"]))]}
        i += 2 + len(entry["values"])
        out["weights_summary"].append(rec)
    with open(partial_out, "w") as f:
        json.dump(out, f)
    return out


def threshold_shamir_share(cc_path: str, priv_share_path: str, n_parties: int,
                           t: int, out_paths: Sequence[str],
                           seed: int | None = None) -> None:
    """Party-side t-of-N setup: Shamir-share this party's ADDITIVE secret
    share among all N parties (ckks/threshold.py t-of-N section) — writes
    one share file per recipient (out_paths[j-1] → party j)."""
    from ..ckks import threshold as th

    if len(out_paths) != n_parties:
        raise ValueError(f"need {n_parties} output paths, got {len(out_paths)}")
    sch = load_scheme(cc_path)
    sk = ser.deserialize_secret_key(ser.load_json(priv_share_path), sch.ctx)
    rows = np.asarray(th.shamir_share_secret(sch.ctx, sk, n_parties, t, _rng(seed)))
    for j, path in enumerate(out_paths, start=1):
        ser.save_json({
            "type": "ckks_shamir_share", "recipient": j,
            "n_parties": n_parties, "threshold": t,
            "shape": list(rows[j - 1].shape),
            "data": ser._arr_to_b64(rows[j - 1]),
        }, path)


def threshold_aggregate_shares(cc_path: str, incoming_paths: Sequence[str],
                               sigma_out: str) -> None:
    """Party j sums the Shamir shares it received from every party:
    σ_j = Σ_i f_i(j) (all files must target the same recipient)."""
    from ..ckks import threshold as th

    sch = load_scheme(cc_path)
    docs = [ser.load_json(p) for p in incoming_paths]
    recips = {int(d["recipient"]) for d in docs}
    if len(recips) != 1:
        raise ValueError(f"shares target different recipients: {sorted(recips)}")
    stack = jnp.stack([
        jnp.asarray(ser._b64_to_arr(d["data"], d["shape"])) for d in docs])
    sigma = th.aggregate_received_shares(sch.ctx, stack)
    d0 = docs[0]
    ser.save_json({
        "type": "ckks_sigma_share", "recipient": d0["recipient"],
        "n_parties": d0["n_parties"], "threshold": d0["threshold"],
        "shape": list(np.asarray(sigma).shape),
        "data": ser._arr_to_b64(np.asarray(sigma)),
    }, sigma_out)


def threshold_partial_decrypt_t(cc_path: str, sigma_path: str, enc_in: str,
                                partial_out: str, party_set: Sequence[int],
                                party_id: int, seed: int | None = None,
                                smudging_bits: int | None = None) -> Dict:
    """Party j's t-of-N decryption shares over a whole encrypted-weights
    document (λ_j^T·σ_j folded in); fuse the t partial documents with
    :func:`threshold_fuse_decrypt` unchanged."""
    from ..ckks import threshold as th

    sch = load_scheme(cc_path)
    d = ser.load_json(sigma_path)
    if int(d["recipient"]) != int(party_id):
        raise ValueError(f"sigma share belongs to party {d['recipient']}, "
                         f"not {party_id}")
    if len(party_set) != int(d["threshold"]):
        raise ValueError(f"participating set size {len(party_set)} != "
                         f"threshold t={d['threshold']}")
    sigma = jnp.asarray(ser._b64_to_arr(d["data"], d["shape"]))
    if smudging_bits is None:
        smudging_bits = th.DEFAULT_SMUDGING_BITS
    enc = ser.load_enc_doc(enc_in)
    slots, cts = _load_all_cts(enc, sch)
    stack = jnp.stack([ct.data for ct in cts])
    scale = cts[0].scale
    keys = jax.random.split(_rng(seed), len(cts))
    pset = tuple(int(x) for x in party_set)

    def part_one(dd, k):
        return th.partial_decrypt_t(sch.ctx, sigma, Ciphertext(dd, scale=scale),
                                    pset, int(party_id), k,
                                    smudging_bits=smudging_bits)

    parts = np.asarray(jax.device_get(jax.jit(jax.vmap(part_one))(stack, keys)))
    out = {"type": "ckks_partial_decryptions", "limbs": int(parts.shape[1]),
           "n": int(parts.shape[2]), "party_set": list(pset),
           "weights_summary": []}
    i = 0
    for entry in enc["weights_summary"]:
        rec = {"layer": entry["layer"], "shape": entry["shape"],
               "mean": ser._arr_to_b64(parts[i]),
               "std_dev": ser._arr_to_b64(parts[i + 1]),
               "values": [ser._arr_to_b64(parts[i + 2 + c])
                          for c in range(len(entry["values"]))]}
        i += 2 + len(entry["values"])
        out["weights_summary"].append(rec)
    with open(partial_out, "w") as f:
        json.dump(out, f)
    return out


def threshold_fuse_decrypt(cc_path: str, enc_in: str,
                           partial_paths: Sequence[str], plain_out: str) -> Dict:
    """MultipartyDecryptFusion over a document: plaintext coefficients =
    iNTT(c0 + Σ_i p_i) per ciphertext, then decode + pad-trim to ∏shape
    (same output contract as decrypt_weights)."""
    sch = load_scheme(cc_path)
    enc = ser.load_enc_doc(enc_in)
    part_docs = []
    for p in partial_paths:
        with open(p) as f:
            part_docs.append(json.load(f))

    slots, cts = _load_all_cts(enc, sch)
    scale = cts[0].scale
    l, n = cts[0].data.shape[1], cts[0].data.shape[2]
    stack = jnp.stack([ct.data for ct in cts])          # (B, 2, l, n)

    def flat_partials(doc):
        out = []
        for entry in doc["weights_summary"]:
            out.append(ser._b64_to_arr(entry["mean"], (l, n)))
            out.append(ser._b64_to_arr(entry["std_dev"], (l, n)))
            for s in entry["values"]:
                out.append(ser._b64_to_arr(s, (l, n)))
        return np.stack(out)

    parts = jnp.asarray(np.stack([flat_partials(d) for d in part_docs]))  # (P, B, l, n)

    def fuse_one(ct_data, p_stack):
        from ..ckks import threshold as th

        return th.fuse_partial_decryptions(
            sch.ctx, Ciphertext(ct_data, scale=scale), list(p_stack))

    coeffs = np.asarray(jax.device_get(
        jax.jit(jax.vmap(fuse_one, in_axes=(0, 1)))(stack, parts)))  # (B, l, n)

    from ..ckks import rlwe

    out = {"weights_summary": []}
    i = 0
    for entry in enc["weights_summary"]:
        def dec(j, num=None):
            return rlwe.decode_coeffs(
                sch.ctx, coeffs[j], Ciphertext(stack[j], scale=scale),
                sch.encoder, num)

        mean = float(dec(i, num=1)[0])
        std = float(dec(i + 1, num=1)[0])
        size = int(np.prod(entry["shape"]))
        vals = np.concatenate([dec(i + 2 + c) for c in range(len(entry["values"]))])[:size]
        i += 2 + len(entry["values"])
        out["weights_summary"].append({
            "layer": entry["layer"], "shape": entry["shape"],
            "mean": mean, "std_dev": std,
            "values": [float(x) for x in vals],
        })
    with open(plain_out, "w") as f:
        json.dump(out, f)
    return out


def aggregate_encrypted_weights(cc_path: str, enc_paths: Sequence[str], agg_out: str,
                                lazy: bool = False, wire: str = "native") -> Dict:
    """Homomorphic FedAvg over N clients' encrypted weights, all already in a
    common key domain: per layer matched by name AND shape
    (aggregateEncryptedWeights.cpp:71-72), ct_avg = (Σ ct_i)·(1/N)
    (generalizes the 2-client EvalAdd + EvalMult(·,0.5) at :82-83).

    ``lazy`` (lazy level management): when N is a power of
    two, ÷N is EXACT as pure scale metadata (1/N encoded at scale N is the
    constant 1), so the EvalMult+rescale disappears and one more limb is
    LevelReduce'd off the output — fewer NTTs and a smaller payload, no
    precision change. Non-power-of-two N falls back to the standard path."""
    sch = load_scheme(cc_path)
    docs = []
    for p in enc_paths:
        docs.append(ser.load_enc_doc(p))
    n_clients = len(docs)

    base = docs[0]
    # index the other docs by (layer, shape)
    def key_of(e):
        return (e["layer"], tuple(e["shape"]))

    maps = [{key_of(e): e for e in d["weights_summary"]} for d in docs[1:]]

    out = {"weights_summary": []}
    stack_groups: List[List[Ciphertext]] = []
    layout = []
    for entry in base["weights_summary"]:
        k = key_of(entry)
        if not all(k in m for m in maps):
            continue  # unmatched layers dropped, like the reference
        peers = [m[k] for m in maps]
        nv = min([len(entry["values"])] + [len(p["values"]) for p in peers])
        rec = {"layer": entry["layer"], "shape": entry["shape"]}
        for field in ("mean", "std_dev"):
            stack_groups.append(
                [_ct_from_any(entry[field], sch.ctx)]
                + [_ct_from_any(p[field], sch.ctx) for p in peers])
        for i in range(nv):
            stack_groups.append(
                [_ct_from_any(entry["values"][i], sch.ctx)]
                + [_ct_from_any(p["values"][i], sch.ctx) for p in peers])
        layout.append((rec, nv))

    if not stack_groups:
        raise ValueError(
            "no layers matched by name AND shape across all clients — "
            "federated averaging requires every client to train the same "
            "architecture (aggregateEncryptedWeights.cpp:71-72 semantics)")
    scale = stack_groups[0][0].scale
    # clients may arrive at different levels (lazy level management drops
    # limbs in change_cipher_domain): truncate every ct to the common
    # minimum — LevelReduce, exact
    lmin = min(ct.nlimbs for grp in stack_groups for ct in grp)
    big = jnp.stack([jnp.stack([ct.data[:, :lmin] for ct in grp])
                     for grp in stack_groups])
    # big: (B, n_clients, 2, l, n) → batched modular sum + single 1/N EvalMult

    free_div = lazy and (n_clients & (n_clients - 1)) == 0 and lmin > 1

    def agg_one(group):
        from ..ckks import eval as ev

        acc = Ciphertext(group[0], scale=scale)
        for c in range(1, n_clients):
            acc = ev.add(sch.ctx, acc, Ciphertext(group[c], scale=scale))
        if free_div:
            return acc.data[:, :-1]       # free ÷N (scale) + LevelReduce
        return ev.mult_scalar(sch.ctx, acc, 1.0 / n_clients).data

    out_scale = scale * n_clients if free_div else scale
    out_data = np.asarray(jax.device_get(jax.jit(jax.vmap(agg_one))(big)))
    agg_cts = [Ciphertext(d, scale=out_scale) for d in out_data]  # host-resident

    i = 0
    for rec, nv in layout:
        rec["mean"] = _ct_to_wire(agg_cts[i], sch, wire)
        rec["std_dev"] = _ct_to_wire(agg_cts[i + 1], sch, wire)
        rec["values"] = [_ct_to_wire(agg_cts[i + 2 + c], sch, wire)
                         for c in range(nv)]
        i += 2 + nv
        out["weights_summary"].append(rec)
    ser.save_enc_doc(out, agg_out,
                     binary=ser.doc_is_binary(enc_paths[0]) and wire != "openfhe")
    return out

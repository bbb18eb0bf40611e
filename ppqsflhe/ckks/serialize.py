"""Serialization of contexts, keys and ciphertexts.

Replaces OpenFHE/cereal ``Serial::{Serialize,Deserialize}`` (reference:
genCC.cpp:89, keyGen.cpp:41-48, encryptModelWeights.cpp:85-86 — CC/keys as
JSON, ciphertexts as BINARY wrapped in Base64). We keep the same *file
contract shape* (SURVEY.md §2.4): context + keys are JSON documents;
ciphertexts are little-endian binary blobs Base64-embedded in the encrypted
weights JSON. The binary format is a fixed 40-byte header + raw u64 residue
data — no polymorphic graph, so artifacts are ~6x smaller than cereal-JSON
(pubkey ~1.6 MB vs the reference's 12.6 MB, SURVEY.md §6).
"""

from __future__ import annotations

import base64
import json
import struct
from typing import Any, Dict

import jax
import jax.numpy as jnp
import numpy as np

from ..core.modarith import U64
from .params import CkksContext, CkksParams, canonical_ntt_impl
from .types import Ciphertext, KeySwitchKey, PublicKey, SecretKey

MAGIC = b"PQTC"  # ppqsflhe ciphertext
VERSION = 1


# -- params / context -------------------------------------------------------

def params_to_dict(p: CkksParams) -> Dict[str, Any]:
    return {
        "format": "ppqsflhe.ckks.v1",
        "ring_dim": p.n,
        "q_moduli": [str(q) for q in p.q_moduli],
        "p_moduli": [str(q) for q in p.p_moduli],
        "q_roots": [str(r) for r in p.q_roots] if p.q_roots else None,
        "p_roots": [str(r) for r in p.p_roots] if p.p_roots else None,
        "scale_bits": p.scale_bits,
        "dnum": p.dnum,
        "slots": p.slots,
        "sigma": p.sigma,
        "ntt_backend": p.ntt_backend,
        "ntt_impl": p.ntt_impl,
        "flexible_ext": p.flexible_ext,
        "pre_mode": p.pre_mode,
        "pre_flood_bits": p.pre_flood_bits,
    }


def params_from_dict(d: Dict[str, Any]) -> CkksParams:
    return CkksParams(
        n=d["ring_dim"],
        q_moduli=tuple(int(x) for x in d["q_moduli"]),
        p_moduli=tuple(int(x) for x in d["p_moduli"]),
        q_roots=tuple(int(x) for x in d["q_roots"]) if d.get("q_roots") else None,
        p_roots=tuple(int(x) for x in d["p_roots"]) if d.get("p_roots") else None,
        scale_bits=d["scale_bits"],
        dnum=d["dnum"],
        slots=d["slots"],
        sigma=d.get("sigma", 3.19),
        ntt_backend=d.get("ntt_backend", "radix2"),
        ntt_impl=canonical_ntt_impl(d.get("ntt_impl", "xla")),
        flexible_ext=d.get("flexible_ext", False),
        pre_mode=d.get("pre_mode", "INDCPA"),
        pre_flood_bits=d.get("pre_flood_bits", 30),
    )


def save_params(p: CkksParams, path: str) -> None:
    with open(path, "w") as f:
        json.dump(params_to_dict(p), f, indent=1)


def load_params(path: str) -> CkksParams:
    with open(path) as f:
        return params_from_dict(json.load(f))


# -- array blobs ------------------------------------------------------------

def _arr_to_b64(a) -> str:
    return base64.b64encode(np.asarray(a, dtype="<u8").tobytes()).decode()


def _b64_to_arr(s: str, shape) -> np.ndarray:
    return np.frombuffer(base64.b64decode(s), dtype="<u8").reshape(shape).copy()


# -- keys -------------------------------------------------------------------

def serialize_secret_key(sk: SecretKey) -> Dict[str, Any]:
    """Secret keys ship only the ternary coefficients (tiny); eval forms are
    re-derived from the context on load."""
    return {
        "type": "ckks_secret_key",
        "s_int": base64.b64encode(np.asarray(sk.s_int, np.int8).tobytes()).decode(),
    }


def deserialize_secret_key(d: Dict[str, Any], ctx: CkksContext) -> SecretKey:
    from ..core import sampling

    s_int = np.frombuffer(base64.b64decode(d["s_int"]), dtype=np.int8).copy()
    all_idx = tuple(range(len(ctx.moduli_qp)))
    coeff = sampling.signed_to_rns(jnp.asarray(s_int, jnp.int32), ctx.moduli_qp)
    s_eval = ctx.ntt(coeff, all_idx)
    return SecretKey(s_eval=s_eval, s_int=s_int)


def serialize_public_key(pk: PublicKey,
                         a_seed: bytes | None = None) -> Dict[str, Any]:
    """With ``a_seed`` (the seed passed to rlwe.keygen), only the b half
    travels — the a half is re-expanded on load (~2x smaller pubkey)."""
    if a_seed is not None:
        return {
            "type": "ckks_public_key",
            "shape": list(pk.data.shape),
            "b": _arr_to_b64(pk.data[0]),
            "a_seed": a_seed.hex(),
        }
    return {
        "type": "ckks_public_key",
        "shape": list(pk.data.shape),
        "data": _arr_to_b64(pk.data),
    }


def deserialize_public_key(d: Dict[str, Any],
                           ctx: CkksContext | None = None) -> PublicKey:
    if "a_seed" in d:
        if ctx is None:
            raise ValueError("seeded public key needs a context to "
                             "re-expand a — pass ctx")
        from .rlwe import expand_a

        shape = d["shape"]
        b = _b64_to_arr(d["b"], shape[1:])
        a = np.asarray(jax.device_get(
            expand_a(ctx, bytes.fromhex(d["a_seed"]), shape[1])))
        return PublicKey(data=jnp.asarray(np.stack([b, a]), U64))
    return PublicKey(data=jnp.asarray(_b64_to_arr(d["data"], d["shape"]), U64))


def serialize_ksk(k: KeySwitchKey,
                  a_seed: bytes | None = None) -> Dict[str, Any]:
    """With ``a_seed`` (the seed passed to eval.keyswitch_key_gen) only
    the b rows travel; the per-digit a rows re-expand on load (~2x
    smaller self-generated rotation/relin/conjugation keys)."""
    if a_seed is not None:
        return {
            "type": "ckks_keyswitch_key",
            "shape": list(k.data.shape),
            "b": _arr_to_b64(k.data[:, 0]),
            "a_seed": a_seed.hex(),
        }
    return {
        "type": "ckks_keyswitch_key",
        "shape": list(k.data.shape),
        "data": _arr_to_b64(k.data),
    }


def deserialize_ksk(d: Dict[str, Any],
                    ctx: CkksContext | None = None) -> KeySwitchKey:
    if "a_seed" in d:
        if ctx is None:
            raise ValueError("seeded keyswitch key needs a context to "
                             "re-expand its a rows — pass ctx")
        from .eval import _ksk_digit_seed
        from .rlwe import expand_a

        nd, _, LK, n = d["shape"]
        seed = bytes.fromhex(d["a_seed"])
        b = _b64_to_arr(d["b"], (nd, LK, n))
        a = np.stack([
            np.asarray(jax.device_get(expand_a(ctx, _ksk_digit_seed(seed, j),
                                               LK)))
            for j in range(nd)
        ])
        return KeySwitchKey(
            data=jnp.asarray(np.stack([b, a], axis=1), U64))
    return KeySwitchKey(data=jnp.asarray(_b64_to_arr(d["data"], d["shape"]), U64))


def save_json(obj: Dict[str, Any], path: str) -> None:
    with open(path, "w") as f:
        json.dump(obj, f)


def load_json(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


# -- ciphertexts (binary, Base64-wrapped by callers) ------------------------
#
# v1: raw little-endian u64 residues (8 B/coefficient/limb).
# v2 (default): per-limb minimal byte width — each limb's residues are < q_i,
# so limb i needs only ceil(bits(q_i)/8) bytes (reference chain: 8/5/5/3 B ≈
# 34% smaller than v1 before Base64). Readers accept both.
# v3 (seeded, VERDICT r3 #6): for fresh SECRET-key ciphertexts whose c1 is
# the seed-expanded uniform poly (rlwe.encrypt_sk), the wire ships only the
# packed c0 limbs + the 16-byte Philox seed — ~2x smaller again. Readers
# regenerate c1 = expand_a(seed) (needs a ctx).

def _pack_limb(a: np.ndarray, width: int) -> bytes:
    raw = np.ascontiguousarray(a.astype("<u8")).view(np.uint8).reshape(-1, 8)
    return raw[:, :width].tobytes()


def _unpack_limb(b: bytes, width: int, n: int) -> np.ndarray:
    if width == 8:
        return np.frombuffer(b, dtype="<u8", count=n).copy()
    raw = np.frombuffer(b, dtype=np.uint8, count=n * width).reshape(n, width)
    out = np.zeros((n, 8), np.uint8)
    out[:, :width] = raw
    return out.view("<u8")[:, 0].copy()


def ciphertext_to_bytes(ct: Ciphertext, version: int = 2,
                        a_seed: bytes | None = None) -> bytes:
    k, l, n = ct.data.shape
    data = np.asarray(ct.data)
    if version == 1:
        header = MAGIC + struct.pack("<IIIId", 1, k, l, n, float(ct.scale))
        return header + data.astype("<u8").tobytes()
    if a_seed is not None:
        # v3: the caller guarantees ct.data[1] == expand_a(a_seed, l)
        # (rlwe.encrypt_sk); only c0 travels.
        if k != 2 or len(a_seed) != 16:
            raise ValueError("seeded wire needs a 2-component ct + 16B seed")
        c0 = data[0]
        widths = bytes(
            max(1, (int(c0[i].max()).bit_length() + 7) // 8) if n else 8
            for i in range(l)
        )
        header = (MAGIC + struct.pack("<IIIId", 3, k, l, n, float(ct.scale))
                  + widths + a_seed)
        return header + b"".join(
            _pack_limb(c0[i].ravel(), widths[i]) for i in range(l))
    # per-limb widths from the actual residue magnitudes (power-of-2 safe:
    # max residue < q_i determines the needed bytes)
    widths = bytes(
        max(1, (int(data[:, i].max()).bit_length() + 7) // 8) if n else 8
        for i in range(l)
    )
    header = MAGIC + struct.pack("<IIIId", 2, k, l, n, float(ct.scale)) + widths
    parts = [header]
    for i in range(l):
        parts.append(_pack_limb(data[:, i].ravel(), widths[i]))
    return b"".join(parts)


def ciphertext_from_bytes(b: bytes, ctx: CkksContext | None = None) -> Ciphertext:
    if b[:4] != MAGIC:
        raise ValueError("bad ciphertext magic")
    ver, k, l, n, scale = struct.unpack("<IIIId", b[4:28])
    if ver == 1:
        data = np.frombuffer(b[28:], dtype="<u8").reshape(k, l, n).copy()
    elif ver == 2:
        widths = b[28 : 28 + l]
        data = np.zeros((k, l, n), np.uint64)
        off = 28 + l
        for i in range(l):
            w = widths[i]
            data[:, i] = _unpack_limb(b[off:], w, k * n).reshape(k, n)
            off += k * n * w
    elif ver == 3:
        if ctx is None:
            raise ValueError("seeded (v3) ciphertext needs a context to "
                             "re-expand c1 — pass ctx")
        from .rlwe import expand_a

        widths = b[28 : 28 + l]
        seed = b[28 + l : 28 + l + 16]
        data = np.zeros((k, l, n), np.uint64)
        off = 28 + l + 16
        for i in range(l):
            w = widths[i]
            data[0, i] = _unpack_limb(b[off:], w, n)
            off += n * w
        data[1] = np.asarray(jax.device_get(expand_a(ctx, seed, l)))
    else:
        raise ValueError(f"unsupported ciphertext version {ver}")
    return Ciphertext(data=jnp.asarray(data, U64), scale=scale)


def ciphertext_to_b64(ct: Ciphertext, a_seed: bytes | None = None) -> str:
    return base64.b64encode(ciphertext_to_bytes(ct, a_seed=a_seed)).decode()


def ciphertext_from_b64(s: str, ctx: CkksContext | None = None) -> Ciphertext:
    return ciphertext_from_bytes(base64.b64decode(s), ctx)


# -- encrypted-weights documents (JSON or raw-binary container) -------------
#
# The reference ships encrypted weights as JSON with Base64(BINARY ct)
# fields (SURVEY.md §2.4 wire contract 2) — Base64 inflates every
# ciphertext 4/3x. Both transports (HTTP multipart and local cp) move
# opaque files, so a raw-binary container is a drop-in: PQWD magic +
# u32 header length + JSON header (the document with each ciphertext field
# replaced by a blob index) + concatenated raw blobs. Readers auto-detect
# by magic; writers preserve the input container by default (VERDICT r4
# weak #4 — the downlink artifact moves every round).

DOC_MAGIC = b"PQWD"


def save_enc_doc(doc: Dict[str, Any], path: str, binary: bool = False) -> None:
    """Write an encrypted-weights document. ``binary=False``: reference-
    shaped JSON (ciphertext fields are Base64 strings). ``binary=True``:
    the PQWD raw-binary container (~25% smaller; ct fields may be Base64
    strings or raw bytes on input — strings are decoded, not re-encoded)."""
    if not binary:
        with open(path, "w") as f:
            json.dump(doc, f)
        return
    blobs: list[bytes] = []

    def take(v) -> int:
        blobs.append(base64.b64decode(v) if isinstance(v, str) else bytes(v))
        return len(blobs) - 1

    head = {k: v for k, v in doc.items() if k != "weights_summary"}
    head["weights_summary"] = [
        {**{k: v for k, v in e.items()
            if k not in ("mean", "std_dev", "values")},
         "mean": take(e["mean"]), "std_dev": take(e["std_dev"]),
         "values": [take(s) for s in e["values"]]}
        for e in doc["weights_summary"]
    ]
    head["blob_lens"] = [len(b) for b in blobs]
    hb = json.dumps(head).encode()
    with open(path, "wb") as f:
        f.write(DOC_MAGIC + struct.pack("<I", len(hb)) + hb)
        for b in blobs:
            f.write(b)


def load_enc_doc(path: str) -> Dict[str, Any]:
    """Read an encrypted-weights document, auto-detecting the container.
    Binary containers yield raw ``bytes`` ciphertext fields (consumers —
    fl.api._load_all_cts — accept both bytes and Base64 strings)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != DOC_MAGIC:
        return json.loads(data.decode())
    (hlen,) = struct.unpack("<I", data[4:8])
    head = json.loads(data[8 : 8 + hlen].decode())
    lens = head.pop("blob_lens")
    offs = [8 + hlen]
    for ln in lens:
        offs.append(offs[-1] + ln)

    def blob(i: int) -> bytes:
        return data[offs[i] : offs[i] + lens[i]]

    for e in head["weights_summary"]:
        e["mean"] = blob(e["mean"])
        e["std_dev"] = blob(e["std_dev"])
        e["values"] = [blob(i) for i in e["values"]]
    return head


def doc_is_binary(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(4) == DOC_MAGIC


# -- OpenFHE wire compatibility (encryptModelWeights.cpp:85-86) -------------

def _openfhe_emitter(ctx: CkksContext):
    """Per-context cereal emitter over the Q chain (lazy; openfhe_emit)."""
    em = ctx.__dict__.get("_openfhe_emitter")
    if em is None:
        from .openfhe_emit import OpenFheEmitter

        L = ctx.params.num_q
        em = OpenFheEmitter(
            ctx.params.n, list(ctx.params.q_moduli),
            [int(p) for p in ctx.basis.psis[:L]],
            batch_size=ctx.params.slots,
            scaling_mod_size=ctx.params.scale_bits,
            mult_depth=ctx.params.num_q - 1, dnum=ctx.params.dnum,
            sigma=ctx.params.sigma)
        ctx.__dict__["_openfhe_emitter"] = em
    return em


def ciphertext_to_b64_openfhe(ct: Ciphertext, ctx: CkksContext,
                              key_tag: str = "ppqsflhe") -> str:
    """Base64(cereal-BINARY) ciphertext — the reference's exact wire format
    (Serial::Serialize(ct, BINARY) + Base64Encode). Level-reduced
    ciphertexts carry their truncated chain like OpenFHE's do."""
    em = _openfhe_emitter(ctx)
    l = ct.nlimbs
    buf = em.ciphertext_binary(
        np.asarray(ct.data), scale=float(ct.scale),
        level=ctx.params.num_q - l, key_tag=key_tag,
        moduli=list(ctx.params.q_moduli[:l]),
        roots=[int(p) for p in ctx.basis.psis[:l]])
    return base64.b64encode(buf).decode()


def ciphertext_seeded_parts(b: bytes):
    """For a v3 (seeded) blob: (c0 residues u64[l, n], seed, scale) without
    expanding c1 — lets callers batch many expansions into one device call
    (fl.api._load_all_cts). Returns None for any other format."""
    if b[:4] != MAGIC:
        return None
    ver, k, l, n, scale = struct.unpack("<IIIId", b[4:28])
    if ver != 3:
        return None
    widths = b[28 : 28 + l]
    seed = b[28 + l : 28 + l + 16]
    c0 = np.zeros((l, n), np.uint64)
    off = 28 + l + 16
    for i in range(l):
        w = widths[i]
        c0[i] = _unpack_limb(b[off:], w, n)
        off += n * w
    return c0, seed, scale


def ciphertext_from_b64_any(s: str, ctx: CkksContext | None = None) -> Ciphertext:
    """Parse either wire format: this package's PQTC blobs or OpenFHE
    cereal-BINARY (auto-detected by the leading bytes)."""
    return ciphertext_from_bytes_any(base64.b64decode(s), ctx)


def ciphertext_from_bytes_any(b: bytes, ctx: CkksContext | None = None) -> Ciphertext:
    if b[:4] == MAGIC:
        return ciphertext_from_bytes(b, ctx)
    from .openfhe_emit import parse_ciphertext_binary

    try:
        rec = parse_ciphertext_binary(b)
    except Exception as e:
        # a corrupted/foreign blob otherwise surfaces as a bare
        # AssertionError from deep inside the cereal parser
        raise ValueError(
            "bad ciphertext magic: not a PQTC blob and not parseable as "
            f"OpenFHE cereal BINARY ({type(e).__name__})") from e
    return Ciphertext(data=jnp.asarray(rec["towers"]), scale=rec["scale"])

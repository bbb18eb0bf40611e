#!/usr/bin/env python
"""Measured wire/artifact sizes vs the reference's committed run
(BASELINE.md:13-18).

The reference pins every artifact size in orchestration/metrics/
comm_metrics.csv: CC 15,199 B, pubkey 12,622,786 B, rekey 26,799,207 B,
encrypted weights 37,806,011 B, aggregate/domain-changed 28,368,755 B.
This bench produces the SAME artifacts at the SAME parameters (reference
chain N=16384, 4 towers, batch 8192, the real 39,041-param GRU payload
shape) with this framework's wire formats and reports measured bytes +
ratios. Runs on CPU (sizes are backend-independent).

Prints ONE JSON line and writes SIZES.json.
"""

import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

REF_SIZES = {  # bytes, from the reference's comm_metrics.csv (SURVEY.md §6)
    "cc": 15199,
    "pubkey": 12622786,
    "rekey": 26799207,
    "enc_weights": 37806011,
    "aggregate": 28368755,
}

# the reference GRU's 8 weight tensors (SURVEY.md §2.3) — 39,041 params
GRU_SHAPES = [[7, 192], [64, 192], [2, 192], [64, 192], [64, 192], [2, 192],
              [64, 1], [1]]


def main() -> None:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import numpy as np

    from ppqsflhe.fl import api

    d = tempfile.mkdtemp(prefix="bench_sizes_")
    cc = os.path.join(d, "CC.json")
    api.gen_cc({"multiplicative_depth": 2, "scaling_mod_size": 40,
                "batch_size": 8192, "PREMode": "INDCPA",
                "use_reference_chain": True}, cc)
    p = {}
    for i in (1, 2):
        api.key_gen(cc, f"{d}/pk{i}", f"{d}/sk{i}", seed=100 + i)
    api.rekey_gen(cc, f"{d}/sk1", f"{d}/pk2", f"{d}/rk12", seed=7)

    rng = np.random.default_rng(0)
    weights = {"weights_summary": [
        {"layer": f"param_{i}", "shape": sh, "mean": 0.0, "std_dev": 1.0,
         "values": rng.normal(0, 0.2, int(np.prod(sh))).tolist()}
        for i, sh in enumerate(GRU_SHAPES)
    ]}
    w_path = f"{d}/weights.json"
    with open(w_path, "w") as f:
        json.dump(weights, f)

    api.encrypt_weights(cc, f"{d}/pk1", w_path, f"{d}/enc_dense.json", seed=21)
    api.encrypt_weights(cc, f"{d}/sk1", w_path, f"{d}/enc_seeded.json", seed=21)
    api.encrypt_weights(cc, f"{d}/pk1", w_path, f"{d}/enc_openfhe.json",
                        seed=21, wire="openfhe")
    api.change_cipher_domain(cc, f"{d}/rk12", f"{d}/enc_seeded.json",
                             f"{d}/agg.json")

    # The production (lazy + binary-container) round, mirroring the
    # orchestrator's schedule (VERDICT r4 weak #4): seeded binary uplinks,
    # uplink PRE drops one tower, lazy FedAvg drops another, and the
    # decrypt-only downlink is LevelReduced to ONE tower before the final
    # switch. The downlink artifact is what moves every round — compare it
    # against the reference's 28.4 MB c2_domainChange_c1.json.
    api.rekey_gen(cc, f"{d}/sk2", f"{d}/pk1", f"{d}/rk21", seed=8)
    api.encrypt_weights(cc, f"{d}/sk1", w_path, f"{d}/e1.bin", seed=31,
                        container="bin")
    api.encrypt_weights(cc, f"{d}/sk2", w_path, f"{d}/e2.bin", seed=32,
                        container="bin")
    api.change_cipher_domain(cc, f"{d}/rk12", f"{d}/e1.bin", f"{d}/e1in2.bin",
                             drop_limbs=1)
    api.aggregate_encrypted_weights(cc, [f"{d}/e1in2.bin", f"{d}/e2.bin"],
                                    f"{d}/agg2.bin", lazy=True)
    api.change_cipher_domain(cc, f"{d}/rk21", f"{d}/agg2.bin",
                             f"{d}/downlink.bin", keep_limbs=1)
    # correctness: the 1-tower binary downlink still decrypts to FedAvg
    api.decrypt_weights(cc, f"{d}/sk1", f"{d}/downlink.bin", f"{d}/dec.json")
    with open(f"{d}/dec.json") as f:
        dec = json.load(f)
    # both clients encrypted the same payload, so FedAvg == the payload
    err = max(
        float(np.abs(np.asarray(e["values"]) - np.asarray(w["values"])).max())
        for e, w in zip(dec["weights_summary"], weights["weights_summary"])
    )
    assert err < 1e-4, f"lazy binary downlink decrypt error {err}"

    sz = lambda name: os.path.getsize(os.path.join(d, name))
    sizes = {
        "cc": sz("CC.json"),
        "pubkey": sz("pk1"),
        "secret_key": sz("sk1"),
        "rekey": sz("rk12"),
        "enc_weights_dense": sz("enc_dense.json"),
        "enc_weights_seeded": sz("enc_seeded.json"),
        "enc_weights_seeded_bin": sz("e1.bin"),
        "enc_weights_openfhe_wire": sz("enc_openfhe.json"),
        "aggregate_full_level": sz("agg.json"),
        "aggregate_lazy_bin": sz("downlink.bin"),
        "plain_weights": sz("weights.json"),
    }
    ratios = {
        "pubkey": REF_SIZES["pubkey"] / sizes["pubkey"],
        "rekey": REF_SIZES["rekey"] / sizes["rekey"],
        "enc_weights_dense": REF_SIZES["enc_weights"] / sizes["enc_weights_dense"],
        "enc_weights_seeded": REF_SIZES["enc_weights"] / sizes["enc_weights_seeded"],
        "enc_weights_seeded_bin": REF_SIZES["enc_weights"] / sizes["enc_weights_seeded_bin"],
        "aggregate_full_level": REF_SIZES["aggregate"] / sizes["aggregate_full_level"],
        "aggregate": REF_SIZES["aggregate"] / sizes["aggregate_lazy_bin"],
    }
    out = {
        "metric": "wire_size_reduction_enc_weights",
        "value": round(ratios["enc_weights_seeded"], 2),
        "unit": "x_smaller_than_reference",
        "sizes_bytes": sizes,
        "reference_bytes": REF_SIZES,
        "ratios_vs_reference": {k: round(v, 2) for k, v in ratios.items()},
    }
    with open(os.path.join(REPO, "SIZES.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()

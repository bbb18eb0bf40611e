"""Full FL lifecycle end-to-end (run.sh equivalent, SURVEY.md §3.1):
init phase + rounds with real local training, encryption, PRE, aggregation,
decryption and warm start — on a tiny ring + synthetic data."""

import json
import os

import numpy as np
import pandas as pd
import pytest

from ppqsflhe.orchestration import Orchestrator, OrchestratorConfig


def synth_csv(path, hours=200, seed=0):
    rng = np.random.default_rng(seed)
    ts = pd.date_range("2024-07-01", periods=hours, freq="h")
    vals = 100 + 20 * np.sin(2 * np.pi * ts.hour.values / 24) + rng.normal(0, 2, hours)
    pd.DataFrame({"Timestamp": ts.strftime("%d-%m-%Y %H:%M"), "Data": vals}).to_csv(
        path, index=False)
    return path


@pytest.mark.parametrize("comm_mode", ["local", "http"])
def test_two_round_fl_run(tmp_path, comm_mode):
    csvs = [synth_csv(str(tmp_path / f"c{i}.csv"), seed=i) for i in (1, 2)]
    client_cfgs = [
        {
            "client_id": f"client_{i+1}",
            "data_file": csvs[i],
            "train_end_date": "2024-07-08 23:00:00",
            "test_start_date": "2024-07-09 00:00:00",
            "lookback": 12,
            "epochs": 2,
        }
        for i in range(2)
    ]
    cfg = OrchestratorConfig(
        rounds=2, n_clients=2, work_dir=str(tmp_path / "run"),
        comm_mode=comm_mode,
        cc_config={"ring_dim": 128, "batch_size": 32, "multiplicative_depth": 2},
        client_configs=client_cfgs, train=True, seed=5,
    )
    results = Orchestrator(cfg).run()
    assert len(results) == 2
    # both clients got a decrypted aggregate; aggregates must AGREE
    decs = []
    for i in (1, 2):
        p = str(tmp_path / "run" / f"client_{i}" / "decrypted_weights.json")
        assert os.path.exists(p)
        with open(p) as f:
            decs.append(json.load(f)["weights_summary"])
    assert len(decs[0]) == 8  # GRU exports 8 tensors
    for a, b in zip(decs[0], decs[1]):
        assert a["layer"] == b["layer"] and a["shape"] == b["shape"]
        np.testing.assert_allclose(a["values"], b["values"], atol=1e-3)
    # and the aggregate equals the mean of the two exported weight files
    ws = []
    for i in (1, 2):
        with open(str(tmp_path / "run" / f"client_{i}" / "weights.json")) as f:
            ws.append(json.load(f)["weights_summary"])
    for k in range(8):
        want = (np.asarray(ws[0][k]["values"]) + np.asarray(ws[1][k]["values"])) / 2
        np.testing.assert_allclose(decs[0][k]["values"], want, atol=1e-3)
    # metrics CSV written
    assert os.path.exists(str(tmp_path / "run" / "metrics" / "comm_metrics.csv"))


def test_indcca_lazy_round(tmp_path):
    """One full round under PREMode INDCCA (re-randomized PRE, server uses
    the uploaded target pubkeys) combined with lazy level management —
    the hardened + optimized production configuration."""
    w = {}
    rng = np.random.default_rng(7)
    for i in (1, 2):
        vals = rng.uniform(-1, 1, 40)
        w[i] = str(tmp_path / f"w{i}.json")
        with open(w[i], "w") as f:
            json.dump({"weights_summary": [{
                "layer": "dense", "shape": [40],
                "mean": float(vals.mean()), "std_dev": float(vals.std()),
                "values": [float(x) for x in vals],
            }]}, f)
    cfg = OrchestratorConfig(
        rounds=1, n_clients=2, work_dir=str(tmp_path / "run"),
        comm_mode="local",
        cc_config={"ring_dim": 128, "batch_size": 32,
                   "multiplicative_depth": 2, "PREMode": "INDCCA"},
        client_configs=[{"INPUT_WEIGHTS_PATH": w[i + 1]} for i in range(2)],
        train=False, seed=11, lazy_levels=True,
    )
    Orchestrator(cfg).run()
    want = None
    for i in (1, 2):
        with open(str(tmp_path / "run" / f"client_{i}" / "decrypted_weights.json")) as f:
            got = np.asarray(json.load(f)["weights_summary"][0]["values"])
        if want is None:
            with open(w[1]) as f1, open(w[2]) as f2:
                want = (np.asarray(json.load(f1)["weights_summary"][0]["values"])
                        + np.asarray(json.load(f2)["weights_summary"][0]["values"])) / 2
        # two INDCCA hops at pre_flood_bits=30, Δ=2^40 (~0.01/hop at N=128)
        np.testing.assert_allclose(got, want, atol=0.1)


def test_client_dropout_tolerance(tmp_path):
    """A client that fails mid-round is dropped; the server aggregates the
    survivors (here: 3 clients, client_2's weights file is missing), the
    round completes, and the decrypted aggregate is the mean of the
    SURVIVING clients' weights (SURVEY.md §5.3 — beyond the reference's
    set -e fail-fast)."""
    import numpy as np

    n = 3
    rng = np.random.default_rng(7)
    client_cfgs = []
    for i in range(1, n + 1):
        w = str(tmp_path / f"w{i}.json")
        if i != 2:  # client_2 provides NO weights file → its round step raises
            with open(w, "w") as f:
                json.dump({"weights_summary": [{
                    "layer": "dense/kernel",
                    "shape": [4, 2],
                    "mean": 0.0, "std_dev": 1.0,
                    "values": rng.uniform(-1, 1, 8).tolist(),
                }]}, f)
        client_cfgs.append({"INPUT_WEIGHTS_PATH": w})
    cfg = OrchestratorConfig(
        rounds=1, n_clients=n, work_dir=str(tmp_path / "run"), comm_mode="local",
        cc_config={"ring_dim": 128, "batch_size": 32, "multiplicative_depth": 2},
        client_configs=client_cfgs, train=False, seed=9,
    )
    results = Orchestrator(cfg).run()
    assert results[0]["active"] == [1, 3]
    assert results[0]["dropped"] == [2]
    # survivors got the aggregate; the dropped client did not
    assert os.path.exists(str(tmp_path / "run" / "client_1" / "decrypted_weights.json"))
    assert not os.path.exists(str(tmp_path / "run" / "client_2" / "decrypted_weights.json"))
    with open(str(tmp_path / "run" / "client_1" / "decrypted_weights.json")) as f:
        got = np.asarray(json.load(f)["weights_summary"][0]["values"])
    w1 = np.asarray(json.load(open(str(tmp_path / "w1.json")))["weights_summary"][0]["values"])
    w3 = np.asarray(json.load(open(str(tmp_path / "w3.json")))["weights_summary"][0]["values"])
    np.testing.assert_allclose(got, (w1 + w3) / 2, atol=1e-3)


def test_hub_dropout_aborts_round(tmp_path):
    """If the HUB client (whose key domain hosts aggregation) drops, the
    round must fail loudly — no rekeys exist into a replacement hub."""
    import numpy as np

    n = 2
    rng = np.random.default_rng(7)
    w1 = str(tmp_path / "w1.json")
    with open(w1, "w") as f:
        json.dump({"weights_summary": [{
            "layer": "d/k", "shape": [2, 2], "mean": 0.0, "std_dev": 1.0,
            "values": rng.uniform(-1, 1, 4).tolist()}]}, f)
    client_cfgs = [{"INPUT_WEIGHTS_PATH": w1},
                   {"INPUT_WEIGHTS_PATH": str(tmp_path / "missing.json")}]
    cfg = OrchestratorConfig(
        rounds=1, n_clients=n, work_dir=str(tmp_path / "run"), comm_mode="local",
        cc_config={"ring_dim": 128, "batch_size": 32, "multiplicative_depth": 2},
        client_configs=client_cfgs, train=False, seed=9,
    )
    with pytest.raises(RuntimeError, match="hub"):
        Orchestrator(cfg).run()


def test_fail_fast_mode_preserves_reference_semantics(tmp_path):
    cfg = OrchestratorConfig(
        rounds=1, n_clients=2, work_dir=str(tmp_path / "run"), comm_mode="local",
        cc_config={"ring_dim": 128, "batch_size": 32, "multiplicative_depth": 2},
        client_configs=[{"INPUT_WEIGHTS_PATH": str(tmp_path / "nope.json")}] * 2,
        train=False, seed=9, fail_fast=True,
    )
    orch = Orchestrator(cfg)
    with pytest.raises(Exception):
        orch.run()


def test_threshold_protocol_round(tmp_path):
    """protocol='threshold': joint-key FL — no PRE key switches; the server
    aggregates under the joint key and clients run the distributed
    decryption (partial decrypt + fusion). The fused aggregate must equal
    the mean of the clients' weights (within smudging noise)."""
    n = 3
    rng = np.random.default_rng(11)
    client_cfgs = []
    for i in range(1, n + 1):
        w = str(tmp_path / f"w{i}.json")
        with open(w, "w") as f:
            json.dump({"weights_summary": [{
                "layer": "dense/kernel", "shape": [4, 2],
                "mean": 0.0, "std_dev": 1.0,
                "values": rng.uniform(-1, 1, 8).tolist(),
            }]}, f)
        client_cfgs.append({"INPUT_WEIGHTS_PATH": w})
    cfg = OrchestratorConfig(
        rounds=1, n_clients=n, work_dir=str(tmp_path / "run"), comm_mode="local",
        cc_config={"ring_dim": 128, "batch_size": 32, "multiplicative_depth": 2},
        client_configs=client_cfgs, train=False, seed=21,
        protocol="threshold",
    )
    results = Orchestrator(cfg).run()
    assert results[0]["active"] == [1, 2, 3]
    # no PRE artifacts in threshold mode
    assert not os.path.exists(
        str(tmp_path / "run" / "server_storage" / "c1_domainChange_c3.json"))
    want = np.mean([np.asarray(json.load(open(str(tmp_path / f"w{i}.json")))
                               ["weights_summary"][0]["values"])
                    for i in (1, 2, 3)], axis=0)
    for i in (1, 2, 3):
        p = str(tmp_path / "run" / f"client_{i}" / "decrypted_weights.json")
        assert os.path.exists(p)
        got = np.asarray(json.load(open(p))["weights_summary"][0]["values"])
        # ss=30 smudging at Δ=2^40, N=128, 3 parties → ~0.02 slot noise
        np.testing.assert_allclose(got, want, atol=0.1)


def test_checkpoint_resume(tmp_path):
    """A killed orchestrator resumes from its work_dir checkpoint: init
    (key material) is not regenerated and completed rounds are not re-run
    (SURVEY.md §5.4 resume, extended to the orchestration lifecycle)."""
    rng = np.random.default_rng(3)
    w = str(tmp_path / "w.json")
    with open(w, "w") as f:
        json.dump({"weights_summary": [{
            "layer": "d/k", "shape": [2, 2], "mean": 0.0, "std_dev": 1.0,
            "values": rng.uniform(-1, 1, 4).tolist()}]}, f)
    base = dict(
        n_clients=2, work_dir=str(tmp_path / "run"), comm_mode="local",
        cc_config={"ring_dim": 128, "batch_size": 32, "multiplicative_depth": 2},
        client_configs=[{"INPUT_WEIGHTS_PATH": w}] * 2, train=False, seed=4,
    )
    r1 = Orchestrator(OrchestratorConfig(rounds=1, **base)).run()
    assert [x["round"] for x in r1] == [1]
    key = str(tmp_path / "run" / "client_1" / "client_1-private.key")
    mtime = os.path.getmtime(key)

    # resume with a larger round budget: only rounds 2..3 run, keys untouched
    r2 = Orchestrator(OrchestratorConfig(rounds=3, **base)).run(resume=True)
    assert [x["round"] for x in r2] == [2, 3]
    assert os.path.getmtime(key) == mtime

    # config mismatch on resume fails loudly
    import pytest as _pytest

    bad = dict(base, n_clients=3,
               client_configs=[{"INPUT_WEIGHTS_PATH": w}] * 3)
    with _pytest.raises(ValueError, match="resume mismatch"):
        Orchestrator(OrchestratorConfig(rounds=3, **bad)).run(resume=True)


def test_binary_wire_lazy_round(tmp_path):
    """binary_wire=True + lazy_levels=True (the r5 production wire): every
    encrypted artifact is a PQWD raw-binary container, the downlink is
    LevelReduced to ONE tower before the final PRE (keep_limbs=1), and the
    decrypted FedAvg is still exact. Also checks the container really is
    binary and smaller than the JSON equivalent."""
    w = {}
    rng = np.random.default_rng(13)
    for i in (1, 2):
        vals = rng.uniform(-1, 1, 50)
        w[i] = str(tmp_path / f"w{i}.json")
        with open(w[i], "w") as f:
            json.dump({"weights_summary": [{
                "layer": "dense", "shape": [50],
                "mean": float(vals.mean()), "std_dev": float(vals.std()),
                "values": [float(x) for x in vals],
            }]}, f)
    cfg = OrchestratorConfig(
        rounds=1, n_clients=2, work_dir=str(tmp_path / "run"),
        comm_mode="local",
        cc_config={"ring_dim": 128, "batch_size": 32,
                   "multiplicative_depth": 2},
        client_configs=[{"INPUT_WEIGHTS_PATH": w[i + 1]} for i in range(2)],
        train=False, seed=29, lazy_levels=True, binary_wire=True,
    )
    Orchestrator(cfg).run()
    from ppqsflhe.ckks import serialize as ser

    # uplink artifact is the binary container
    up = str(tmp_path / "run" / "client_1" / "encrypted_weights_c1.json")
    assert ser.doc_is_binary(up)
    # downlink (non-hub client's domain-changed aggregate) is binary AND at
    # one tower — parse a ciphertext and check
    # hub = client_2, so the downlink to client_1 is c2_domainChange_c1
    dl = str(tmp_path / "run" / "server_storage" / "c2_domainChange_c1.json")
    assert ser.doc_is_binary(dl)
    doc = ser.load_enc_doc(dl)
    ct = ser.ciphertext_from_bytes_any(doc["weights_summary"][0]["mean"])
    assert ct.nlimbs == 1, f"downlink at {ct.nlimbs} towers, wanted 1"
    # FedAvg still exact
    want = None
    for i in (1, 2):
        with open(str(tmp_path / "run" / f"client_{i}" /
                      "decrypted_weights.json")) as f:
            got = np.asarray(json.load(f)["weights_summary"][0]["values"])
        if want is None:
            with open(w[1]) as f1, open(w[2]) as f2:
                want = (np.asarray(json.load(f1)["weights_summary"][0]["values"])
                        + np.asarray(json.load(f2)["weights_summary"][0]["values"])) / 2
        np.testing.assert_allclose(got, want, atol=1e-3)


def test_chip_smoke_round_phase(tmp_path):
    """chip_smoke's main-path phase on the CPU backend at N=2^10: two PRE
    rounds and one threshold round through the orchestrator CLI, each
    client's decrypted global checked against the plaintext FedAvg."""
    import jax

    import chip_smoke

    cc = {"multiplicative_depth": 2, "scaling_mod_size": 40,
          "batch_size": 512, "PREMode": "INDCPA", "ring_dim": 1024}
    cpu = jax.devices("cpu")[0]
    chip_smoke.round_phase(str(tmp_path), cc, cpu, cpu, hours=10 * 24,
                           epochs=1, lookback=12)

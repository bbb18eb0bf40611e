"""Metrics analyzer + round evaluation + LSTM model family tests."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pandas as pd

from ppqsflhe.comm.analyze import analyze, cross_check, load_metrics, summarize
from ppqsflhe.comm.metrics import MetricsLog
from ppqsflhe.train import lstm


def make_csvs(tmp):
    c = MetricsLog(str(tmp / "client.csv"), "client")
    s = MetricsLog(str(tmp / "server.csv"), "server")
    c.log("POST", "/uploadEncWeightsC1", "client_1", "enc_weights", "w.json",
          payload_size=1000, bytes_sent=1000, latency_ms=12)
    s.log("POST", "/uploadEncWeightsC1", "client_1", "enc_weights", "w.json",
          payload_size=1000, bytes_received=1000, latency_ms=3)
    c.log("GET", "/getCC", "", "", "CC.json", bytes_received=500, latency_ms=5)
    # a size mismatch pair
    c.log("POST", "/uploadReKeyC2", "client_2", "rekey", "rk.key",
          payload_size=5000, bytes_sent=5000, latency_ms=9)
    s.log("POST", "/uploadReKeyC2", "client_2", "rekey", "rk.key",
          payload_size=3000, bytes_received=3000, latency_ms=2)
    return str(tmp / "client.csv"), str(tmp / "server.csv")


def test_analyze_summaries_and_crosscheck(tmp_path):
    ccsv, scsv = make_csvs(tmp_path)
    res = analyze(ccsv, scsv, plot_dir=str(tmp_path / "plots"))
    types = {r["type"] for r in res["client_summary"]}
    assert "enc_weights" in types and "rekey" in types
    cc = res["cross_check"]
    assert cc["matched"] >= 2
    assert len(cc["size_mismatches"]) == 1
    assert cc["size_mismatches"][0]["file"] == "rk.key"
    assert len(res.get("plots", [])) == 3


def test_evaluate_rounds(tmp_path):
    from ppqsflhe.train import gru
    from ppqsflhe.train.trainer import _save_ckpt
    from tests.test_train import synth_csv, client_cfg

    csv = synth_csv(str(tmp_path / "d.csv"))
    cfg = client_cfg(str(tmp_path), csv)
    cfg["client_id"] = "t1"
    cfg["log_dir"] = str(tmp_path / "logs")
    os.makedirs(cfg["log_dir"])
    for r in (1, 2):
        params = gru.init_params(jax.random.PRNGKey(r), 7)
        _save_ckpt(params, os.path.join(cfg["log_dir"], f"t1_best_2024010{r}_000000.npz"))
    from ppqsflhe.train.evaluate import evaluate_rounds

    mdf = evaluate_rounds(cfg, out_dir=str(tmp_path / "results"), verbose=False)
    assert len(mdf) == 2
    assert "test_MAE" in mdf.columns
    assert any(f.endswith(".csv") for f in os.listdir(str(tmp_path / "results")))


def test_lstm_million_params():
    """BASELINE.json config 5: ~1M-param LSTM payload."""
    params = lstm.init_params(jax.random.PRNGKey(0), 7)
    n = lstm.num_params(params)
    assert 1_000_000 <= n <= 1_200_000, n
    x = jnp.zeros((3, 12, 7))
    out = lstm.forward(params, x)
    assert out.shape == (3,)

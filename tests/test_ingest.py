"""Telemetry ingestion pipeline tests (the reference README's claimed
Kafka layer, README.md:16,28,36 — implemented natively in ingest/)."""

import json
import os

import numpy as np
import pytest

from ppqsflhe.ingest import Broker, CsvMaterializer, IngestServer, \
    TelemetryProducer, replay_csv
from ppqsflhe.ingest.service import HttpBrokerClient


def test_publish_fetch_offsets(tmp_path):
    b = Broker(str(tmp_path))
    assert b.topics() == []
    offs = [b.publish("t1", {"x": i}) for i in range(5)]
    assert offs == list(range(5))
    assert b.end_offset("t1") == 5
    assert b.topics() == ["t1"]
    recs = b.fetch("t1", offset=2)
    assert [r["value"]["x"] for r in recs] == [2, 3, 4]
    assert [r["offset"] for r in recs] == [2, 3, 4]
    assert b.fetch("t1", offset=2, max_records=1)[0]["value"]["x"] == 2
    assert b.fetch("t1", offset=99) == []
    assert b.fetch("nope") == []


def test_publish_batch_and_key(tmp_path):
    b = Broker(str(tmp_path))
    offs = b.publish_batch("t", [1, 2, 3], key="k1")
    assert offs == [0, 1, 2]
    assert all(r["key"] == "k1" for r in b.fetch("t"))


def test_consumer_groups_resume_independently(tmp_path):
    b = Broker(str(tmp_path))
    b.publish_batch("t", list(range(10)))
    # group A reads 4, group B reads all
    got_a = b.poll("t", "A", max_records=4)
    assert [r["value"] for r in got_a] == [0, 1, 2, 3]
    assert [r["value"] for r in b.poll("t", "B")] == list(range(10))
    # a "restarted" broker handle resumes group A at its commit
    b2 = Broker(str(tmp_path))
    assert b2.committed("t", "A") == 4
    assert [r["value"] for r in b2.poll("t", "A")] == [4, 5, 6, 7, 8, 9]
    assert b2.poll("t", "A") == []          # drained
    assert b2.poll("t", "B") == []


def test_invalid_names(tmp_path):
    b = Broker(str(tmp_path))
    with pytest.raises(ValueError):
        b.publish("../evil", 1)
    with pytest.raises(ValueError):
        b.commit("t", "gr/oup", 0)


def test_http_service_roundtrip(tmp_path):
    srv = IngestServer(str(tmp_path), port=0).start()
    try:
        c = HttpBrokerClient(f"http://127.0.0.1:{srv.port}")
        assert c.publish("metrics", {"v": 1.5}) == 0
        assert c.publish_batch("metrics", [{"v": 2.0}, {"v": 3.0}]) == [1, 2]
        assert c.end_offset("metrics") == 3
        assert c.topics() == ["metrics"]
        recs = c.fetch("metrics", offset=1)
        assert [r["value"]["v"] for r in recs] == [2.0, 3.0]
        got = c.poll("metrics", "g1", max_records=2)
        assert [r["value"]["v"] for r in got] == [1.5, 2.0]
        assert c.committed("metrics", "g1") == 2
        c.commit("metrics", "g1", 0)
        assert c.committed("metrics", "g1") == 0
    finally:
        srv.stop()


def _synthetic_rows(n, start="2024-01-01 00:00:00"):
    import pandas as pd

    ts = pd.date_range(start, periods=n, freq="h")
    rng = np.random.default_rng(0)
    return [{"Timestamp": t.strftime("%Y-%m-%d %H:%M:%S"),
             "Data": float(v)} for t, v in zip(ts, rng.uniform(10, 20, n))]


def test_telemetry_to_training_csv(tmp_path):
    """End-to-end: produce per-client telemetry → CsvMaterializer drains into
    the client-local CSV → train.data.load_timeseries consumes it (the
    reference's documented ingestion → training handoff)."""
    from ppqsflhe.train.data import FEATURE_NAMES, load_timeseries

    b = Broker(str(tmp_path / "broker"))
    prod = TelemetryProducer(b, "client_1")
    rows = _synthetic_rows(50)
    prod.send_batch(rows[:30])

    csv_path = str(tmp_path / "client_1" / "training_data.csv")
    mat = CsvMaterializer(b, "client_1", csv_path)
    assert mat.drain() == 30
    # late-arriving records append, no duplicates (offset-resumed)
    prod.send_batch(rows[30:])
    assert mat.drain() == 20
    assert mat.drain() == 0

    df = load_timeseries(csv_path)
    assert len(df) == 50
    assert all(c in df.columns for c in FEATURE_NAMES)
    np.testing.assert_allclose(df["Data"],
                               [r["Data"] for r in rows], rtol=1e-12)
    assert df["HourOfDay"].tolist() == [i % 24 for i in range(50)]


def test_trainer_telemetry_hook(tmp_path):
    """train_client with telemetry_broker_root drains the client's topic into
    data_file before reading it — training runs purely off streamed data."""
    import pandas as pd

    from ppqsflhe.train.trainer import train_client

    b = Broker(str(tmp_path / "broker"))
    ts = pd.date_range("2024-07-01", periods=200, freq="h")
    rng = np.random.default_rng(3)
    vals = 100 + 20 * np.sin(2 * np.pi * ts.hour.values / 24) + rng.normal(0, 2, 200)
    TelemetryProducer(b, "t1").send_batch(
        [{"Timestamp": t.strftime("%d-%m-%Y %H:%M"), "Data": float(v)}
         for t, v in zip(ts, vals)])

    csv_path = str(tmp_path / "stream.csv")          # does not exist yet
    cfg = {
        "client_id": "t1", "data_file": csv_path,
        "telemetry_broker_root": str(tmp_path / "broker"),
        "train_end_date": "2024-07-07 23:00:00",
        "test_start_date": "2024-07-08 00:00:00",
        "lookback": 24, "n_features": 6, "epochs": 2, "hidden": 8,
        "INPUT_WEIGHTS_PATH": str(tmp_path / "weights.json"),
        "OUTPUT_DECRYPTED_WEIGHTS_PATH": str(tmp_path / "decrypted.json"),
    }
    res = train_client(cfg, seed=0, verbose=False)
    assert os.path.exists(csv_path)
    assert len(res.history["loss"]) >= 1
    assert os.path.exists(cfg["INPUT_WEIGHTS_PATH"])


def test_replay_csv_roundtrip(tmp_path):
    import csv as _csv

    src = str(tmp_path / "src.csv")
    rows = _synthetic_rows(25)
    with open(src, "w", newline="") as f:
        w = _csv.DictWriter(f, fieldnames=["Timestamp", "Data"])
        w.writeheader()
        w.writerows(rows)
    b = Broker(str(tmp_path / "broker"))
    assert replay_csv(b, "client_2", src, batch_size=10) == 25
    out = str(tmp_path / "out.csv")
    assert CsvMaterializer(b, "client_2", out).drain() == 25
    with open(out) as f:
        got = list(_csv.DictReader(f))
    assert len(got) == 25
    assert got[0]["Timestamp"] == rows[0]["Timestamp"]
    np.testing.assert_allclose([float(r["Data"]) for r in got],
                               [r["Data"] for r in rows], rtol=1e-12)

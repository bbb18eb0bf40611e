"""JAX GRU trainer tests (reference: client/src/c_trainAndUpdate.py)."""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pandas as pd
import pytest

from ppqsflhe.train import data as D
from ppqsflhe.train import gru
from ppqsflhe.train.trainer import train_client, calc_metrics, evaluate_on_test


def synth_csv(path, hours=400, seed=0):
    rng = np.random.default_rng(seed)
    ts = pd.date_range("2024-07-01", periods=hours, freq="h")
    day = ts.hour.values
    vals = 100 + 20 * np.sin(2 * np.pi * day / 24) + rng.normal(0, 2, hours)
    pd.DataFrame({"Timestamp": ts.strftime("%d-%m-%Y %H:%M"), "Data": vals}).to_csv(
        path, index=False)
    return path


def client_cfg(tmp, csv):
    return {
        "client_id": "t1",
        "data_file": csv,
        "train_end_date": "2024-07-12 23:00:00",
        "test_start_date": "2024-07-13 00:00:00",
        "lookback": 24,
        "n_features": 6,
        "epochs": 3,
        "INPUT_WEIGHTS_PATH": os.path.join(tmp, "weights.json"),
        "OUTPUT_DECRYPTED_WEIGHTS_PATH": os.path.join(tmp, "decrypted.json"),
    }


def test_keras_compatible_shapes():
    params = gru.init_params(jax.random.PRNGKey(0), 7)
    shapes = [tuple(p.shape) for p in params]
    assert shapes == [(7, 192), (64, 192), (2, 192), (64, 192), (64, 192),
                      (2, 192), (64, 1), (1,)]
    # reference payload: 39,041 parameters (SURVEY.md §2.3)
    assert sum(int(np.prod(s)) for s in shapes) == 39041


def test_forward_shape():
    params = gru.init_params(jax.random.PRNGKey(0), 7)
    x = jnp.zeros((5, 24, 7))
    out = gru.forward(params, x)
    assert out.shape == (5,)


def test_summary_roundtrip():
    params = gru.init_params(jax.random.PRNGKey(1), 7)
    summ = gru.params_to_summary(params)
    assert summ[0]["layer"] == "param_0"
    back = gru.summary_to_params(summ)
    for a, b in zip(params, back):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-7)


def test_training_reduces_loss(tmp_path):
    csv = synth_csv(str(tmp_path / "d.csv"))
    cfg = client_cfg(str(tmp_path), csv)
    res = train_client(cfg, seed=0, verbose=False)
    assert len(res.history["loss"]) >= 2
    assert res.history["loss"][-1] < res.history["loss"][0]
    assert os.path.exists(cfg["INPUT_WEIGHTS_PATH"])
    with open(cfg["INPUT_WEIGHTS_PATH"]) as f:
        doc = json.load(f)
    assert len(doc["weights_summary"]) == 8
    assert res.metrics["train"]["MAE"] > 0


def test_warm_start(tmp_path):
    """The FL feedback edge: decrypted global weights warm-start the next
    round (c_trainAndUpdate.py:128-133)."""
    csv = synth_csv(str(tmp_path / "d.csv"))
    cfg = client_cfg(str(tmp_path), csv)
    res1 = train_client(cfg, seed=0, verbose=False)
    # pretend the FL round decrypted an aggregate == exported weights
    with open(cfg["INPUT_WEIGHTS_PATH"]) as f:
        doc = json.load(f)
    with open(cfg["OUTPUT_DECRYPTED_WEIGHTS_PATH"], "w") as f:
        json.dump(doc, f)
    res2 = train_client(cfg, seed=1, verbose=False)
    # warm-started run must begin near the previous solution's loss
    assert res2.history["loss"][0] < res1.history["loss"][0]
    m = evaluate_on_test(res2.params, cfg)
    assert "MAE" in m


def test_calc_metrics():
    y = np.array([1.0, 2.0, 3.0])
    m = calc_metrics(y, y, y.mean())
    assert m["MAE"] == 0 and m["RMSE"] == 0 and m["R2"] == 1.0


@pytest.mark.parametrize("family", ["lstm", "mlp", "transformer"])
def test_model_families_train_and_roundtrip(tmp_path, family):
    """The trainer is family-generic (cfg "model"): LSTM, MLP and the
    transformer encoder train, export weights_summary, and warm-start from
    it (the FL feedback edge)."""
    from ppqsflhe.train import trainer

    csv = synth_csv(str(tmp_path / "d.csv"))
    w = str(tmp_path / "w.json")
    cfg = {
        "client_id": "c1", "data_file": csv, "model": family, "hidden": 8,
        "train_end_date": "2024-07-08 23:00:00",
        "test_start_date": "2024-07-09 00:00:00",
        "lookback": 12, "epochs": 2, "INPUT_WEIGHTS_PATH": w,
    }
    res = trainer.train_client(cfg, seed=3, verbose=False)
    assert os.path.exists(w)
    assert np.isfinite(res.metrics["train"]["MAE"])
    # warm start consumes the exported summary for the same family
    cfg["OUTPUT_DECRYPTED_WEIGHTS_PATH"] = w
    res2 = trainer.train_client(cfg, seed=4, verbose=False)
    assert len(res2.params) == len(res.params)
    tm = trainer.evaluate_on_test(res2.params, cfg)
    assert np.isfinite(tm["MAE"])


def test_evaluate_rounds_family_dispatch(tmp_path):
    """Offline round evaluation dispatches forward() on the checkpoint's
    recorded model family — an lstm ckpt must NOT be run through gru.forward
    (VERDICT r2 weak #4) — and writes per-round prediction artifacts."""
    import glob

    from ppqsflhe.train import evaluate as E
    from ppqsflhe.train import trainer

    csv = synth_csv(str(tmp_path / "d.csv"))
    log_dir = str(tmp_path / "logs")
    cfg = {
        "client_id": "c1", "data_file": csv, "model": "lstm", "hidden": 8,
        "train_end_date": "2024-07-08 23:00:00",
        "test_start_date": "2024-07-09 00:00:00",
        "lookback": 12, "epochs": 2, "log_dir": log_dir,
    }
    trainer.train_client(cfg, seed=5, verbose=False)
    cks = sorted(glob.glob(os.path.join(log_dir, "c1_best_*.npz")))
    assert cks and trainer.load_ckpt_meta(cks[0]) == "lstm"

    out_dir = str(tmp_path / "results")
    mdf = E.evaluate_rounds(cfg, out_dir=out_dir, verbose=False)
    assert len(mdf) == len(cks)
    assert np.isfinite(mdf["test_MAE"]).all()
    # an LSTM run through gru.forward would produce wildly-off predictions;
    # sanity-bound the error against the target's scale (~100 ± 20)
    assert (mdf["test_MAE"] < 100).all()
    assert glob.glob(os.path.join(out_dir, "c1_round1_predictions_*.csv"))
    assert glob.glob(os.path.join(out_dir, "c1_round1_predictions_*.png"))


def test_dayfirst_parse_modes():
    """timestamp_dayfirst=False replicates the reference scripts'
    month-first pandas parse (c_trainAndUpdate.py:96): on a day-first
    hourly file, days 13+ coerce to NaT and days 1-12 scatter across
    months — the basis of the committed reference metrics
    (docs/PARITY.md, VERDICT r4 missing #3)."""
    import tempfile

    import pandas as pd

    from ppqsflhe.train import data as D

    ts = pd.date_range("2024-07-01", periods=20 * 24, freq="h")
    csv = tempfile.mktemp(suffix=".csv")
    pd.DataFrame({"Timestamp": ts.strftime("%d-%m-%Y %H:%M"),
                  "Data": range(20 * 24)}).to_csv(csv, index=False)
    good = D.load_timeseries(csv, dayfirst=True)
    assert np.isnat(good["Timestamp"]).sum() == 0
    assert (good["Month"] == 7).all()
    bug = D.load_timeseries(csv, dayfirst=False)
    assert np.isnat(bug["Timestamp"]).sum() == 8 * 24     # days 13..20 -> NaT
    months = bug["Month"]
    assert set(months[~np.isnan(months)]) == set(range(1, 13))
    # NaT rows fall out of the date-split comparisons, like the reference
    tr, te = D.train_test_frames(bug, "2024-07-24 23:00:00", "2024-07-25 00:00:00")
    assert len(tr) + len(te) == 12 * 24


def _pandas_load(csv_path, dayfirst):
    """The pandas feature engineering the loader replaces (reference
    c_trainAndUpdate.py:104-119), kept here as its reference. Numbers are
    read correctly rounded ("round_trip"), as Python's float() reads them;
    pandas' default C parser can be one ulp off."""
    import pandas as pd

    df = pd.read_csv(csv_path, float_precision="round_trip")
    df["Timestamp"] = pd.to_datetime(df["Timestamp"], errors="coerce",
                                     dayfirst=dayfirst)
    df["DayOfYear"] = df["Timestamp"].dt.dayofyear
    df["Month"] = df["Timestamp"].dt.month
    df["DayOfWeek"] = df["Timestamp"].dt.dayofweek
    df["WeekOfYear"] = df["Timestamp"].dt.isocalendar().week.astype("float64")
    df["AcademicMonth"] = df["Month"].apply(
        lambda x: 1 if x in [1, 2, 3, 4, 5, 8, 9, 10, 11] else 0)
    df["HourOfDay"] = df["Timestamp"].dt.hour
    return df


@pytest.mark.parametrize("ts_format", ["%d-%m-%Y %H:%M", "%m/%d/%Y %H:%M:%S",
                                       "%Y-%m-%d %H:%M:%S"])
@pytest.mark.parametrize("dayfirst", [True, False])
def test_loader_matches_pandas(tmp_path, ts_format, dayfirst):
    """The csv/datetime/numpy loader gives pandas' timestamps, calendar
    features, target column and date splits exactly — on day-first,
    month-first and ISO files read either way, including pandas' format
    inference from the first row and its NaT coercion."""
    import pandas as pd

    ts = pd.date_range("2024-07-01", periods=40 * 24, freq="h")
    vals = np.random.default_rng(9).normal(100, 10, len(ts))
    csv = str(tmp_path / "data.csv")
    pd.DataFrame({"Timestamp": ts.strftime(ts_format), "Data": vals}).to_csv(
        csv, index=False)
    want = _pandas_load(csv, dayfirst)
    got = D.load_timeseries(csv, dayfirst=dayfirst)

    assert len(got) == len(want)
    np.testing.assert_array_equal(
        got["Timestamp"], want["Timestamp"].values.astype("datetime64[s]"))
    for col in D.FEATURE_NAMES + [D.TARGET]:
        np.testing.assert_array_equal(
            got[col].astype(np.float64),
            want[col].to_numpy(dtype=np.float64, na_value=np.nan), err_msg=col)
    end, start = "2024-07-24 23:00:00", "2024-07-25 00:00:00"
    tr, te = D.train_test_frames(got, end, start)
    assert len(tr) == int((want["Timestamp"] <= end).sum())
    assert len(te) == int((want["Timestamp"] >= start).sum())

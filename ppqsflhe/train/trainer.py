"""Local client training loop — replaces the Keras fit pipeline
(client/src/c_trainAndUpdate.py main():84-208).

Semantics mirrored from the reference:
- warm start from the decrypted global weights JSON when present (:128-133);
- Adam(1e-3), mse + l2(0.01) on the first GRU kernel, batch 32, ≤100 epochs,
  EarlyStopping(val_loss, patience=4) with best-checkpoint restore (:139-149);
- weight export to the weights_summary JSON schema (:175-190);
- MAE/RMSE/R2/PMAE metrics on train/val (:58-63,195-199);
- loss-curve PNG when matplotlib is available (:153-166).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from datetime import datetime
from typing import Dict, List

import jax
import jax.numpy as jnp
import numpy as np
import optax

from . import data as D
from . import gru, lstm, mlp, transformer

#: selectable model families (cfg key "model"); all share the generic
#: weights_summary export (param_{idx} records) and the Keras weight layout.
MODEL_FAMILIES = {"gru": gru, "lstm": lstm, "mlp": mlp,
                  "transformer": transformer}


@dataclass
class TrainResult:
    params: List[jnp.ndarray]
    history: Dict[str, list]
    metrics: Dict[str, Dict[str, float]]
    weights_path: str | None = None


def calc_metrics(y_true, y_pred, y_mean) -> Dict[str, float]:
    mae = float(np.abs(y_true - y_pred).mean())
    rmse = float(np.sqrt(((y_true - y_pred) ** 2).mean()))
    ss_res = float(((y_true - y_pred) ** 2).sum())
    ss_tot = float(((y_true - y_true.mean()) ** 2).sum())
    r2 = 1.0 - ss_res / ss_tot if ss_tot > 0 else 0.0
    pmae = float(mae / y_mean * 100) if y_mean != 0 else 0.0
    return {"MAE": mae, "RMSE": rmse, "R2": r2, "PMAE": pmae}


def _loss_fn(params, x, y, rng, train: bool, mdl=gru, l2: float = 0.01):
    pred = mdl.forward(params, x, train=train, rng=rng)
    mse = jnp.mean((pred - y) ** 2)
    reg = l2 * jnp.sum(params[0] ** 2)  # keras l2 on the first kernel only
    return mse + reg, mse


def train_client(cfg: Dict, seed: int = 0, verbose: bool = True) -> TrainResult:
    """cfg is the CLIENT section of the reference c_config.json (same keys)."""
    client_id = cfg.get("client_id", "client")
    lookback = int(cfg.get("lookback", 72))
    mdl = MODEL_FAMILIES[cfg.get("model", "gru")]
    ts_tag = datetime.now().strftime("%Y%m%d_%H%M%S")
    log_dir = cfg.get("log_dir")
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)

    # Telemetry ingestion hook (the reference's Kafka → client-local-storage
    # handoff, README.md:36): drain any new records from the client's topic
    # into data_file before training reads it.
    if cfg.get("telemetry_broker_root"):
        from ..ingest import Broker, CsvMaterializer

        n_new = CsvMaterializer(Broker(cfg["telemetry_broker_root"]),
                                client_id, cfg["data_file"]).drain()
        if verbose and n_new:
            print(f"[{client_id}] ingested {n_new} new telemetry records")

    df = D.load_timeseries(cfg["data_file"],
                           dayfirst=bool(cfg.get("timestamp_dayfirst", True)))
    train_df, _ = D.train_test_frames(df, cfg["train_end_date"], cfg["test_start_date"])
    fs, tscl = D.Scaler().fit(train_df.matrix(D.FEATURE_NAMES)), D.Scaler().fit(train_df.matrix([D.TARGET]))
    X, y = D.prepare_sequences(train_df, lookback, fs, tscl)
    X_tr, y_tr, X_val, y_val = D.train_val_split(X, y)

    n_features = X.shape[-1]
    warm = cfg.get("OUTPUT_DECRYPTED_WEIGHTS_PATH")
    if warm and os.path.exists(warm):
        with open(warm) as f:
            params = gru.summary_to_params(json.load(f)["weights_summary"])
        if verbose:
            print(f"[{client_id}] warm start from {warm}")
    else:
        kw = {}
        if cfg.get("hidden"):
            kw["hidden"] = int(cfg["hidden"])
        if mdl is mlp:
            kw["lookback"] = lookback
        params = mdl.init_params(jax.random.PRNGKey(seed), n_features, **kw)
        if verbose:
            print(f"[{client_id}] fresh model")

    opt = optax.adam(float(cfg.get("learning_rate", 1e-3)))
    opt_state = opt.init(params)

    @jax.jit
    def train_step(params, opt_state, x, y, rng):
        (loss, mse), grads = jax.value_and_grad(_loss_fn, has_aux=True)(
            params, x, y, rng, True, mdl)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, mse

    @jax.jit
    def eval_mse(params, x, y):
        pred = mdl.forward(params, x, train=False)
        return jnp.mean((pred - y) ** 2)

    batch = int(cfg.get("batch_size", 32))
    epochs = int(cfg.get("epochs", 100))
    patience = int(cfg.get("patience", 4))
    rng = jax.random.PRNGKey(seed + 1)
    nb = max(1, len(X_tr) // batch)
    # pad the train set to a whole number of fixed-size batches (static shapes)
    pad = nb * batch - len(X_tr) % (nb * batch) if len(X_tr) % (nb * batch) else 0

    history = {"loss": [], "val_loss": []}
    best_val, best_params, best_epoch = np.inf, params, -1
    for epoch in range(epochs):
        rng, shuf, drop = jax.random.split(rng, 3)
        order = np.asarray(jax.random.permutation(shuf, len(X_tr)))
        ep_losses = []
        for b in range(nb):
            sel = order[b * batch : (b + 1) * batch]
            if len(sel) < batch:
                continue
            drop, sub = jax.random.split(drop)
            params, opt_state, mse = train_step(params, opt_state, X_tr[sel], y_tr[sel], sub)
            ep_losses.append(float(mse))
        vl = float(eval_mse(params, X_val, y_val)) if len(X_val) else float(np.mean(ep_losses))
        history["loss"].append(float(np.mean(ep_losses)))
        history["val_loss"].append(vl)
        if vl < best_val - 1e-12:
            best_val, best_params, best_epoch = vl, params, epoch
            if log_dir:  # best-checkpoint (ModelCheckpoint equivalent)
                _save_ckpt(best_params,
                           os.path.join(log_dir, f"{client_id}_best_{ts_tag}.npz"),
                           model=cfg.get("model", "gru"))
        if epoch - best_epoch >= patience:
            break
    params = best_params

    def inv(p):
        return tscl.inverse(np.asarray(p).reshape(-1, 1)).flatten()

    pred_tr = inv(mdl.forward(params, jnp.asarray(X_tr)))
    yt = inv(y_tr)
    metrics = {"train": calc_metrics(yt, pred_tr, yt.mean())}
    if len(X_val):
        pred_val = inv(mdl.forward(params, jnp.asarray(X_val)))
        yv = inv(y_val)
        metrics["val"] = calc_metrics(yv, pred_val, yv.mean())
    if verbose:
        print(f"[{client_id}] epochs={len(history['loss'])} metrics={metrics}")

    weights_path = cfg.get("INPUT_WEIGHTS_PATH")
    if weights_path:
        with open(weights_path, "w") as f:
            json.dump({"weights_summary": gru.params_to_summary(params)}, f)
    if cfg.get("model_file"):
        _save_ckpt(params, cfg["model_file"], model=cfg.get("model", "gru"))
    if log_dir:
        _plot_loss(history, client_id, os.path.join(log_dir, f"{client_id}_loss_curve_{ts_tag}.png"))
    return TrainResult(params=params, history=history, metrics=metrics,
                       weights_path=weights_path)


def _save_ckpt(params, path: str, model: str = "gru") -> None:
    if not path.endswith(".npz"):
        path = path + ".npz" if "." not in os.path.basename(path) else path
    # __model__ records the family so offline evaluation (evaluate.py) can
    # dispatch the right forward() — an lstm ckpt fed to gru.forward would
    # produce garbage, not an error (params are an untyped list).
    np.savez(path, *[np.asarray(p) for p in params], __model__=np.array(model))


def load_ckpt(path: str) -> List[jnp.ndarray]:
    z = np.load(path)
    return [jnp.asarray(z[k]) for k in z.files if not k.startswith("__")]


def load_ckpt_meta(path: str) -> str | None:
    """Model-family tag of a checkpoint ('gru'/'lstm'/…), or None for
    pre-tag checkpoints."""
    z = np.load(path)
    return str(z["__model__"]) if "__model__" in z.files else None


def _plot_loss(history, client_id, path):
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return
    plt.figure(figsize=(8, 5))
    plt.plot(history["loss"], label="Train Loss")
    plt.plot(history["val_loss"], label="Validation Loss")
    plt.xlabel("Epochs")
    plt.ylabel("Loss (MSE)")
    plt.title(f"Training Loss Curve - {client_id}")
    plt.legend()
    plt.grid(True)
    plt.savefig(path, dpi=100, bbox_inches="tight")
    plt.close()


def evaluate_on_test(params, cfg: Dict) -> Dict[str, float]:
    """Test-split metrics (the c_evalulate_rounds.py per-round evaluation)."""
    lookback = int(cfg.get("lookback", 72))
    df = D.load_timeseries(cfg["data_file"],
                           dayfirst=bool(cfg.get("timestamp_dayfirst", True)))
    train_df, test_df = D.train_test_frames(df, cfg["train_end_date"], cfg["test_start_date"])
    fs = D.Scaler().fit(train_df.matrix(D.FEATURE_NAMES))
    tscl = D.Scaler().fit(train_df.matrix([D.TARGET]))
    Xt, yt = D.prepare_sequences(test_df, lookback, fs, tscl)
    if not len(Xt):
        return {}
    mdl = MODEL_FAMILIES[cfg.get("model", "gru")]
    pred = tscl.inverse(np.asarray(mdl.forward(params, jnp.asarray(Xt))).reshape(-1, 1)).flatten()
    truth = tscl.inverse(np.asarray(yt).reshape(-1, 1)).flatten()
    return calc_metrics(truth, pred, truth.mean())

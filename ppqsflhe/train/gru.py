"""Pure-JAX GRU forecaster with Keras-compatible weight layout.

Replaces the reference's Keras model (client/src/c_trainAndUpdate.py:47-56:
GRU(64, return_sequences) → Dropout(0.3) → GRU(64) → Dropout(0.3) → Dense(1),
l2(0.01) on the first GRU kernel). The parameter list layout matches
``keras.Model.get_weights()`` exactly — kernel (F, 3H) with gate order
[z, r, h], recurrent kernel (H, 3H), bias (2, 3H) input/recurrent halves,
reset_after=True semantics — so exported weight JSONs carry the reference's
tensor shapes ([7,192],[64,192],[2,192],[64,192],[64,192],[2,192],[64,1],[1]
for the 7-feature config; SURVEY.md §2.3 — 39,041 params).

The time dimension runs under ``lax.scan`` (static length, no Python loop
inside jit); each step's gates are one (B,F)x(F,3H) matmul.
"""

from __future__ import annotations

from typing import List

import jax
import jax.numpy as jnp
import numpy as np

HIDDEN = 64


def _glorot(key, shape):
    limit = np.sqrt(6.0 / (shape[0] + shape[1]))
    return jax.random.uniform(key, shape, jnp.float32, -limit, limit)


def _orthogonal(key, shape):
    """Keras recurrent initializer: per-gate orthogonal blocks."""
    h, w = shape
    blocks = []
    n_blocks = w // h
    keys = jax.random.split(key, n_blocks)
    for k in keys:
        a = jax.random.normal(k, (h, h), jnp.float32)
        q, r = jnp.linalg.qr(a)
        q = q * jnp.sign(jnp.diag(r))
        blocks.append(q)
    return jnp.concatenate(blocks, axis=1)


def init_params(key, n_features: int, hidden: int = HIDDEN) -> List[jnp.ndarray]:
    """[W1, U1, b1, W2, U2, b2, Wd, bd] — Keras get_weights() order."""
    k = jax.random.split(key, 5)
    return [
        _glorot(k[0], (n_features, 3 * hidden)),
        _orthogonal(k[1], (hidden, 3 * hidden)),
        jnp.zeros((2, 3 * hidden), jnp.float32),
        _glorot(k[2], (hidden, 3 * hidden)),
        _orthogonal(k[3], (hidden, 3 * hidden)),
        jnp.zeros((2, 3 * hidden), jnp.float32),
        _glorot(k[4], (hidden, 1)),
        jnp.zeros((1,), jnp.float32),
    ]


def _gru_cell(h, x, W, U, b, hidden):
    """Keras GRU cell, reset_after=True, gate order [z, r, hh]."""
    xw = x @ W + b[0]
    hu = h @ U + b[1]
    xz, xr, xh = xw[:, :hidden], xw[:, hidden : 2 * hidden], xw[:, 2 * hidden :]
    hz, hr, hh = hu[:, :hidden], hu[:, hidden : 2 * hidden], hu[:, 2 * hidden :]
    z = jax.nn.sigmoid(xz + hz)
    r = jax.nn.sigmoid(xr + hr)
    cand = jnp.tanh(xh + r * hh)
    return z * h + (1.0 - z) * cand


def gru_layer(params3, x_seq, return_sequences: bool, hidden: int = HIDDEN):
    """x_seq: (B, T, F) → (B, T, H) or (B, H). Time under lax.scan."""
    W, U, b = params3
    B = x_seq.shape[0]
    h0 = jnp.zeros((B, hidden), x_seq.dtype)

    def step(h, x_t):
        h2 = _gru_cell(h, x_t, W, U, b, hidden)
        return h2, h2

    xs = jnp.swapaxes(x_seq, 0, 1)  # (T, B, F)
    h_last, hs = jax.lax.scan(step, h0, xs)
    if return_sequences:
        return jnp.swapaxes(hs, 0, 1)
    return h_last


def forward(params: List[jnp.ndarray], x, *, train: bool = False,
            dropout_rate: float = 0.3, rng=None, hidden: int | None = None):
    """(B, T, F) → (B,) predictions. ``hidden`` is inferred from the
    recurrent kernel (H, 3H) unless given."""
    if hidden is None:
        hidden = params[1].shape[0]
    h = gru_layer(params[0:3], x, True, hidden)
    if train and dropout_rate > 0:
        rng, sub = jax.random.split(rng)
        keep = jax.random.bernoulli(sub, 1 - dropout_rate, h.shape)
        h = jnp.where(keep, h / (1 - dropout_rate), 0.0)
    h = gru_layer(params[3:6], h, False, hidden)
    if train and dropout_rate > 0:
        rng, sub = jax.random.split(rng)
        keep = jax.random.bernoulli(sub, 1 - dropout_rate, h.shape)
        h = jnp.where(keep, h / (1 - dropout_rate), 0.0)
    return (h @ params[6] + params[7])[:, 0]


def params_to_summary(params) -> list:
    """model.get_weights() → weights_summary records (c_trainAndUpdate.py
    :175-190: layer=param_{idx}, shape, mean, std_dev, flat values)."""
    out = []
    for idx, arr in enumerate(params):
        a = np.asarray(arr, np.float32)
        out.append({
            "layer": f"param_{idx}",
            "shape": list(a.shape),
            "mean": float(a.mean()),
            "std_dev": float(a.std()),
            "values": [float(x) for x in a.flatten()],
        })
    return out


def summary_to_params(summary: list) -> List[jnp.ndarray]:
    """reconstruct_model_from_json equivalent (c_trainAndUpdate.py:65-78)."""
    return [
        jnp.asarray(np.asarray(e["values"], np.float32).reshape(e["shape"]))
        for e in summary
    ]

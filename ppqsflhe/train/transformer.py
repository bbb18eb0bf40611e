"""Pure-JAX transformer-encoder forecaster (fourth model family).

The reference trains only a Keras GRU (c_trainAndUpdate.py:47-56); this
family exists because attention is the matmul-shaped sequence model — every
hot op is a dense matmul (QKV projections, attention scores, FFN) instead of
the GRU's sequential scan. Same plug-in contract as gru/lstm/mlp:
``init_params(key, n_features, hidden)`` → flat param list in Keras dense
layout (kernel (in, out), bias (out,)), ``forward(params, x)`` → (B,)
predictions — so weights_summary export, encrypted FedAvg and warm-start
work unchanged.

Architecture: Dense embed → sinusoidal positions → N_LAYERS ×
(pre-LN multi-head self-attention + pre-LN FFN, residuals) → last-token
Dense(1) head.
"""

from __future__ import annotations

from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from .gru import _glorot

HIDDEN = 64          # d_model
N_LAYERS = 2
N_HEADS = 4
FFN_MULT = 2

# per-layer param slots (after the 2 embed params):
#   Wq, Wk, Wv, Wo, bo, W1, b1, W2, b2, g1, be1, g2, be2
_PER_LAYER = 13


def init_params(key, n_features: int, hidden: int = HIDDEN,
                n_layers: int = N_LAYERS) -> List[jnp.ndarray]:
    d = int(hidden)
    keys = jax.random.split(key, 2 + 6 * n_layers)
    ki = iter(range(len(keys)))
    params: List[jnp.ndarray] = [
        _glorot(keys[next(ki)], (n_features, d)), jnp.zeros((d,), jnp.float32),
    ]
    for _ in range(n_layers):
        params += [
            _glorot(keys[next(ki)], (d, d)),               # Wq
            _glorot(keys[next(ki)], (d, d)),               # Wk
            _glorot(keys[next(ki)], (d, d)),               # Wv
            _glorot(keys[next(ki)], (d, d)),               # Wo
            jnp.zeros((d,), jnp.float32),                  # bo
            _glorot(keys[next(ki)], (d, FFN_MULT * d)),    # W1
            jnp.zeros((FFN_MULT * d,), jnp.float32),       # b1
            _glorot(keys[next(ki)], (FFN_MULT * d, d)),    # W2
            jnp.zeros((d,), jnp.float32),                  # b2
            jnp.ones((d,), jnp.float32),                   # ln1 scale
            jnp.zeros((d,), jnp.float32),                  # ln1 bias
            jnp.ones((d,), jnp.float32),                   # ln2 scale
            jnp.zeros((d,), jnp.float32),                  # ln2 bias
        ]
    kh = jax.random.split(keys[-1])
    params += [_glorot(kh[0], (d, 1)), jnp.zeros((1,), jnp.float32)]
    return params


def _positions(t: int, d: int):
    pos = np.arange(t)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * i / d)
    pe = np.zeros((t, d), np.float32)
    pe[:, 0::2] = np.sin(ang)
    pe[:, 1::2] = np.cos(ang)
    return jnp.asarray(pe)


def _layernorm(x, scale, bias, eps: float = 1e-5):
    mu = x.mean(-1, keepdims=True)
    var = ((x - mu) ** 2).mean(-1, keepdims=True)
    return (x - mu) / jnp.sqrt(var + eps) * scale + bias


def _mha(x, Wq, Wk, Wv, Wo, bo, n_heads: int):
    b, t, d = x.shape
    hd = d // n_heads

    def split(z):  # (b, t, d) → (b, heads, t, hd)
        return z.reshape(b, t, n_heads, hd).transpose(0, 2, 1, 3)

    q, k, v = split(x @ Wq), split(x @ Wk), split(x @ Wv)
    att = jax.nn.softmax(q @ k.transpose(0, 1, 3, 2) / jnp.sqrt(float(hd)), axis=-1)
    out = (att @ v).transpose(0, 2, 1, 3).reshape(b, t, d)
    return out @ Wo + bo


def forward(params: List[jnp.ndarray], x, *, train: bool = False,
            rng=None, dropout_rate: float = 0.1, **_):
    """x: (B, lookback, F) → (B,) prediction."""
    h = x @ params[0] + params[1]
    h = h + _positions(h.shape[1], h.shape[2])
    n_layers = (len(params) - 4) // _PER_LAYER
    for li in range(n_layers):
        p = params[2 + li * _PER_LAYER : 2 + (li + 1) * _PER_LAYER]
        Wq, Wk, Wv, Wo, bo, W1, b1, W2, b2, g1, be1, g2, be2 = p
        a = _mha(_layernorm(h, g1, be1), Wq, Wk, Wv, Wo, bo, N_HEADS)
        if train and rng is not None:
            rng, sub = jax.random.split(rng)
            keep = jax.random.bernoulli(sub, 1 - dropout_rate, a.shape)
            a = jnp.where(keep, a / (1 - dropout_rate), 0.0)
        h = h + a
        f = _layernorm(h, g2, be2)
        f = jax.nn.relu(f @ W1 + b1) @ W2 + b2
        if train and rng is not None:
            rng, sub = jax.random.split(rng)
            keep = jax.random.bernoulli(sub, 1 - dropout_rate, f.shape)
            f = jnp.where(keep, f / (1 - dropout_rate), 0.0)
        h = h + f
    return (h[:, -1, :] @ params[-2] + params[-1])[:, 0]


def num_params(params) -> int:
    return int(sum(np.asarray(p).size for p in params))

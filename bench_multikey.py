#!/usr/bin/env python
"""BASELINE.json config 5: full multikey FL round — 16 clients × 1M-param
LSTM weights: PRE every non-hub client into the hub domain, homomorphic
FedAvg, PRE the aggregate back to every client. Reports
encrypted-aggregation rounds/sec on the GPU.

The plaintext payload is the stacked-LSTM export (train/lstm.py, 1,091,101
parameters → 138 value + 16 scalar ciphertexts per client at batch 8192).

- One process on the GPU: key generation and encryption are set-up, then
  rekeys and ciphertext stacks stay device-resident and the round is ONE
  jit built from two lax.scans over the client axis (a keyswitch body
  compiles once, not 30 times).
- Each timed round ends in ``block_until_ready``; the value is the median.
- The round's aggregate is decrypted against the plaintext payload.

    python bench_multikey.py [--clients C]

Prints ONE JSON line {"metric", "value", "unit", "clients", "params", ...}.
"""

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

# Lazy level management (bench.py): LevelReduce one limb on entry (inbound
# switches at l=2), free ÷C for power-of-two client counts (1/C encoded at
# scale C is the constant 1 — pure scale metadata), then LevelReduce again
# so the C−1 outbound switches run at l=1. PPQSFLHE_BENCH_LAZY=0 restores
# the reference full-level schedule.
LAZY = int(os.environ.get("PPQSFLHE_BENCH_LAZY", "1") or 0)
ROUNDS = 5


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--clients", type=int, default=16)
    args = ap.parse_args()
    C = args.clients

    import jax
    import jax.numpy as jnp
    import numpy as np

    import ppqsflhe  # noqa: F401
    from bench import device_info
    from ppqsflhe.ckks import eval as ev
    from ppqsflhe.ckks.params import CkksParams
    from ppqsflhe.ckks.scheme import CkksScheme
    from ppqsflhe.ckks.types import Ciphertext, KeySwitchKey
    from ppqsflhe.core.modarith import modadd
    from ppqsflhe.fl.api import _encrypt_batch
    from ppqsflhe.train import gru, lstm

    dev, info = device_info()
    print(f"[mk] device: {info}", file=sys.stderr)
    sch = CkksScheme(CkksParams.generate(n=1 << 14, mult_depth=2,
                                         scale_bits=40, dnum=2))
    slots = sch.encoder.slots
    params = lstm.init_params(jax.random.PRNGKey(0), 7)
    n_params = lstm.num_params(params)
    vecs = []
    for e in gru.params_to_summary(params):
        vals = np.asarray(e["values"], np.float64)
        vecs += [np.array([e["mean"]]), np.array([e["std_dev"]])]
        vecs += [vals[c * slots : (c + 1) * slots]
                 for c in range(max(1, -(-vals.size // slots)))]
    B = len(vecs)

    t0 = time.time()
    k0 = jax.random.PRNGKey(99)
    keys = [sch.keygen(jax.random.fold_in(k0, i)) for i in range(C)]
    hub_sk, hub_pk = keys[C - 1]
    # long-lived rekeys in Montgomery form (ev.ksk_to_mont)
    rk_to = jnp.stack([ev.ksk_to_mont(sch.ctx, sch.rekey_gen(
        keys[i][0], hub_pk, jax.random.fold_in(k0, 1000 + i))).data
        for i in range(C - 1)])
    rk_from = jnp.stack([ev.ksk_to_mont(sch.ctx, sch.rekey_gen(
        hub_sk, keys[i][1], jax.random.fold_in(k0, 2000 + i))).data
        for i in range(C - 1)])
    L = sch.params.num_q
    l_in = max(1, L - 1) if LAZY else L
    stacks = jnp.stack([jnp.stack([jnp.asarray(c.data[:, :l_in]) for c in
                                   _encrypt_batch(sch, keys[i][1], vecs,
                                                  jax.random.fold_in(k0, 3000 + i))])
                        for i in range(C)])              # (C, B, 2, l, N)
    jax.block_until_ready((stacks, rk_to, rk_from))
    scale = sch.params.scale
    print(f"[mk] set-up: {n_params} params → {B} cts/client × {C} clients, "
          f"{stacks.nbytes / 1e9:.2f} GB of ciphertexts, {time.time() - t0:.1f}s",
          file=sys.stderr)

    free_div = LAZY and (C & (C - 1)) == 0
    out_scale = scale * C if free_div else scale

    def re_enc(d_stack, rk, l):
        """(B, 2, l, N) PRE under one rekey — vmapped keyswitch."""
        q, _, _ = sch.ctx.limb_consts(sch.ctx.q_idx(l))

        def one(d):
            d0, d1 = ev.keyswitch(sch.ctx, d[1], KeySwitchKey(data=rk, mont=True), l)
            return jnp.stack([modadd(d[0], d0, q), d1])

        return jax.vmap(one)(d_stack)

    def server_round(stacks, k_to, k_from):
        """The full C-client round: scan over clients (ONE keyswitch body
        per direction compiles, not C−1)."""
        q, _, _ = sch.ctx.limb_consts(sch.ctx.q_idx(l_in))

        def body_in(acc, xs):
            d, rk = xs
            return jax.vmap(lambda a, b: modadd(a, b, q))(
                acc, re_enc(d, rk, l_in)), None

        acc, _ = jax.lax.scan(body_in, stacks[C - 1], (stacks[: C - 1], k_to))
        if free_div:
            avg = acc                          # ÷C is scale metadata
        else:
            avg = jax.vmap(lambda a: ev.mult_scalar(
                sch.ctx, Ciphertext(a, scale), 1.0 / C).data)(acc)
        if LAZY and avg.shape[-2] > 1:
            avg = avg[..., :-1, :]             # free LevelReduce → l=1
        l_out = avg.shape[-2]
        _, outs = jax.lax.scan(lambda _, rk: (None, re_enc(avg, rk, l_out)),
                               None, k_from)
        return avg, outs                       # (B,2,l',N), (C-1,B,2,l',N)

    t0 = time.time()
    compiled = jax.jit(server_round).lower(stacks, rk_to, rk_from).compile()
    print(f"[mk] compile {time.time() - t0:.1f}s", file=sys.stderr)
    agg, _ = jax.block_until_ready(compiled(stacks, rk_to, rk_from))
    times = []
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(stacks, rk_to, rk_from))
        times.append(time.perf_counter() - t0)
    sec = float(np.median(times))
    print(f"[mk] median {sec:.4f} s/round over {ROUNDS}; peak_bytes_in_use "
          f"{(dev.memory_stats() or {}).get('peak_bytes_in_use')}", file=sys.stderr)

    got = sch.decrypt(hub_sk, Ciphertext(agg[2], scale=out_scale), num=8)
    err = float(np.abs(np.asarray(got) - vecs[2][:8]).max())
    print(f"[mk] decrypt max abs error {err:.2e}", file=sys.stderr)
    if err > 1e-3:
        raise SystemExit(f"bench_multikey: aggregate decrypts with error {err:.2e}")
    print(json.dumps({
        "metric": "multikey_fl_rounds_per_sec", "value": 1.0 / sec,
        "unit": "rounds/s", "clients": C, "params": int(n_params),
        "round_seconds": sec, "err": err, "device": info,
    }))


if __name__ == "__main__":
    main()

#!/usr/bin/env python
"""Smoke run of the encrypted federated-learning round on one GPU.

    python chip_smoke.py            # one card: kernels + the orchestrated round
    python chip_smoke.py --four     # four cards: the multi-card paths only

Phases (any failure raises and the script exits non-zero):

1. device: the first JAX device must be a GPU; prints its kind and the
   ``nvidia-smi`` name and power limit.
2. kernels: each portable NTT path (radix2/xla, fourstep/xla, fourstep/mxu)
   at N=2^14 on the reference QP chain and at N=2^16 on a chain of the same
   shape, and one full-level key switch, compiled for the GPU and compared
   bit for bit with the same call on the CPU backend of this process, plus
   intt(ntt(x)) == x. Integer residues get no tolerance.
3. round: ``ppqsflhe.orchestration.cli.main`` drives 2 clients with the
   reference GRU(64)x2 (39,041 parameters, 2 epochs on hourly CSVs made from
   ``--seed``) through 2 PRE rounds over the in-process HTTP server at the
   CC of configs/config_cc.json, then one threshold-protocol round. Every
   client's decrypted global is checked against the plaintext FedAvg of the
   clients' uploaded weight files, and the GRU forward on the GPU against the
   CPU forward at highest matmul precision.

The last stdout line is one JSON object naming the device:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

# the CPU backend is the reference for the kernel comparisons, so keep it
# beside the GPU when the platform list is pinned
_platforms = os.environ.get("JAX_PLATFORMS", "")
if _platforms and "cpu" not in _platforms.split(","):
    os.environ["JAX_PLATFORMS"] = _platforms + ",cpu"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import ppqsflhe  # noqa: E402,F401  (enables x64 and the compile cache)
from ppqsflhe.ckks import eval as ev  # noqa: E402
from ppqsflhe.ckks.params import CkksContext, CkksParams  # noqa: E402
from ppqsflhe.ckks.types import KeySwitchKey  # noqa: E402

NTT_PATHS = (("radix2", "xla"), ("fourstep", "xla"), ("fourstep", "mxu"))
# PRE decryption error at Δ=2^40 is ~1e-7; FedAvg must hold to 1e-6.
PRE_TOL = 1e-6
# The GPU runs float32 matmuls in TF32 by default (10-bit mantissa, relative
# rounding 2^-11 per operand). Over the GRU's 72 recurrent steps that leaves
# errors of order 1e-3 on outputs of order 1, which a limit of 1e-2 relative
# to the output scale admits with margin; the CPU reference runs at
# "highest" precision (true float32).
GRU_RTOL = 1e-2


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# ---------------------------------------------------------------------------
# device
# ---------------------------------------------------------------------------

def device_phase(count: int) -> jax.Device:
    devs = jax.devices()
    check(devs[0].platform == "gpu",
          f"no GPU: JAX's first device is {devs[0].platform!r}")
    check(len(devs) >= count, f"need {count} GPUs, JAX has {len(devs)}")
    log(f"device: {devs[0].device_kind} x{len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    return devs[0]


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def _compile(fn, x, what: str):
    t0 = time.time()
    compiled = jax.jit(fn).lower(x).compile()
    log(f"{what}: compiled in {time.time() - t0:.1f}s; "
        f"memory {compiled.memory_analysis()}")
    return compiled


def _same(a, b, what: str) -> None:
    a, b = np.asarray(a), np.asarray(b)
    check(a.shape == b.shape and np.array_equal(a, b),
          f"{what}: {int(np.sum(a != b)) if a.shape == b.shape else 'shape'} "
          f"residues differ")


def _residues(moduli, shape, rng) -> np.ndarray:
    """uint64 residues of shape (..., len(moduli), n), limb i below q_i."""
    q = np.asarray(moduli, np.uint64)[:, None]
    return rng.integers(0, 1 << 62, size=shape, dtype=np.uint64) % q


def kernel_phase(ns, dev, ref_dev, batch: int = 8, seed: int = 0) -> None:
    """Every portable NTT path and one full-level key switch on ``dev``,
    bit-equal to the same call on ``ref_dev``."""
    rng = np.random.default_rng(seed)
    for n in ns:
        base = CkksParams.reference_shaped(n)
        for backend, impl in NTT_PATHS:
            ctx = CkksContext(dataclasses.replace(
                base, ntt_backend=backend, ntt_impl=impl))
            idx = tuple(range(len(ctx.moduli_qp)))
            x = _residues(ctx.moduli_qp, (batch, len(idx), n), rng)
            what = f"N=2^{n.bit_length() - 1} {backend}/{impl} L+K={len(idx)}"
            fwd = _compile(lambda a: ctx.ntt(a, idx), jax.device_put(x, dev),
                           f"{what} ntt")
            inv = _compile(lambda a: ctx.intt(a, idx), jax.device_put(x, dev),
                           f"{what} intt")
            y = fwd(jax.device_put(x, dev))
            _same(y, jax.jit(lambda a: ctx.ntt(a, idx))(jax.device_put(x, ref_dev)),
                  f"{what} ntt vs {ref_dev.platform}")
            back = inv(y)
            _same(back, x, f"{what} intt(ntt(x))")
            _same(back, jax.jit(lambda a: ctx.intt(a, idx))(
                jax.device_put(np.asarray(y), ref_dev)),
                f"{what} intt vs {ref_dev.platform}")
            log(f"{what}: ntt, intt bit-equal to {ref_dev.platform}; "
                "intt(ntt(x)) == x")
    keyswitch_check(CkksParams.reference_shaped(ns[0]), dev, ref_dev, rng)


def keyswitch_check(params: CkksParams, dev, ref_dev, rng, batch: int = 4):
    """One full-level hybrid key switch (decompose, extend, inner product
    with a Montgomery-form key, ModDown) on a batch of ciphertext halves."""
    ctx = CkksContext(params)
    L = params.num_q
    c = _residues(params.q_moduli, (batch, L, params.n), rng)
    ksk = _residues(ctx.moduli_qp, (len(ctx.digit_groups), 2,
                                    len(ctx.moduli_qp), params.n), rng)

    def switch(c, k):
        key = ev.ksk_to_mont(ctx, KeySwitchKey(data=k))
        return jax.vmap(lambda ci: jnp.stack(ev.keyswitch(ctx, ci, key, L)))(c)

    what = f"N=2^{params.n.bit_length() - 1} keyswitch L={L} dnum={params.dnum}"
    t0 = time.time()
    compiled = jax.jit(switch).lower(jax.device_put(c, dev),
                                     jax.device_put(ksk, dev)).compile()
    log(f"{what}: compiled in {time.time() - t0:.1f}s; "
        f"memory {compiled.memory_analysis()}")
    got = compiled(jax.device_put(c, dev), jax.device_put(ksk, dev))
    want = jax.jit(switch)(jax.device_put(c, ref_dev), jax.device_put(ksk, ref_dev))
    _same(got, want, f"{what} vs {ref_dev.platform}")
    log(f"{what}: bit-equal to {ref_dev.platform}")


# ---------------------------------------------------------------------------
# the orchestrated round
# ---------------------------------------------------------------------------

def write_hourly_csv(path: str, hours: int, seed: int) -> None:
    """Hourly readings with a daily cycle, day-first timestamps like the
    reference datasets."""
    from datetime import datetime, timedelta

    rng = np.random.default_rng(seed)
    t0 = datetime(2024, 7, 1)
    with open(path, "w") as f:
        f.write("Timestamp,Data\n")
        for h in range(hours):
            v = 100 + 20 * np.sin(2 * np.pi * (h % 24) / 24) + rng.normal(0, 2)
            f.write(f"{(t0 + timedelta(hours=h)).strftime('%d-%m-%Y %H:%M')},{float(v)!r}\n")


def _summary(path: str) -> list:
    with open(path) as f:
        return json.load(f)["weights_summary"]


def fedavg_error(work_dir: str, n_clients: int) -> float:
    """Max |decrypted global − mean of uploaded weights| over every client,
    layer, value, mean and std_dev."""
    ups = [_summary(os.path.join(work_dir, f"client_{i}", "weights.json"))
           for i in range(1, n_clients + 1)]
    err = 0.0
    for i in range(1, n_clients + 1):
        dec = _summary(os.path.join(work_dir, f"client_{i}",
                                    "decrypted_weights.json"))
        check(len(dec) == len(ups[0]), f"client_{i}: {len(dec)} layers")
        for k, rec in enumerate(dec):
            for field in ("values", "mean", "std_dev"):
                want = np.mean([np.asarray(u[k][field], np.float64) for u in ups],
                               axis=0)
                got = np.asarray(rec[field], np.float64)
                check(got.shape == want.shape, f"client_{i} layer {k} {field} shape")
                err = max(err, float(np.max(np.abs(got - want))))
    return err


def threshold_tolerance(n: int, n_clients: int, smudging_bits: int,
                        scale_bits: int) -> float:
    """Eight standard deviations of the slot error that the parties'
    uniform ±2^smudging_bits flooding adds to a fused decryption."""
    var_coeff = n_clients * (2.0 ** (2 * smudging_bits)) / 3.0
    return 8.0 * float(np.sqrt(n / 2 * var_coeff)) / 2.0 ** scale_bits


def run_cli(cfg: dict, path: str, resume: bool = False) -> list:
    """One call of the orchestrator CLI; returns its per-round results."""
    from ppqsflhe.orchestration.cli import main

    with open(path, "w") as f:
        json.dump(cfg, f)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main([path] + (["--resume"] if resume else []))
    text = out.getvalue()
    print(text, end="", flush=True)
    check(rc == 0, f"orchestrator exited {rc}")
    return json.loads(text.strip().splitlines()[-1])


def round_phase(work: str, cc_config: dict, dev, ref_dev, *, seed: int = 0,
                hours: int = 31 * 24, epochs: int = 2, lookback: int = 72,
                pre_rounds: int = 2) -> None:
    """The main path end to end: PRE rounds, then one threshold round."""
    from ppqsflhe.ckks import threshold as th
    from ppqsflhe.train import gru

    n_clients = 2
    clients = []
    for i in range(1, n_clients + 1):
        csv = os.path.join(work, f"client{i}_training_data.csv")
        write_hourly_csv(csv, hours, seed + i)
        clients.append({
            "client_id": f"client_{i}", "data_file": csv,
            "train_end_date": "2024-07-24 23:00:00",
            "test_start_date": "2024-07-25 00:00:00",
            "lookback": lookback, "n_features": 6, "epochs": epochs,
            "patience": 4,
        })
    base = {"N_CLIENTS": n_clients, "COMM_MODE": "MONGOOSE",
            "SERVER_IP": "127.0.0.1", "SERVER_PORT": 0, "SEED": seed,
            "TRAIN": True, "LAZY_LEVELS": True, "FAIL_FAST": True,
            "CC_CONFIG": cc_config, "CLIENT_CONFIGS": clients}

    pre = dict(base, PROTOCOL="pre", WORK_DIR=os.path.join(work, "pre"))
    for r in range(1, pre_rounds + 1):
        res = run_cli(dict(pre, ROUNDS=r), os.path.join(work, "pre.json"),
                      resume=r > 1)
        err = fedavg_error(pre["WORK_DIR"], n_clients)
        log(f"PRE round {r}: {res[-1]['seconds']:.3f}s wall; FedAvg max abs "
            f"error {err:.3e} (limit {PRE_TOL:g}); peak_bytes_in_use "
            f"{_peak_bytes(dev)}")
        check(err <= PRE_TOL, f"PRE round {r}: FedAvg error {err:.3e}")

    thr = dict(base, PROTOCOL="threshold", ROUNDS=1,
               WORK_DIR=os.path.join(work, "threshold"))
    res = run_cli(thr, os.path.join(work, "threshold.json"))
    err = fedavg_error(thr["WORK_DIR"], n_clients)
    tol = threshold_tolerance(int(cc_config["ring_dim"]), n_clients,
                              th.DEFAULT_SMUDGING_BITS,
                              int(cc_config["scaling_mod_size"]))
    log(f"threshold round: {res[-1]['seconds']:.3f}s wall; FedAvg max abs "
        f"error {err:.3e} (limit {tol:.3e}: 8 sigma of the "
        f"2^{th.DEFAULT_SMUDGING_BITS} flooding); peak_bytes_in_use "
        f"{_peak_bytes(dev)}")
    check(err <= tol, f"threshold round: FedAvg error {err:.3e}")

    gru_check(gru.summary_to_params(_summary(os.path.join(
        pre["WORK_DIR"], "client_1", "decrypted_weights.json"))),
        lookback, dev, ref_dev, seed)


def gru_check(params, lookback: int, dev, ref_dev, seed: int) -> None:
    """GRU forward on ``dev`` at default precision against ``ref_dev`` at
    highest precision."""
    from ppqsflhe.train import gru

    n_params = sum(int(np.prod(p.shape)) for p in params)
    x = np.random.default_rng(seed).normal(
        size=(64, lookback, params[0].shape[0])).astype(np.float32)
    fwd = jax.jit(lambda p, a: gru.forward(p, a))
    got = np.asarray(fwd(jax.device_put(params, dev), jax.device_put(x, dev)))
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(lambda p, a: gru.forward(p, a))(
            jax.device_put(params, ref_dev), jax.device_put(x, ref_dev)))
    err = float(np.max(np.abs(got - want)))
    limit = GRU_RTOL * max(1.0, float(np.max(np.abs(want))))
    log(f"GRU forward ({n_params} params, batch {x.shape}): max abs diff "
        f"{err:.3e} vs {ref_dev.platform} at highest precision (limit {limit:.3e})")
    check(got.shape == want.shape and np.all(np.isfinite(got)), "GRU output")
    check(err <= limit, f"GRU forward differs by {err:.3e}")


def _peak_bytes(dev) -> int:
    stats = dev.memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", -1))


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------

def _re_encrypt(ctx, d, rekey):
    """changeCipherDomain of one ciphertext's data: c0 + ks(c1)_0, ks(c1)_1."""
    from ppqsflhe.core.modarith import modadd

    l = d.shape[1]
    q, _, _ = ctx.limb_consts(ctx.q_idx(l))
    d0, d1 = ev.keyswitch(ctx, d[1], rekey, l)
    return jnp.stack([modadd(d[0], d0, q), d1])


def four_card_phase(devs, seed: int = 0, n: int = 1 << 14) -> None:
    """The multi-card paths, each bit-equal to its one-card result, at
    ring dimension ``n`` (2^14: the reference chain)."""
    from jax.sharding import Mesh

    from ppqsflhe.ckks.multikey import aggregate_local, aggregate_sharded
    from ppqsflhe.ckks.scheme import CkksScheme
    from ppqsflhe.ckks.types import Ciphertext
    from ppqsflhe.parallel.mesh import make_mesh
    from ppqsflhe.parallel.sharded_scheme import (ShardedEvalContext,
                                                  fedavg_round_sharded)

    rng = np.random.default_rng(seed)
    one = devs[0]

    # client-axis FedAvg: 8 clients x 27 ciphertexts at the reference shape
    params = dataclasses.replace(CkksParams.reference_shaped(n),
                                 ntt_backend="fourstep", ntt_impl="mxu")
    sch = CkksScheme(params)
    n_clients, B, L = 8, 27, params.num_q
    stack = np.stack([_residues(params.q_moduli, (B, 2, L, params.n), rng)
                      for _ in range(n_clients)])
    t0 = time.time()
    agg = aggregate_sharded(sch.ctx, jnp.asarray(stack), make_mesh(
        {"client": 4}, devs[:4]), sch.params.scale, n_clients)
    jax.block_until_ready(agg.data)
    log(f"aggregate_sharded {n_clients}x{B} cts on a 4-card client mesh: "
        f"{time.time() - t0:.1f}s incl. compile; output on "
        f"{len(agg.data.sharding.device_set)} devices")
    check(len(agg.data.sharding.device_set) == 4, "aggregate output devices")
    local = jax.jit(jax.vmap(lambda cts: aggregate_local(
        sch.ctx, [Ciphertext(c, scale=sch.params.scale) for c in cts]).data,
        in_axes=1))(jax.device_put(stack, one))
    _same(agg.data, local, "aggregate_sharded vs one card")
    log("aggregate_sharded: bit-equal to the one-card aggregate_local")

    # client=2 x coef=2 sharded PRE + FedAvg + PRE-back round, impl=mxu, L=4
    mesh = Mesh(np.array(devs[:4]).reshape(2, 2), ("client", "coef"))
    sctx = ShardedEvalContext(params, mesh, axis="coef")
    check(sctx.impl == "mxu", sctx.impl)
    k = jax.random.PRNGKey(seed)
    # key material and inputs are set-up: made on the CPU backend, whose
    # compiles are quick, then handed to the cards
    with jax.default_device(jax.devices("cpu")[0]):
        sk1, pk1 = sch.keygen(jax.random.fold_in(k, 1))
        sk2, pk2 = sch.keygen(jax.random.fold_in(k, 2))
        rk12 = sch.rekey_gen(sk1, pk2, jax.random.fold_in(k, 3))
        rk21 = sch.rekey_gen(sk2, pk1, jax.random.fold_in(k, 4))
        vs = [rng.uniform(-1, 1, sch.encoder.slots) for _ in range(2)]
        ct1 = sch.encrypt_values(pk1, vs[0], jax.random.fold_in(k, 5))
        ct2 = sch.encrypt_values(pk2, vs[1], jax.random.fold_in(k, 6))

    def one_card_round(d1, d2, k12, k21):
        """The same ckks.eval operations as the sharded round."""
        avg = ev.mult_scalar(sch.ctx, ev.add(sch.ctx, Ciphertext(
            _re_encrypt(sch.ctx, d1, KeySwitchKey(data=k12)), ct1.scale),
            Ciphertext(d2, ct1.scale)), 0.5)
        return avg.data, _re_encrypt(sch.ctx, avg.data, KeySwitchKey(data=k21))

    host = [np.asarray(a) for a in (ct1.data, ct2.data, rk12.data, rk21.data)]
    want_agg, want_back = jax.jit(one_card_round)(*jax.device_put(host, one))
    t0 = time.time()
    got_agg, got_back = fedavg_round_sharded(
        sctx, np.stack([host[0][None], host[1][None]]), host[2], host[3],
        ct1.scale)
    jax.block_until_ready((got_agg, got_back))
    log(f"fedavg_round_sharded N=2^{n.bit_length() - 1} L={L} impl=mxu on client=2 x coef=2: "
        f"{time.time() - t0:.1f}s incl. compile; outputs on "
        f"{len(got_agg.sharding.device_set)} and "
        f"{len(got_back.sharding.device_set)} devices")
    check(len(got_agg.sharding.device_set) == 4, "sharded round output devices")
    _same(got_agg[0], want_agg, "fedavg_round_sharded aggregate vs one card")
    _same(got_back[0], want_back, "fedavg_round_sharded PRE-back vs one card")
    with jax.default_device(jax.devices("cpu")[0]):
        got = sch.decrypt(sk2, Ciphertext(np.asarray(got_agg[0]),
                                          scale=ct1.scale))
    err = float(np.max(np.abs(np.asarray(got) - (vs[0] + vs[1]) / 2)))
    check(err <= 1e-4, f"sharded FedAvg decrypts with error {err:.3e}")
    log(f"fedavg_round_sharded: bit-equal to one card; decrypts to the mean "
        f"with max abs error {err:.3e}")


# ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card paths")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    t0 = time.time()
    count = 4 if args.four else 1
    dev = device_phase(count)
    if args.four:
        four_card_phase(jax.devices()[:4], args.seed)
    else:
        cpu = jax.devices("cpu")[0]
        kernel_phase((1 << 14, 1 << 16), dev, cpu, seed=args.seed)
        log(f"kernel phase done at {time.time() - t0:.1f}s")
        with open(os.path.join(REPO, "configs", "config_cc.json")) as f:
            cc_config = json.load(f)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
            round_phase(work, cc_config, dev, cpu, seed=args.seed)
    log(f"all phases passed in {time.time() - t0:.1f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

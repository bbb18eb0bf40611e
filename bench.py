#!/usr/bin/env python
"""Benchmark: the reference's server-side encrypted-aggregation round on a GPU.

Measures the HE hot path of SURVEY.md §3.1 (hot loops #3-#4) with the
reference workload (2 clients × GRU weight payload → 27 ciphertexts each at
N=16384, 4 RNS limbs, Δ=2^40, HYBRID dnum=2):

    PRE client-1 → client-2 domain  (changeCipherDomain, 27 key switches)
    homomorphic FedAvg              (27 × EvalAdd + ÷2)
    PRE aggregate → client-1 domain (27 key switches)

Baseline: the authors' committed run shows this window took ~8 s on their
host (uploads 17:14:26/28 → aggregate served 17:14:35,
orchestration/metrics/comm_metrics.csv rows 10-13; BASELINE.md). vs_baseline
is baseline_ms / our_ms (higher = faster than reference).

One process does everything on the GPU: key generation and encryption
(set-up), the timed rounds, and the decryption check. Each timed round ends
in ``block_until_ready``; the reported value is the median. It fails when
JAX finds no GPU.

    python bench.py [--backend radix2|fourstep] [--impl xla|mxu] [--trace DIR]

``--trace DIR`` also records a profiler trace of a few rounds into DIR and
prints each limb transform's share of the device time. Prints ONE JSON line
last: {"metric", "value", "unit", "vs_baseline", "device", ...}.
"""

import argparse
import glob
import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

BASELINE_SERVER_CRYPTO_MS = 8000.0
N = 1 << 14
ROUNDS = 50
# Lazy level management: LevelReduce — dropping TOP RNS limbs without
# scaling — is a free, exact modulus switch. The round runs PRE at l=2,
# adds, takes ÷2 as scale metadata, drops a limb and runs PRE-back at l=1.
# PPQSFLHE_BENCH_LAZY=0 restores the reference full-level schedule.
LAZY = int(os.environ.get("PPQSFLHE_BENCH_LAZY", "1") or 0)


def device_info():
    """(device, description) of the GPU; raises when JAX has none."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench: no GPU (JAX's first device is {dev.platform})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    return dev, {"platform": dev.platform, "kind": dev.device_kind,
                 "count": len(jax.devices()), "nvidia_smi": smi[0]}


def _payload_vecs(slots, rng):
    """27 vectors shaped like the reference GRU payload: per layer a mean,
    a std and ceil(size/slots) chunks of values."""
    import numpy as np

    sizes = [7 * 192, 64 * 192, 2 * 192, 64 * 192, 64 * 192, 2 * 192, 64, 1]
    vecs = []
    for size in sizes:
        vals = rng.uniform(-0.5, 0.5, size)
        vecs += [np.array([vals.mean()]), np.array([vals.std()])]
        vecs += [vals[c * slots : (c + 1) * slots] for c in range(-(-size // slots))]
    return vecs


def build(backend: str, impl: str):
    """Keys, the two clients' encrypted payloads and the jitted round."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ppqsflhe.ckks import eval as ev
    from ppqsflhe.ckks.params import CkksParams
    from ppqsflhe.ckks.scheme import CkksScheme
    from ppqsflhe.ckks.types import Ciphertext, KeySwitchKey
    from ppqsflhe.core.modarith import modadd
    from ppqsflhe.fl.api import _encrypt_batch

    sch = CkksScheme(CkksParams.generate(n=N, mult_depth=2, scale_bits=40,
                                         dnum=2, ntt_backend=backend,
                                         ntt_impl=impl))
    vecs = _payload_vecs(sch.encoder.slots, np.random.default_rng(0))
    k0 = jax.random.PRNGKey(7)
    sk1, pk1 = sch.keygen(jax.random.fold_in(k0, 1))
    sk2, pk2 = sch.keygen(jax.random.fold_in(k0, 2))
    # rekeys are long-lived: one Montgomery-form conversion halves the
    # per-ciphertext inner-product multiplies (ev.ksk_to_mont)
    rk12 = ev.ksk_to_mont(sch.ctx, sch.rekey_gen(sk1, pk2, jax.random.fold_in(k0, 3))).data
    rk21 = ev.ksk_to_mont(sch.ctx, sch.rekey_gen(sk2, pk1, jax.random.fold_in(k0, 4))).data
    cts1 = _encrypt_batch(sch, pk1, vecs, jax.random.fold_in(k0, 5))
    cts2 = _encrypt_batch(sch, pk2, vecs, jax.random.fold_in(k0, 6))
    stack1 = jnp.stack([jnp.asarray(c.data) for c in cts1])
    stack2 = jnp.stack([jnp.asarray(c.data) for c in cts2])
    scale = cts1[0].scale
    L = sch.params.num_q

    def re_enc(d, rk):
        l = d.shape[1]
        q, _, _ = sch.ctx.limb_consts(sch.ctx.q_idx(l))
        d0, d1 = ev.keyswitch(sch.ctx, d[1], KeySwitchKey(data=rk, mont=True), l)
        return jnp.stack([modadd(d[0], d0, q), d1])

    def agg_pair(d1, d2, k12, k21):
        if LAZY:
            d1, d2 = d1[:, : L - 1], d2[:, : L - 1]   # LevelReduce
        s = ev.add(sch.ctx, Ciphertext(re_enc(d1, k12), scale),
                   Ciphertext(d2, scale))
        if LAZY:
            avg = s.data[:, :-1]                      # ÷2 as metadata + LevelReduce
        else:
            avg = ev.mult_scalar(sch.ctx, s, 0.5).data
        return avg, re_enc(avg, k21)

    def server_round(s1, s2, k12, k21):
        return jax.vmap(agg_pair, in_axes=(0, 0, None, None))(s1, s2, k12, k21)

    out_scale = scale * 2.0 if LAZY else scale
    check = (sch, sk2, vecs, out_scale)
    return jax.jit(server_round), (stack1, stack2, rk12, rk21), check


def decrypt_error(agg, check) -> float:
    import jax.numpy as jnp
    import numpy as np

    from ppqsflhe.ckks.types import Ciphertext

    sch, sk2, vecs, out_scale = check
    err = 0.0
    for b in (0, 2, len(vecs) - 1):
        got = np.asarray(sch.decrypt(sk2, Ciphertext(jnp.asarray(agg[b]),
                                                     scale=out_scale),
                                     num=len(vecs[b])))
        err = max(err, float(np.max(np.abs(got - vecs[b]))))
    return err


def trace_breakdown(trace_dir: str, hlo_text: str) -> dict:
    """Device time per named scope from a profiler trace: each kernel's
    ``hlo_op`` is mapped to the op_name metadata that the compiled module
    gives that instruction, and counted as 'ntt' or 'intt' when that path
    has such a component (``jax.named_scope`` in CkksContext)."""
    from jax.profiler import ProfileData

    scope = {}
    for m in re.finditer(r'%([\w.\-]+) = [^\n]*?metadata=\{op_name="([^"]*)"', hlo_text):
        # a scope under a transformation reads "vmap(ntt)"
        parts = {re.sub(r"^(?:\w+\()*|\)*$", "", p) for p in m.group(2).split("/")}
        scope[m.group(1)] = ("intt" if "intt" in parts
                             else "ntt" if "ntt" in parts else "other")
    path = sorted(glob.glob(os.path.join(trace_dir, "plugins", "profile", "*",
                                         "*.xplane.pb")))[-1]
    totals = {"ntt": 0, "intt": 0, "other": 0, "unmapped": 0}
    spans = []
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:               # one line per stream
            for ev in line.events:
                op = dict(ev.stats).get("hlo_op")
                if op is None:
                    continue
                totals[scope.get(op, "unmapped")] += ev.duration_ns
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    busy, end = 0, None
    for s, e in sorted(spans):                  # union of kernel intervals
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    window = (max(e for _, e in spans) - min(s for s, _ in spans)) if spans else 0
    kernel_ns = sum(totals.values())
    return {"kernel_ns": kernel_ns, "busy_ns": busy, "window_ns": window,
            "idle_share": 1 - busy / window if window else None,
            **{f"{k}_share": v / kernel_ns if kernel_ns else None
               for k, v in totals.items()}}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="radix2", choices=("radix2", "fourstep"))
    ap.add_argument("--impl", default="xla", choices=("xla", "mxu"))
    ap.add_argument("--trace", default=None)
    args = ap.parse_args()

    import jax
    import numpy as np

    import ppqsflhe  # noqa: F401

    dev, info = device_info()
    print(f"[bench] device: {info}", file=sys.stderr)
    t0 = time.time()
    fn, inputs, check = build(args.backend, args.impl)
    jax.block_until_ready(inputs)
    print(f"[bench] set-up (keys + encryption) {time.time() - t0:.1f}s",
          file=sys.stderr)
    t0 = time.time()
    compiled = fn.lower(*inputs).compile()
    print(f"[bench] compile {time.time() - t0:.1f}s; memory "
          f"{compiled.memory_analysis()}", file=sys.stderr)
    agg, _ = jax.block_until_ready(compiled(*inputs))
    times = []
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(*inputs))
        times.append(time.perf_counter() - t0)
    ms = float(np.median(times) * 1e3)
    print(f"[bench] {args.backend}/{args.impl}: median {ms:.3f} ms/round over "
          f"{ROUNDS} (min {min(times) * 1e3:.3f}, max "
          f"{max(times) * 1e3:.3f}); peak_bytes_in_use "
          f"{(dev.memory_stats() or {}).get('peak_bytes_in_use')}",
          file=sys.stderr)
    err = decrypt_error(np.asarray(agg), check)
    print(f"[bench] decrypt max abs error {err:.3e}", file=sys.stderr)
    if err > 1e-3:
        raise SystemExit(f"bench: aggregate decrypts with error {err:.3e}")

    breakdown = None
    if args.trace:
        with jax.profiler.trace(args.trace):
            for _ in range(5):
                jax.block_until_ready(compiled(*inputs))
        breakdown = trace_breakdown(args.trace, compiled.as_text())
        print(f"[bench] trace breakdown: {breakdown}", file=sys.stderr)

    print(json.dumps({
        "metric": "server_encrypted_aggregation_ms_per_round",
        "value": ms, "unit": "ms",
        "vs_baseline": BASELINE_SERVER_CRYPTO_MS / ms,
        "ntt": f"{args.backend}/{args.impl}", "err": err,
        "device": info, "trace": breakdown,
    }))


if __name__ == "__main__":
    main()

#!/usr/bin/env python
"""Galois-rotation / hoisted-keyswitch benchmark at N=2^15 (BASELINE.json
north-star config 3: "Galois rotations + hoisted key-switching for packed
weight-vector inner products, N=2^15").

Measures, on the GPU, R=8 slot rotations of one ciphertext:

  plain    — R independent EvalRotate calls (R full key switches)
  hoisted  — ONE decompose+extend (keyswitch_core) shared by all R
             rotations (eval.rotate_hoisted)
  rot_sum  — the rotations' sum with one deferred ModDown
             (eval.rotate_sum_hoisted)

A rotation is an eval-domain bin permutation (zero NTTs on the ct itself),
so the key switch IS the cost and hoisting removes the per-rotation
decompose+extend — the classic amortization for packed inner products
(scheme.inner_product's rotate-and-add tree).

One process on the GPU: keys and the ciphertext are set-up, each timed call
ends in ``block_until_ready`` (median reported), and the outputs are
decrypted against the rotated plaintext. Prints one JSON line.
"""

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

N = 1 << 15
ROTS = [1, 2, 4, 8, 16, 32, 64, 128]
CALLS = 20


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--impl", default="xla", choices=("xla", "mxu"))
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    import ppqsflhe  # noqa: F401
    from bench import device_info
    from ppqsflhe.ckks import eval as ev
    from ppqsflhe.ckks.params import CkksParams
    from ppqsflhe.ckks.scheme import CkksScheme
    from ppqsflhe.ckks.types import Ciphertext, KeySwitchKey

    _, info = device_info()
    print(f"[bench_rot] device: {info}", file=sys.stderr)
    sch = CkksScheme(CkksParams.generate(
        n=N, mult_depth=2, scale_bits=40, dnum=2, ntt_backend="fourstep",
        ntt_impl=args.impl))
    k = jax.random.PRNGKey(3)
    sk, pk = sch.keygen(jax.random.fold_in(k, 1))
    rot_keys = sch.rotation_key_gen(sk, ROTS, jax.random.fold_in(k, 2))
    v = np.linspace(-1, 1, sch.encoder.slots)
    ct = sch.encrypt_values(pk, v, jax.random.fold_in(k, 3))
    scale = ct.scale
    # long-lived rotation keys → Montgomery form (ev.ksk_to_mont)
    rks = [ev.ksk_to_mont(sch.ctx, rot_keys[r]).data for r in ROTS]

    def plain(ctd, *rkd):
        return jnp.stack([ev.rotate(sch.ctx, Ciphertext(ctd, scale), r,
                                    KeySwitchKey(data=k, mont=True)).data
                          for r, k in zip(ROTS, rkd)])

    def hoisted(ctd, *rkd):
        keys = {r: KeySwitchKey(data=k, mont=True) for r, k in zip(ROTS, rkd)}
        outs = ev.rotate_hoisted(sch.ctx, Ciphertext(ctd, scale), ROTS, keys)
        return jnp.stack([o.data for o in outs])

    def rot_sum(ctd, *rkd):
        keys = {r: KeySwitchKey(data=k, mont=True) for r, k in zip(ROTS, rkd)}
        return ev.rotate_sum_hoisted(sch.ctx, Ciphertext(ctd, scale), ROTS,
                                     keys).data

    results, outs = {}, {}
    for name, fn in (("plain", plain), ("hoisted", hoisted), ("rot_sum", rot_sum)):
        t0 = time.time()
        jf = jax.jit(fn)
        outs[name] = np.asarray(jax.block_until_ready(jf(ct.data, *rks)))
        compile_s = time.time() - t0
        times = []
        for _ in range(CALLS):
            t0 = time.perf_counter()
            jax.block_until_ready(jf(ct.data, *rks))
            times.append(time.perf_counter() - t0)
        results[name] = float(np.median(times)) * 1e6 / len(ROTS)  # µs/rotation
        print(f"[bench_rot] {name}: {results[name]:.1f} µs/rotation "
              f"(compile+first {compile_s:.1f}s)", file=sys.stderr)

    # the plain path must agree bit-exactly with the hoisted one (the
    # automorphism commutes with decompose/extend), so one decrypt check
    # covers both
    plain_matches = bool(np.array_equal(outs["plain"], outs["hoisted"]))
    err = max(float(np.abs(np.asarray(sch.decrypt(
        sk, Ciphertext(jnp.asarray(outs["hoisted"][i]), scale=scale), num=64))
        - np.roll(v, -r)[:64]).max()) for i, r in enumerate(ROTS))
    # rotate_sum's deferred ModDown rounds once for the whole sum, so its
    # residues differ from the sum of ModDowns: check it at slot level
    want = sum(np.roll(v, -r) for r in ROTS)
    err_s = float(np.abs(np.asarray(sch.decrypt(
        sk, Ciphertext(jnp.asarray(outs["rot_sum"]), scale=scale), num=64))
        - want[:64]).max())
    ok = plain_matches and err < 1e-3 and err_s < 1e-2
    print(f"[bench_rot] plain == hoisted: {plain_matches}; hoisted err "
          f"{err:.2e}; rot_sum err {err_s:.2e}", file=sys.stderr)
    if not ok:
        raise SystemExit("bench_rotations: outputs failed the decrypt check")
    print(json.dumps({
        "metric": "hoisted_rotation_us_per_rotation_n32768",
        "value": results["hoisted"], "unit": "us",
        "plain_us": results["plain"], "rot_sum_us": results["rot_sum"],
        "hoisting_speedup": results["plain"] / results["hoisted"],
        "rot_sum_speedup": results["plain"] / results["rot_sum"],
        "err": err, "ntt": f"fourstep/{args.impl}", "device": info,
    }))


if __name__ == "__main__":
    main()

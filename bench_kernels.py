#!/usr/bin/env python
"""Kernel microbenchmarks on the GPU: limb NTT/iNTT for each portable NTT
path.

  radix2/xla    — stage-unrolled radix-2 NTT on u64 lanes (core/ntt.py)
  fourstep/xla  — four-step factorization on u32 pairs (ops/fourstep.py)
  fourstep/mxu  — four-step with int8 digit-matmul column transforms
                  (ops/mxu_ntt.py)

Shapes: N=2^14 on the reference QP chain (6 limbs) and N=2^16 on a chain of
the same shape, 8 polynomials per call (the key switch is timed inside the
server round, bench.py). Each call ends in
``block_until_ready``; the reported time is the median of the timed calls.
Every path's output is checked bit-equal (radix2 after mapping its eval
order to the four-step order). Bytes are the compulsory traffic of a limb
transform: one u64 read and one u64 write per coefficient.

    python bench_kernels.py

Prints one JSON line per measurement.
"""

import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

PATHS = (("radix2", "xla"), ("fourstep", "xla"), ("fourstep", "mxu"))
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
BATCH = 8                     # polynomials per call, each of L+K=6 limbs
CALLS = 30


def _median_s(fn, args, calls):
    import jax
    import numpy as np

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def bench_ntt(n, batch, calls, info):
    import jax
    import numpy as np

    from ppqsflhe.ckks.params import CkksContext, CkksParams

    base = CkksParams.reference_shaped(n)
    ref = None
    for backend, impl in PATHS:
        ctx = CkksContext(dataclasses.replace(base, ntt_backend=backend,
                                              ntt_impl=impl))
        idx = tuple(range(len(ctx.moduli_qp)))
        q = np.asarray(ctx.moduli_qp, np.uint64)[:, None]
        x = jax.device_put(np.random.default_rng(0).integers(
            0, 1 << 62, size=(batch, len(idx), n), dtype=np.uint64) % q)
        fwd = jax.jit(lambda a: ctx.ntt(a, idx))
        inv = jax.jit(lambda a: ctx.intt(a, idx))
        t0 = time.time()
        y = jax.block_until_ready(fwd(x))
        compile_s = time.time() - t0
        out = np.asarray(y)
        if backend == "radix2":
            # std bit-reversed order → four-step kernel order
            from ppqsflhe.ops.fourstep import kernel_to_std

            out = out[..., np.argsort(kernel_to_std(n))]
        if ref is None:
            ref = out
        elif not np.array_equal(out, ref):
            raise AssertionError(f"{backend}/{impl} NTT differs from radix2/xla")
        if not np.array_equal(np.asarray(inv(y)), np.asarray(x)):
            raise AssertionError(f"{backend}/{impl}: intt(ntt(x)) != x")
        transforms = batch * len(idx)
        for name, fn, arg in (("ntt", fwd, x), ("intt", inv, y)):
            s = _median_s(fn, (arg,), calls)
            us = s / transforms * 1e6
            gbs = 16 * n * transforms / s / 1e9
            print(json.dumps({
                "metric": f"{name}_us_per_limb", "n": n, "limbs": len(idx),
                "batch": batch, "ntt": f"{backend}/{impl}", "value": us,
                "unit": "us", "compulsory_GB_per_s": gbs,
                "hbm_share": gbs * 1e9 / HBM_BYTES_PER_S,
                "compile_s": compile_s, "device": info}), flush=True)


def main():
    import ppqsflhe  # noqa: F401
    from bench import device_info

    _, info = device_info()
    print(f"[kbench] device: {info}", file=sys.stderr)
    for n in (1 << 14, 1 << 16):
        bench_ntt(n, BATCH, CALLS, info)


if __name__ == "__main__":
    main()

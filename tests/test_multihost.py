"""Multi-host DCN path (parallel/multihost.py): a real 2-process
jax.distributed cluster on CPU (gloo collectives), 2 virtual devices per
process → a 4-way global ``client`` mesh.

Each process plays one "host" holding 2 clients; the encrypted FedAvg and
the threshold partial-decryption fusion each run as ONE global psum — no
file/HTTP hop on the data path. This is the multi-host execution model
(SURVEY.md §2.6) validated on CPU processes.

The worker re-execs this file (`--worker <pid> <nprocs> <port>`) because
jax.distributed must initialize before any backend use; it cannot run in
the pytest process.
"""

import os
import subprocess
import sys

import pytest

WORKER_TIMEOUT_S = 420


def _worker(pid: int, nprocs: int, port: int) -> None:
    # env must be set before jax import (this runs in a fresh interpreter)
    import jax
    import jax.numpy as jnp
    import numpy as np

    jax.config.update("jax_platforms", "cpu")

    from ppqsflhe.parallel import multihost as mh

    mh.initialize(f"127.0.0.1:{port}", nprocs, pid)
    assert jax.process_count() == nprocs
    assert len(jax.devices()) == 2 * nprocs

    from ppqsflhe.ckks import threshold as th
    from ppqsflhe.ckks.params import CkksParams
    from ppqsflhe.ckks.scheme import CkksScheme
    from ppqsflhe.ckks.rlwe import decode_coeffs
    from ppqsflhe.ckks.types import Ciphertext

    params = CkksParams.generate(n=256, mult_depth=2, scale_bits=40, dnum=2)
    sch = CkksScheme(params)
    mesh = mh.global_client_mesh()
    n_total = 2 * nprocs

    # joint threshold key: shares are derived from global seeds, so every
    # process can deterministically recompute every b-share (stand-in for
    # the one broadcast round a real deployment does)
    a = th.common_random_poly(sch.ctx, seed=5)
    shares, b_shares = [], []
    for i in range(n_total):
        sk_i, b_i = th.partial_keygen(sch.ctx, a, jax.random.PRNGKey(300 + i))
        shares.append(sk_i)
        b_shares.append(b_i)
    pk = th.joint_public_key(sch.ctx, a, b_shares)

    vecs = [np.random.default_rng(50 + i).uniform(-1, 1, sch.encoder.slots)
            for i in range(n_total)]
    # THIS host's clients: process-major slots [2*pid, 2*pid+1]
    local_cts = [
        sch.encrypt_values(pk, vecs[2 * pid + j], jax.random.PRNGKey(60 + 2 * pid + j))
        for j in range(2)
    ]
    scale = local_cts[0].scale
    # (clients_local=2, B=1, k=2, l, n)
    local_stack = np.stack([np.asarray(ct.data)[None] for ct in local_cts])

    agg = mh.aggregate_multihost(sch.ctx, local_stack, mesh, scale, n_total)
    assert agg.data.shape[0] == 1

    # threshold fusion across hosts: each host's 2 shares partial-decrypt
    agg_local = Ciphertext(jnp.asarray(np.asarray(jax.device_get(agg.data))[0]),
                           scale=agg.scale)
    s_local = np.stack([np.asarray(shares[2 * pid + j].s_eval) for j in range(2)])
    rng_local = np.asarray(jax.random.split(jax.random.PRNGKey(70 + pid), 2))
    coeffs = mh.partial_decrypt_multihost(sch.ctx, agg_local, s_local,
                                          rng_local, mesh)
    out = decode_coeffs(sch.ctx, np.asarray(jax.device_get(coeffs)),
                        agg_local, sch.encoder)
    want = np.mean(vecs, axis=0)
    err = float(np.abs(np.asarray(out) - want).max())
    # ss=30 smudging, 8 parties → ~0.05 slot noise budget
    assert err < 0.2, f"process {pid}: fused aggregate off by {err}"
    print(f"WORKER-{pid}-OK err={err:.2e}", flush=True)


def test_two_process_dcn_fedavg(tmp_path):
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=2",
    )
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker", str(pid), "2", str(port)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        )
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=WORKER_TIMEOUT_S)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("multihost workers timed out:\n" + "\n".join(outs))
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-3000:]}"
        assert f"WORKER-{pid}-OK" in out


if __name__ == "__main__" and "--worker" in sys.argv:
    i = sys.argv.index("--worker")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    _worker(int(sys.argv[i + 1]), int(sys.argv[i + 2]), int(sys.argv[i + 3]))

"""Coefficient-sharded NTT on the virtual 8-device mesh: must equal the
single-device four-step transform bit-for-bit (SURVEY.md §2.5 — the
sequence-parallel axis; one all-to-all per transform)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ppqsflhe.core import primes
from ppqsflhe.ops.fourstep import FourStepNtt
from ppqsflhe.ops.sharded_ntt import ShardedNtt
from ppqsflhe.parallel.mesh import make_mesh


@pytest.fixture(scope="module")
def setup():
    n = 1024  # n1 = n2 = 32, divisible by 8 devices
    moduli = [primes.first_prime_down(59, 2 * n), primes.first_prime_down(40, 2 * n)]
    psis = [primes.root_of_unity(2 * n, q) for q in moduli]
    mesh = make_mesh({"coef": 8})
    sn = ShardedNtt(n, moduli, psis, mesh)
    fs = FourStepNtt(n, moduli, psis)
    rng = np.random.default_rng(0)
    x = np.stack([rng.integers(0, q, n, dtype=np.uint64) for q in moduli])
    return n, sn, fs, x


def test_sharded_matches_fourstep(setup):
    n, sn, fs, x = setup
    xm = jnp.asarray(x.reshape(x.shape[0], sn.n1, sn.n2))
    got = np.asarray(jax.jit(sn.ntt)(xm)).reshape(x.shape[0], n)
    want = np.asarray(fs.ntt(jnp.asarray(x), implementation="xla"))
    assert (got == want).all()


def test_sharded_roundtrip(setup):
    n, sn, fs, x = setup
    xm = jnp.asarray(x.reshape(x.shape[0], sn.n1, sn.n2))
    fwd = jax.jit(sn.ntt)(xm)
    back = np.asarray(jax.jit(sn.intt)(fwd.reshape(x.shape[0], sn.n2, sn.n1)))
    assert (back.reshape(x.shape[0], n) == x).all()


def test_sharded_intt_matches_fourstep(setup):
    n, sn, fs, x = setup
    want = np.asarray(fs.intt(jnp.asarray(x), implementation="xla"))
    xm = jnp.asarray(x.reshape(x.shape[0], sn.n2, sn.n1))
    got = np.asarray(jax.jit(sn.intt)(xm)).reshape(x.shape[0], n)
    assert (got == want).all()

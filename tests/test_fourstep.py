"""Four-step NTT + u32-pair arithmetic tests (ops/)."""

import numpy as np
import jax.numpy as jnp
import pytest

from ppqsflhe.core import primes
from ppqsflhe.core.ntt import NttBasis
from ppqsflhe.ops import u32pair as up
from ppqsflhe.ops.fourstep import FourStepNtt


def pairs(vals):
    v = np.asarray(vals, np.uint64)
    return jnp.asarray(v & np.uint64(0xFFFFFFFF), jnp.uint32), jnp.asarray(v >> np.uint64(32), jnp.uint32)


def join(lo, hi):
    return np.asarray(lo, np.uint64) | (np.asarray(hi, np.uint64) << np.uint64(32))


Q = 1152921504606748673  # the reference 60-bit modulus


def test_u32pair_mul64_wide():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 1 << 64, 256, dtype=np.uint64)
    b = rng.integers(0, 1 << 64, 256, dtype=np.uint64)
    alo, ahi = pairs(a)
    blo, bhi = pairs(b)
    w0, w1, w2, w3 = up.mul64_wide(alo, ahi, blo, bhi)
    for i in range(256):
        want = int(a[i]) * int(b[i])
        got = (int(w0[i]) | (int(w1[i]) << 32) | (int(w2[i]) << 64) | (int(w3[i]) << 96))
        assert got == want, i


def test_u32pair_modops():
    rng = np.random.default_rng(1)
    a = rng.integers(0, Q, 512, dtype=np.uint64)
    b = rng.integers(0, Q, 512, dtype=np.uint64)
    alo, ahi = pairs(a)
    blo, bhi = pairs(b)
    qlo, qhi = jnp.uint32(Q & 0xFFFFFFFF), jnp.uint32(Q >> 32)
    slo, shi = up.modadd64(alo, ahi, blo, bhi, qlo, qhi)
    assert (join(slo, shi).astype(object) == (a.astype(object) + b) % Q).all()
    dlo, dhi = up.modsub64(alo, ahi, blo, bhi, qlo, qhi)
    assert (join(dlo, dhi).astype(object) == (a.astype(object) - b) % Q).all()


def test_u32pair_shoup():
    rng = np.random.default_rng(2)
    a = rng.integers(0, Q, 512, dtype=np.uint64)
    w = int(rng.integers(0, Q))
    ws = primes.shoup_precompute(w, Q)
    alo, ahi = pairs(a)
    wlo, whi = jnp.uint32(w & 0xFFFFFFFF), jnp.uint32(w >> 32)
    wslo, wshi = jnp.uint32(ws & 0xFFFFFFFF), jnp.uint32(ws >> 32)
    qlo, qhi = jnp.uint32(Q & 0xFFFFFFFF), jnp.uint32(Q >> 32)
    rlo, rhi = up.shoup_mul64(alo, ahi, wlo, whi, wslo, wshi, qlo, qhi)
    assert (join(rlo, rhi).astype(object) == (a.astype(object) * w) % Q).all()


def test_u32pair_montmul():
    rng = np.random.default_rng(3)
    a = rng.integers(0, Q, 512, dtype=np.uint64)
    b = rng.integers(0, Q, 512, dtype=np.uint64)
    qinv = primes.mont_qinv_neg(Q)
    alo, ahi = pairs(a)
    blo, bhi = pairs(b)
    qlo, qhi = jnp.uint32(Q & 0xFFFFFFFF), jnp.uint32(Q >> 32)
    ilo, ihi = jnp.uint32(qinv & 0xFFFFFFFF), jnp.uint32(qinv >> 32)
    rlo, rhi = up.mont_mul64(alo, ahi, blo, bhi, qlo, qhi, ilo, ihi)
    rinv = primes.mod_inverse(1 << 64, Q)
    want = (a.astype(object) * b % Q) * rinv % Q
    assert (join(rlo, rhi).astype(object) == want).all()


@pytest.fixture(scope="module")
def setup():
    n = 256
    moduli = [Q, primes.first_prime_down(40, 2 * n)]
    psis = [primes.root_of_unity(2 * n, q) for q in moduli]
    basis = NttBasis(n, moduli, psis)
    fs = FourStepNtt(n, moduli, psis)
    rng = np.random.default_rng(4)
    x = np.stack([rng.integers(0, q, n, dtype=np.uint64) for q in moduli])
    return n, moduli, basis, fs, x


def test_fourstep_roundtrip(setup):
    n, moduli, basis, fs, x = setup
    fwd = fs.ntt(jnp.asarray(x), implementation="xla")
    back = np.asarray(fs.intt(fwd, implementation="xla"))
    assert (back == x).all()


def test_fourstep_matches_core_ntt(setup):
    """kernel order → std order permutation must land exactly on core/ntt.py."""
    n, moduli, basis, fs, x = setup
    fwd = np.asarray(fs.ntt(jnp.asarray(x), implementation="xla"))
    std = np.asarray(basis.ntt(jnp.asarray(x)))
    remapped = fwd[:, fs.perm_to_std]
    assert (remapped == std).all()


def test_fourstep_batched(setup):
    n, moduli, basis, fs, x = setup
    xb = np.stack([x, (x + 1) % np.asarray(moduli, np.uint64)[:, None]])
    fwd = fs.ntt(jnp.asarray(xb), implementation="xla")
    back = np.asarray(fs.intt(fwd, implementation="xla"))
    assert (back == xb).all()


def test_mxu_backend_bitexact():
    """The int8 digit-matmul MXU backend (ops/mxu_ntt.py) is bit-exact
    interchangeable with the four-step XLA path (same kernel eval order),
    for strict AND Harvey-lazy (< 4q) inputs, across modulus widths
    (60/40/20-bit: redc and fallback recompose plans)."""
    import jax.numpy as jnp
    import numpy as np

    from ppqsflhe.core import primes
    from ppqsflhe.core.ntt import NttBasis
    from ppqsflhe.ops.mxu_ntt import MxuNttTables, mxu_intt_limb, mxu_ntt_limb
    from ppqsflhe.ops.fourstep import FourStepNtt

    n = 256
    moduli = ([primes.first_prime_down(60, 2 * n)]
              + primes.prime_chain(40, 2, 2 * n)
              + [primes.next_prime_up(1 << 19, 2 * n)])
    basis = NttBasis(n, tuple(moduli))
    fs = FourStepNtt(n, moduli, basis.psis)
    tabs = [MxuNttTables.build(n, q, int(p)) for q, p in zip(moduli, basis.psis)]
    rng = np.random.default_rng(7)
    x = np.stack([rng.integers(0, q, size=(3, n), dtype=np.uint64)
                  for q in moduli], axis=1)
    ref = np.asarray(fs.ntt(jnp.asarray(x), implementation="xla"))
    out = np.stack([np.asarray(mxu_ntt_limb(jnp.asarray(x[:, i]), tabs[i]))
                    for i in range(len(moduli))], axis=1)
    assert np.array_equal(ref, out)
    # inverse + roundtrip
    iout = np.stack([np.asarray(mxu_intt_limb(jnp.asarray(ref[:, i]), tabs[i]))
                     for i in range(len(moduli))], axis=1)
    assert np.array_equal(iout, x)
    # lazy inputs (residues + q, the Harvey invariant) give identical output
    x4 = x + np.array(moduli, np.uint64)[None, :, None]
    out4 = np.stack([np.asarray(mxu_ntt_limb(jnp.asarray(x4[:, i]), tabs[i]))
                     for i in range(len(moduli))], axis=1)
    assert np.array_equal(out4, out)
    # dispatch through FourStepNtt (the scheme integration point)
    via = np.asarray(fs.ntt(jnp.asarray(x), implementation="mxu"))
    assert np.array_equal(via, ref)
    via_i = np.asarray(fs.intt(jnp.asarray(ref), implementation="mxu"))
    assert np.array_equal(via_i, x)

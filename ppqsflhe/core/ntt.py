"""Negacyclic NTT / iNTT over RNS limb stacks.

Replaces OpenFHE's ``ChineseRemainderTransformFTT`` (the engine behind every
``DCRTPoly`` format switch; reference call surface SURVEY.md §2.2). The
transform is the Cooley–Tukey / Gentleman–Sande pair with the 2N-th root ψ
merged into bit-reverse-ordered twiddle tables (Longa–Naehrig formulation):

- ``ntt``  : coefficient domain (natural order) → evaluation domain
             (bit-reversed order), decimation-in-time.
- ``intt`` : evaluation (bit-reversed) → coefficient (natural), G-S,
             with the final N^{-1} folded in as a Shoup multiply.

Shape discipline: polynomials are ``uint64`` arrays of shape
``(..., L, N)`` (limb-major). Each of the log2(N) stages is one full-width
vectorized butterfly over the whole stack — reshape to ``(..., L, m, 2, t)``,
twiddle-multiply the odd half, add/sub — so XLA sees only static-shape
elementwise ops and fuses each stage into a couple of kernels. The
coefficient-sharded multi-device variant lives in
:mod:`ppqsflhe.ops.sharded_ntt`.
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import jax
import numpy as np

from . import primes
from .modarith import modadd, modsub, shoup_mul


def bit_reverse_indices(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n, dtype=np.uint64)
    out = np.zeros(n, dtype=np.uint64)
    for b in range(bits):
        out |= ((idx >> b) & 1) << (bits - 1 - b)
    return out.astype(np.int64)


def _psi_tables(psi: int, n: int, q: int):
    """(psi_rev, psi_rev_shoup) — powers ψ^i in bit-reversed index order."""
    pows = np.zeros(n, dtype=np.uint64)
    acc = 1
    raw = []
    for _ in range(n):
        raw.append(acc)
        acc = (acc * psi) % q
    rev = bit_reverse_indices(n)
    shoup = np.zeros(n, dtype=np.uint64)
    for i in range(n):
        w = raw[int(rev[i])]
        pows[i] = w
        shoup[i] = primes.shoup_precompute(w, q)
    return pows, shoup


class NttBasis:
    """Precomputed NTT tables for ring dimension N over a list of RNS moduli.

    ``psis`` may be given explicitly (to pin OpenFHE's exact roots of unity,
    SURVEY.md §2.3) or derived canonically from the minimal primitive root.
    """

    def __init__(self, n: int, moduli: Sequence[int], psis: Sequence[int] | None = None):
        if n & (n - 1):
            raise ValueError("N must be a power of two")
        self.n = n
        self.moduli = tuple(int(q) for q in moduli)
        if psis is None:
            psis = [primes.root_of_unity(2 * n, q) for q in self.moduli]
        self.psis = tuple(int(p) for p in psis)
        for q, psi in zip(self.moduli, self.psis):
            if not primes.is_primitive_root_of_unity(psi, 2 * n, q):
                raise ValueError(f"psi={psi} is not a primitive {2*n}-th root mod {q}")

        L = len(self.moduli)
        psi_rev = np.zeros((L, n), np.uint64)
        psi_rev_sh = np.zeros((L, n), np.uint64)
        ipsi_rev = np.zeros((L, n), np.uint64)
        ipsi_rev_sh = np.zeros((L, n), np.uint64)
        ninv = np.zeros((L, 1), np.uint64)
        ninv_sh = np.zeros((L, 1), np.uint64)
        for i, (q, psi) in enumerate(zip(self.moduli, self.psis)):
            psi_rev[i], psi_rev_sh[i] = _psi_tables(psi, n, q)
            ipsi = primes.mod_inverse(psi, q)
            ipsi_rev[i], ipsi_rev_sh[i] = _psi_tables(ipsi, n, q)
            nv = primes.mod_inverse(n, q)
            ninv[i, 0] = nv
            ninv_sh[i, 0] = primes.shoup_precompute(nv, q)

        # Host numpy tables: they enter jitted graphs as embedded constants,
        # never as committed device arrays — so a context built outside any
        # device scope works on any device without cross-device transfers (and lazily-built slices are trace-safe).
        self.psi_rev = psi_rev
        self.psi_rev_shoup = psi_rev_sh
        self.ipsi_rev = ipsi_rev
        self.ipsi_rev_shoup = ipsi_rev_sh
        self.ninv = ninv
        self.ninv_shoup = ninv_sh
        self.q_vec = np.array(self.moduli, np.uint64).reshape(L, 1)

    # ---- transforms -------------------------------------------------------

    def ntt(self, a):
        """Forward negacyclic NTT. a: u64[..., L, N] natural-order coeffs →
        bit-reversed-order evaluations."""
        return _ntt_impl(a, self.psi_rev, self.psi_rev_shoup, self.q_vec, self.n)

    def intt(self, a):
        """Inverse transform, bit-reversed evals → natural-order coeffs."""
        return _intt_impl(
            a, self.ipsi_rev, self.ipsi_rev_shoup, self.ninv, self.ninv_shoup,
            self.q_vec, self.n,
        )


@partial(jax.jit, static_argnames=("n",))
def _ntt_impl(a, psi_rev, psi_rev_shoup, q_vec, n: int):
    L = a.shape[-2]
    lead = a.shape[:-2]
    q = q_vec.reshape((1,) * len(lead) + (L, 1, 1, 1))
    x = a
    m = 1
    t = n
    while m < n:
        t //= 2
        # view: (..., L, m, 2, t); twiddles for this stage are psi_rev[:, m:2m]
        x = x.reshape(lead + (L, m, 2, t))
        w = psi_rev[:, m : 2 * m].reshape((1,) * len(lead) + (L, m, 1, 1))
        ws = psi_rev_shoup[:, m : 2 * m].reshape((1,) * len(lead) + (L, m, 1, 1))
        u = x[..., 0:1, :]
        v = shoup_mul(x[..., 1:2, :], w, ws, q)
        x = jax.numpy.concatenate([modadd(u, v, q), modsub(u, v, q)], axis=-2)
        x = x.reshape(lead + (L, n))
        m *= 2
    return x


@partial(jax.jit, static_argnames=("n",))
def _intt_impl(a, ipsi_rev, ipsi_rev_shoup, ninv, ninv_shoup, q_vec, n: int):
    L = a.shape[-2]
    lead = a.shape[:-2]
    q = q_vec.reshape((1,) * len(lead) + (L, 1, 1, 1))
    x = a
    t = 1
    m = n
    while m > 1:
        h = m // 2
        x = x.reshape(lead + (L, h, 2, t))
        w = ipsi_rev[:, h : 2 * h].reshape((1,) * len(lead) + (L, h, 1, 1))
        ws = ipsi_rev_shoup[:, h : 2 * h].reshape((1,) * len(lead) + (L, h, 1, 1))
        u = x[..., 0:1, :]
        v = x[..., 1:2, :]
        lo = modadd(u, v, q)
        hi = shoup_mul(modsub(u, v, q), w, ws, q)
        x = jax.numpy.concatenate([lo, hi], axis=-2).reshape(lead + (L, n))
        t *= 2
        m = h
    qf = q_vec.reshape((1,) * len(lead) + (L, 1))
    nv = ninv.reshape((1,) * len(lead) + (L, 1))
    nvs = ninv_shoup.reshape((1,) * len(lead) + (L, 1))
    return shoup_mul(x, nv, nvs, qf)

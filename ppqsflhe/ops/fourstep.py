"""Four-step negacyclic NTT — the matrix-shaped factorization.

The stage-unrolled radix-2 NTT in core/ntt.py ends with butterflies at
stride 1. The four-step factorization N = n1·n2 (n1=n2=√N, both ≥ 64)
runs every butterfly over whole rows of a matrix instead:

    y = x ⊙ ψ^j                       (negacyclic twist)
    A = GS-NTT_{n1} over columns      (strides hit the sublane dim only)
    B = A ⊙ T,  T[r][j2] = ω^{rev(r)·j2}   (elementwise twiddle)
    C = GS-NTT_{n2} over columns of Bᵀ     (one matrix transpose)

Output order is the kernel-native order u = rev(k2)·n1 + rev(k1) for
evaluation index k = k2·n1 + k1; ``kernel_to_std`` maps it to the standard
bit-reversed order of core/ntt.py (pointwise ops are order-agnostic, so the
permutation is only applied at interop boundaries).

The transform body is pure jnp over u32 (lo, hi) pairs (ops/u32pair.py).
``FourStepNtt`` runs a limb stack through one of two implementations, both
in kernel eval order: ``'xla'`` (that body, limb by limb) and ``'mxu'``
(ops/mxu_ntt.py: the column transforms as int8 digit-matmuls).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import primes
from ..core.ntt import bit_reverse_indices
from . import u32pair as up


def _split_np(x64: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    return (x64 & np.uint64(0xFFFFFFFF)).astype(np.uint32), (x64 >> np.uint64(32)).astype(np.uint32)


def _shoup_np(w: np.ndarray, q: int) -> np.ndarray:
    return np.array([(int(x) << 64) // q for x in w.ravel()], np.uint64).reshape(w.shape)


@dataclass
class FourStepTables:
    """Per-modulus precomputed tables, all u32 lo/hi pairs (host numpy)."""

    n: int
    n1: int
    n2: int
    q: int
    # elementwise tables, shape (n1, n2): value and shoup, each (lo, hi)
    twist: tuple          # ψ^{j1·n2+j2}
    itwist: tuple         # ψ^{-j} · N^{-1}
    twiddle: tuple        # T[r][j2] = ω^{rev(r)·j2}
    itwiddle: tuple       # ω^{-rev(r)·j2}
    # stage tables for the size-n1 / n2 column transforms, in EXPANDED
    # row-per-stage layout (S, m/2): row s (s=0 ↔ t=m/2, …, s=S-1 ↔ t=1)
    # holds w_t[j] = root^{j·m/(2t)} tiled g=m/(2t) times — so a stage
    # reads one full static row and reshapes (g, t, 1).
    gs1: tuple
    gs2: tuple
    ct1: tuple
    ct2: tuple
    q_pair: tuple         # scalars (qlo, qhi) as () arrays
    # u64 twins (value, shoup) of every table, for the XLA/shard_map path
    u64: dict = None

    @staticmethod
    def build(n: int, q: int, psi: int) -> "FourStepTables":
        n1 = 1 << ((n.bit_length() - 1) // 2)
        n2 = n // n1
        omega = pow(psi, 2, q)

        u64_tabs = {}

        def pairs(vals64: np.ndarray, name: str = None):
            sh = _shoup_np(vals64, q)
            if name:
                u64_tabs[name] = (vals64.astype(np.uint64), sh)
            vlo, vhi = _split_np(vals64.astype(np.uint64))
            slo, shi = _split_np(sh)
            return (vlo, vhi, slo, shi)

        j = np.arange(n, dtype=object)
        psi_pows = np.zeros(n, np.uint64)
        acc = 1
        for i in range(n):
            psi_pows[i] = acc
            acc = acc * psi % q
        twist = pairs(psi_pows.reshape(n1, n2), "twist")
        ipsi = primes.mod_inverse(psi, q)
        ninv = primes.mod_inverse(n, q)
        ipows = np.zeros(n, np.uint64)
        acc = ninv
        for i in range(n):
            ipows[i] = acc
            acc = acc * ipsi % q
        itwist = pairs(ipows.reshape(n1, n2), "itwist")

        rev1 = bit_reverse_indices(n1)
        tw = np.zeros((n1, n2), np.uint64)
        itw = np.zeros((n1, n2), np.uint64)
        iomega = primes.mod_inverse(omega, q)
        for r in range(n1):
            e = int(rev1[r])
            base = pow(omega, e, q)
            ibase = pow(iomega, e, q)
            acc, iacc = 1, 1
            for j2 in range(n2):
                tw[r, j2] = acc
                itw[r, j2] = iacc
                acc = acc * base % q
                iacc = iacc * ibase % q
        twiddle = pairs(tw, "twiddle")
        itwiddle = pairs(itw, "itwiddle")

        def stage_tables(m: int, root: int):
            """Expanded (S, m/2): row per stage t = m/2, …, 1; each row is
            w_t (t entries, w_t[j] = root^{j·m/(2t)}) tiled m/(2t) times."""
            S = m.bit_length() - 1
            out = np.zeros((S, m // 2), np.uint64)
            t = m // 2
            srow = 0
            while t >= 1:
                stride = m // (2 * t)
                base = pow(root, stride, q)
                wt = np.zeros(t, np.uint64)
                acc = 1
                for jj in range(t):
                    wt[jj] = acc
                    acc = acc * base % q
                out[srow] = np.tile(wt, m // (2 * t))
                t //= 2
                srow += 1
            return out

        om1 = pow(omega, n2, q)   # primitive n1-th root
        om2 = pow(omega, n1, q)   # primitive n2-th root
        iom1 = primes.mod_inverse(om1, q)
        iom2 = primes.mod_inverse(om2, q)
        gs1 = pairs(stage_tables(n1, om1), "gs1")
        gs2 = pairs(stage_tables(n2, om2), "gs2")
        ct1 = pairs(stage_tables(n1, iom1), "ct1")
        ct2 = pairs(stage_tables(n2, iom2), "ct2")
        qlo, qhi = np.uint32(q & 0xFFFFFFFF), np.uint32(q >> 32)
        return FourStepTables(
            n=n, n1=n1, n2=n2, q=q, twist=twist, itwist=itwist,
            twiddle=twiddle, itwiddle=itwiddle, gs1=gs1, gs2=gs2,
            ct1=ct1, ct2=ct2,
            q_pair=(qlo, qhi), u64=u64_tabs,
        )


def kernel_to_std(n: int) -> np.ndarray:
    """perm with std_eval[b] = kernel_eval[perm[b]] (both bit-reversed
    conventions; see module docstring)."""
    n1 = 1 << ((n.bit_length() - 1) // 2)
    n2 = n // n1
    rev1 = bit_reverse_indices(n1)
    rev2 = bit_reverse_indices(n2)
    rev_n = bit_reverse_indices(n)
    perm = np.zeros(n, np.int64)
    for r2 in range(n2):
        for r1 in range(n1):
            u = r2 * n1 + r1
            k = int(rev2[r2]) * n1 + int(rev1[r1])
            b = int(rev_n[k])
            perm[b] = u
    return perm


# ---------------------------------------------------------------------------
# Pure-jnp transform bodies on u32 pairs
# ---------------------------------------------------------------------------

def _emul(xlo, xhi, tab, qlo, qhi):
    """Elementwise Shoup multiply by a (value,shoup) table tuple — strict
    (result < q; tolerates inputs < 4q since the single conditional
    subtract lands the lazy [0,2q) residue in [0,q))."""
    wlo, whi, wslo, wshi = tab
    return up.shoup_mul64(xlo, xhi, wlo, whi, wslo, wshi, qlo, qhi)


def _emul_lazy(xlo, xhi, tab, qlo, qhi):
    """Elementwise lazy Shoup multiply: inputs < 4q → outputs < 2q."""
    wlo, whi, wslo, wshi = tab
    return up.shoup_mul64_lazy(xlo, xhi, wlo, whi, wslo, wshi, qlo, qhi)


def _dbl(qlo, qhi):
    """2q as a u32 pair (q < 2^63). The low-word doubling intentionally
    wraps mod 2^32; for host numpy scalars compute in Python ints (numpy
    would emit an overflow RuntimeWarning), for traced values wrapping u32
    arithmetic is exact and silent."""
    if isinstance(qlo, (int, np.integer)):
        q2 = ((int(qhi) << 32) | int(qlo)) * 2
        return np.uint32(q2 & 0xFFFFFFFF), np.uint32(q2 >> 32)
    return qlo + qlo, qhi + qhi + (qlo >> 31)


def _col_gs(xlo, xhi, stage_tab, qlo, qhi, m: int):
    """GS (DIF) cyclic NTT over the leading axis of an (m, lanes) pair.
    Natural input → bit-reversed output rows. stage_tab: (S, m/2) expanded.

    Harvey-lazy: the per-stage invariant is x < 2q (sums reduced mod 2q,
    differences computed as u−v+2q < 4q then lazily Shoup-multiplied back
    under 2q) — the compare/select corrections of modsub + shoup are
    skipped in every butterfly. OUTPUT IS IN [0, 2q); callers finish with
    one csub64 (ntt_body) or a strict _emul (intt_body)."""

    lanes = xlo.shape[-1]
    tlo, thi, tslo, tshi = stage_tab
    q2lo, q2hi = _dbl(qlo, qhi)
    srow = 0
    t = m // 2
    while t >= 1:
        g = m // (2 * t)
        a_lo = xlo.reshape(g, 2, t, lanes)
        a_hi = xhi.reshape(g, 2, t, lanes)
        ulo, uhi = a_lo[:, 0], a_hi[:, 0]
        vlo, vhi = a_lo[:, 1], a_hi[:, 1]
        slo, shi = up.modadd64(ulo, uhi, vlo, vhi, q2lo, q2hi)
        dlo, dhi = up.lazy_diff64(ulo, uhi, vlo, vhi, q2lo, q2hi)
        w = (tlo[srow].reshape(g, t, 1), thi[srow].reshape(g, t, 1),
             tslo[srow].reshape(g, t, 1), tshi[srow].reshape(g, t, 1))
        dlo, dhi = _emul_lazy(dlo, dhi, w, qlo, qhi)
        xlo = jnp.stack([slo, dlo], axis=1).reshape(m, lanes)
        xhi = jnp.stack([shi, dhi], axis=1).reshape(m, lanes)
        srow += 1
        t //= 2
    return xlo, xhi


def _col_ct(xlo, xhi, stage_tab, qlo, qhi, m: int):
    """CT (DIT) inverse cyclic NTT over the leading axis: bit-reversed input
    rows → natural output. Stage tables are the ω^{-1} tables consumed in
    REVERSE order (t = 1, 2, …, m/2 uses the tail-to-head segments).

    Harvey-lazy with invariant x < 2q: v·w is a lazy Shoup product (< 2q),
    the sum reduces mod 2q, the difference u−vw+2q < 4q gets one csub64 to
    re-establish < 2q. OUTPUT IS IN [0, 2q); intt_body's final strict
    _emul (itwist) lands the result in [0, q)."""

    lanes = xlo.shape[-1]
    tlo, thi, tslo, tshi = stage_tab
    q2lo, q2hi = _dbl(qlo, qhi)
    S = m.bit_length() - 1
    t = 1
    while t < m:
        g = m // (2 * t)
        srow = S - 1 - (t.bit_length() - 1)   # row s ↔ t = m/2^{s+1}
        a_lo = xlo.reshape(g, 2, t, lanes)
        a_hi = xhi.reshape(g, 2, t, lanes)
        ulo, uhi = a_lo[:, 0], a_hi[:, 0]
        vlo, vhi = a_lo[:, 1], a_hi[:, 1]
        w = (tlo[srow].reshape(g, t, 1), thi[srow].reshape(g, t, 1),
             tslo[srow].reshape(g, t, 1), tshi[srow].reshape(g, t, 1))
        vlo, vhi = _emul_lazy(vlo, vhi, w, qlo, qhi)
        slo, shi = up.modadd64(ulo, uhi, vlo, vhi, q2lo, q2hi)
        dlo, dhi = up.lazy_diff64(ulo, uhi, vlo, vhi, q2lo, q2hi)
        dlo, dhi = up.csub64(dlo, dhi, q2lo, q2hi)
        xlo = jnp.stack([slo, dlo], axis=1).reshape(m, lanes)
        xhi = jnp.stack([shi, dhi], axis=1).reshape(m, lanes)
        t *= 2
    return xlo, xhi


def ntt_body(xlo, xhi, tabs: FourStepTables):
    """Forward negacyclic NTT body. x: (n1, n2) u32 pair → kernel order.
    Internally Harvey-lazy (< 2q between stages); one final csub64 restores
    exact residues — outputs are bit-identical to the strict version."""
    qlo, qhi = tabs.q_pair
    xlo, xhi = _emul_lazy(xlo, xhi, tabs.twist, qlo, qhi)
    xlo, xhi = _col_gs(xlo, xhi, tabs.gs1, qlo, qhi, tabs.n1)
    xlo, xhi = _emul_lazy(xlo, xhi, tabs.twiddle, qlo, qhi)
    xlo, xhi = xlo.T, xhi.T
    xlo, xhi = _col_gs(xlo, xhi, tabs.gs2, qlo, qhi, tabs.n2)
    return up.csub64(xlo, xhi, qlo, qhi)  # (n2 rows = rev k2, n1 lanes = rev k1)


def intt_body(xlo, xhi, tabs: FourStepTables):
    """Inverse: kernel-order (n2, n1) → natural-order coefficients (n1, n2).
    Harvey-lazy internally; the final strict itwist multiply lands < q."""
    qlo, qhi = tabs.q_pair
    xlo, xhi = _col_ct(xlo, xhi, tabs.ct2, qlo, qhi, tabs.n2)
    xlo, xhi = xlo.T, xhi.T
    xlo, xhi = _emul_lazy(xlo, xhi, tabs.itwiddle, qlo, qhi)
    xlo, xhi = _col_ct(xlo, xhi, tabs.ct1, qlo, qhi, tabs.n1)
    xlo, xhi = _emul(xlo, xhi, tabs.itwist, qlo, qhi)
    return xlo, xhi


# ---------------------------------------------------------------------------
# Dispatch over the RNS limbs of a chain
# ---------------------------------------------------------------------------

class FourStepNtt:
    def __init__(self, n: int, moduli: Sequence[int], psis: Sequence[int]):
        self.n = n
        self.moduli = tuple(int(q) for q in moduli)
        self.tabs = [FourStepTables.build(n, q, p) for q, p in zip(moduli, psis)]
        self.n1, self.n2 = self.tabs[0].n1, self.tabs[0].n2
        self.perm_to_std = kernel_to_std(n)          # std[b] = kernel[perm[b]]
        self.perm_from_std = np.argsort(self.perm_to_std)
        self._psis = tuple(int(p) for p in psis)
        self._mxu_tabs = {}                          # limb idx → MxuNttTables

    def mxu_tables(self, i: int):
        """Lazily-built digit-matmul tables for limb i (ops/mxu_ntt.py)."""
        if i not in self._mxu_tabs:
            from .mxu_ntt import MxuNttTables

            self._mxu_tabs[i] = MxuNttTables.build(
                self.n, self.moduli[i], self._psis[i])
        return self._mxu_tabs[i]

    # -- shared body dispatch ----------------------------------------------

    def _run(self, x64, forward: bool, implementation: str, idx=None):
        L = x64.shape[-2]
        lead = x64.shape[:-2]
        x = x64.reshape((-1, L, self.n))
        sel = list(range(len(self.tabs))) if idx is None else list(idx)
        assert len(sel) == L, (len(sel), L)
        if implementation == "mxu":
            from .mxu_ntt import mxu_intt_limb, mxu_ntt_limb

            fn = mxu_ntt_limb if forward else mxu_intt_limb
            out = jnp.stack(
                [fn(x[:, k], self.mxu_tables(i)) for k, i in enumerate(sel)],
                axis=1)
        elif implementation == "xla":
            out = _xla_transform(x, [self.tabs[i] for i in sel],
                                 self.n1, self.n2, forward)
        else:
            raise ValueError(f"unknown four-step ntt_impl {implementation!r}")
        return out.reshape(lead + (L, self.n))

    def ntt(self, x64, implementation: str = "xla", idx=None):
        """coeff (natural) → eval (kernel order). u64[..., L, N]. ``idx``
        selects a static limb subset of the precomputed moduli."""
        return self._run(x64, True, implementation, idx)

    def intt(self, x64, implementation: str = "xla", idx=None):
        return self._run(x64, False, implementation, idx)


def _xla_transform(x, tabs, n1, n2, forward):  # x: (B, L, N) u64
    outs = []
    for i, t in enumerate(tabs):
        def one(v64, t=t):
            lo, hi = up.split64(v64.reshape(n1, n2) if forward else v64.reshape(n2, n1))
            lo2, hi2 = (ntt_body if forward else intt_body)(lo, hi, t)
            return up.join64(lo2, hi2).reshape(-1)
        outs.append(jax.vmap(one)(x[:, i]))
    return jnp.stack(outs, axis=1)

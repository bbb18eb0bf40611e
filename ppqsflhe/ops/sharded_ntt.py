"""Coefficient-sharded negacyclic NTT over a device mesh.

The sequence-parallel analogue called for by SURVEY.md §2.5/§5.7: a
length-N NTT with the polynomial's coefficients sharded across devices.
The four-step factorization makes the communication structure optimal —
instead of log2(N) staged butterfly exchanges, the ENTIRE transform needs
exactly ONE all-to-all (the distributed transpose between the two local
column-NTT phases), which rides ICI on a real slice:

    local:  twist ⊙, GS-NTT_{n1} over rows, twiddle ⊙     (no comms)
    comm:   all-to-all distributed transpose              (1 collective)
    local:  GS-NTT_{n2} over rows                          (no comms)

Sharding layout: the (n1, n2) coefficient matrix is sharded on the n2
(lane) axis; the output (kernel-order, matching ops/fourstep.py) is sharded
on the n1 axis. The inverse runs the mirror image. u64 arithmetic
(core/modarith Shoup), run under shard_map and compiled by XLA.
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.modarith import modadd, modsub, shoup_mul
from .fourstep import FourStepTables


def _col_gs64(x, tab_w, tab_sh, q, m: int):
    """GS-DIF cyclic NTT over axis -2 of u64[..., m, lanes] (natural in,
    bit-reversed out). tab_*: expanded (S, m/2) stage tables."""
    lanes = x.shape[-1]
    lead = x.shape[:-2]
    srow = 0
    t = m // 2
    while t >= 1:
        g = m // (2 * t)
        a = x.reshape(lead + (g, 2, t, lanes))
        u, v = a[..., 0, :, :], a[..., 1, :, :]
        s = modadd(u, v, q)
        d = shoup_mul(modsub(u, v, q), tab_w[srow].reshape(g, t, 1),
                      tab_sh[srow].reshape(g, t, 1), q)
        x = jnp.stack([s, d], axis=-3).reshape(lead + (m, lanes))
        srow += 1
        t //= 2
    return x


def _col_ct64(x, tab_w, tab_sh, q, m: int):
    """CT-DIT inverse over axis -2: bit-reversed in → natural out.
    tab_*: expanded (S, m/2); row s ↔ t = m/2^{s+1}."""
    lanes = x.shape[-1]
    lead = x.shape[:-2]
    S = m.bit_length() - 1
    t = 1
    while t < m:
        g = m // (2 * t)
        srow = S - 1 - (t.bit_length() - 1)
        a = x.reshape(lead + (g, 2, t, lanes))
        u, v = a[..., 0, :, :], a[..., 1, :, :]
        v = shoup_mul(v, tab_w[srow].reshape(g, t, 1), tab_sh[srow].reshape(g, t, 1), q)
        s = modadd(u, v, q)
        d = modsub(u, v, q)
        x = jnp.stack([s, d], axis=-3).reshape(lead + (m, lanes))
        t *= 2
    return x


class ShardedNtt:
    """Mesh-sharded four-step NTT for one RNS limb stack.

    Operates on u64[L, n1, n2] matrices sharded P(None, None, axis) for the
    forward input; forward output is (L, n2, n1) sharded on the last axis
    (kernel order, SAME convention as FourStepNtt). D = mesh axis size must
    divide both n1 and n2.
    """

    def __init__(self, n: int, moduli: Sequence[int], psis: Sequence[int],
                 mesh: Mesh, axis: str = "coef"):
        self.n = n
        self.mesh = mesh
        self.axis = axis
        self.tabs = [FourStepTables.build(n, q, p) for q, p in zip(moduli, psis)]
        self.n1, self.n2 = self.tabs[0].n1, self.tabs[0].n2
        D = mesh.shape[axis]
        if self.n1 % D or self.n2 % D:
            raise ValueError(f"mesh axis size {D} must divide n1={self.n1}, n2={self.n2}")
        self.moduli = tuple(int(q) for q in moduli)
        stack = lambda name: (
            jnp.asarray(np.stack([t.u64[name][0] for t in self.tabs])),
            jnp.asarray(np.stack([t.u64[name][1] for t in self.tabs])),
        )
        self.t_twist = stack("twist")          # (L, n1, n2)
        self.t_itwist = stack("itwist")
        self.t_twiddle = stack("twiddle")
        self.t_itwiddle = stack("itwiddle")
        self.t_gs1 = stack("gs1")              # (L, S, n1/2) expanded
        self.t_gs2 = stack("gs2")
        self.t_ct1 = stack("ct1")
        self.t_ct2 = stack("ct2")
        self.q_vec = jnp.asarray(
            np.array(self.moduli, np.uint64).reshape(-1, 1, 1))

    # -- forward ------------------------------------------------------------

    def ntt(self, x):
        """x: u64[L, n1, n2] (global view) → u64[L, n2, n1] kernel order."""
        ax = self.axis
        n1, n2 = self.n1, self.n2

        def body(xl, twist_w, twist_sh, twid_w, twid_sh, gs1_w, gs1_sh,
                 gs2_w, gs2_sh):
            q = self.q_vec
            y = shoup_mul(xl, twist_w, twist_sh, q)
            y = _stacked_gs(y, gs1_w, gs1_sh, q, n1)
            y = shoup_mul(y, twid_w, twid_sh, q)
            # distributed transpose: split rows, concat lanes, local swap
            y = jax.lax.all_to_all(y, ax, split_axis=1, concat_axis=2, tiled=True)
            y = jnp.swapaxes(y, 1, 2)          # (L, n2, n1/D) local
            y = _stacked_gs(y, gs2_w, gs2_sh, q, n2)
            return y

        specs_elem = P(None, None, ax)
        specs_stage = P(None, None)
        fn = jax.shard_map(
            body, mesh=self.mesh,
            in_specs=(specs_elem, specs_elem, specs_elem, specs_elem, specs_elem,
                      specs_stage, specs_stage, specs_stage, specs_stage),
            out_specs=P(None, None, ax),
        )
        return fn(x, self.t_twist[0], self.t_twist[1],
                  self.t_twiddle[0], self.t_twiddle[1],
                  self.t_gs1[0], self.t_gs1[1], self.t_gs2[0], self.t_gs2[1])

    # -- inverse ------------------------------------------------------------

    def intt(self, x):
        """x: u64[L, n2, n1] kernel order → u64[L, n1, n2] natural coeffs."""
        ax = self.axis
        n1, n2 = self.n1, self.n2

        def body(xl, itwist_w, itwist_sh, itwid_w, itwid_sh, ct1_w, ct1_sh,
                 ct2_w, ct2_sh):
            q = self.q_vec
            y = _stacked_ct(xl, ct2_w, ct2_sh, q, n2)
            y = jax.lax.all_to_all(y, ax, split_axis=1, concat_axis=2, tiled=True)
            y = jnp.swapaxes(y, 1, 2)          # (L, n1, n2/D) local
            y = shoup_mul(y, itwid_w, itwid_sh, q)
            y = _stacked_ct(y, ct1_w, ct1_sh, q, n1)
            y = shoup_mul(y, itwist_w, itwist_sh, q)
            return y

        specs_elem = P(None, None, ax)
        # itwiddle is indexed [r1][j2] → sharded on j2 (lanes after transpose)
        fn = jax.shard_map(
            body, mesh=self.mesh,
            in_specs=(P(None, None, ax), P(None, None, ax), P(None, None, ax),
                      P(None, None, ax), P(None, None, ax),
                      P(None, None), P(None, None), P(None, None), P(None, None)),
            out_specs=P(None, None, ax),
        )
        return fn(x, self.t_itwist[0], self.t_itwist[1],
                  self.t_itwiddle[0], self.t_itwiddle[1],
                  self.t_ct1[0], self.t_ct1[1], self.t_ct2[0], self.t_ct2[1])


def _stacked_gs(y, w, sh, q, m):
    """Per-limb GS over axis -2 (tables (L, m-1) differ per limb)."""
    outs = [
        _col_gs64(y[i], w[i], sh[i], q[i], m) for i in range(y.shape[0])
    ]
    return jnp.stack(outs)


def _stacked_ct(y, w, sh, q, m):
    outs = [
        _col_ct64(y[i], w[i], sh[i], q[i], m) for i in range(y.shape[0])
    ]
    return jnp.stack(outs)

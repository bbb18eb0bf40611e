"""Coefficient-sharded execution of the FULL homomorphic server round.

ops/sharded_ntt.py shards one transform; this module shards the whole
scheme: :class:`ShardedEvalContext` is a drop-in
:class:`~ppqsflhe.ckks.params.CkksContext` whose ``ntt``/``intt`` run
*per-shard inside a shard_map* over the ``coef`` mesh axis (four-step local
phases + exactly ONE ``all_to_all`` — the distributed transpose). Every
other CKKS operation (modular elementwise ops, HPS base extension, hybrid
key-switch inner products, rescale corrections) is coefficient-wise, so the
UNCHANGED ``ckks.eval`` code — keyswitch, PRE, FedAvg, rescale — executes
correctly on local shards. The result: the reference's entire server round
(changeCipherDomain → aggregate → changeCipherDomain, SURVEY.md §3.1 hot
loops #3-#4) runs sharded over a ``client × coef`` device mesh with XLA
collectives only where the math requires them:

- ``coef`` axis: one all-to-all inside every NTT/iNTT (the
  sequence-parallel analogue, SURVEY.md §2.5/§5.7);
- ``client`` axis: one modular psum for the federated aggregation.

Layout conventions (kernel eval order, matching ops/fourstep.py):

- COEFF-domain polys view flat N as an (n1, n2) matrix → shard the n2 axis;
- EVAL-domain polys view flat N as (n2, n1) → shard the n1 axis;
- inside the shard_map body, locals are flattened back to (..., l, N/D) and
  fed to the ordinary eval.py ops.

Galois rotations are the one op that is NOT coefficient-local (the bin
permutation crosses shards): :func:`rotate_sharded` /
:func:`conjugate_sharded` handle it with exactly ONE ``all_gather`` over the
coef axis per permuted poly (then each shard takes its own slice of the
static global permutation), and :func:`rotate_hoisted_sharded` shares the
sharded decompose+extend across a batch of rotations.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ckks import eval as ev
from ..ckks.params import CkksContext, CkksParams
from ..ckks.types import Ciphertext, KeySwitchKey
from ..core.modarith import modadd
from ..ops.sharded_ntt import _col_ct64, _col_gs64


class ShardedEvalContext(CkksContext):
    """CkksContext whose transforms execute per-shard under shard_map.

    Must be used INSIDE a shard_map body whose mesh carries ``axis`` (the
    helpers below set one up); the local trailing dim is N/D.
    """

    def __init__(self, params: CkksParams, mesh: Mesh, axis: str = "coef"):
        # Per-shard transforms need the four-step stage split at the
        # all-to-all. 'mxu' runs each column transform as the int8
        # digit-matmul of ops/mxu_ntt.py; every other impl runs the u64
        # Shoup column stages.
        impl = "mxu" if params.ntt_impl == "mxu" else "xla"
        if params.ntt_backend != "fourstep" or params.ntt_impl != impl:
            import dataclasses

            params = dataclasses.replace(params, ntt_backend="fourstep",
                                         ntt_impl=impl)
        self.impl = impl
        super().__init__(params)       # builds self.fntt with FourStepTables
        self.mesh = mesh
        self.axis = axis
        self.D = mesh.shape[axis]
        tabs = self.fntt.tabs
        self.n1, self.n2 = self.fntt.n1, self.fntt.n2
        if self.n1 % self.D or self.n2 % self.D:
            raise ValueError(
                f"coef axis size {self.D} must divide n1={self.n1}, n2={self.n2}")
        stack = lambda name: (
            jnp.asarray(np.stack([t.u64[name][0] for t in tabs])),
            jnp.asarray(np.stack([t.u64[name][1] for t in tabs])),
        )
        self._twist = stack("twist")          # (L+K, n1, n2)
        self._itwist = stack("itwist")
        self._twiddle = stack("twiddle")
        self._itwiddle = stack("itwiddle")
        self._gs1 = stack("gs1")              # (L+K, S1, n1/2)
        self._gs2 = stack("gs2")
        self._ct1 = stack("ct1")
        self._ct2 = stack("ct2")
        self._qs = np.array(self.moduli_qp, np.uint64)
        # compiled shard_map entry points, keyed (op, galois-elt(s), nlimbs):
        # building a fresh jit(shard_map(...)) per call would retrace the
        # whole sharded keyswitch pipeline on every rotation (ADVICE r2).
        self._jit_cache: dict = {}

    def cached_jit(self, key, builder):
        fn = self._jit_cache.get(key)
        if fn is None:
            fn = self._jit_cache[key] = builder()
        return fn

    # -- local-shard transforms (called from inside the shard_map body) ------

    def _slice_cols(self, tab, sel):
        """Select limbs (static) + this shard's n2-column block (dynamic)."""
        t = tab[np.asarray(sel, np.int32)]
        i = jax.lax.axis_index(self.axis)
        n2loc = self.n2 // self.D
        return jax.lax.dynamic_slice_in_dim(t, i * n2loc, n2loc, axis=2)

    # -- MXU digit-matmul shard-local transforms (impl='mxu') ----------------
    # Same stage split as the xla path (stage1 → twiddle → all-to-all →
    # stage2) but each column transform is the int8 MXU digit-matmul of
    # ops/mxu_ntt.py — bit-exact vs every other backend, so sharded-mxu
    # output equals the replicated transforms residue-for-residue.

    def _twiddle_shard(self, quad, loc: int):
        """This shard's ``loc``-column block of a (m, lanes) Shoup quad."""
        i = jax.lax.axis_index(self.axis)
        return tuple(
            jax.lax.dynamic_slice_in_dim(jnp.asarray(t), i * loc, loc, axis=1)
            for t in quad)

    def _ntt_mxu(self, a, sel):
        from ..ops import mxu_ntt as MX
        from ..ops import u32pair as up

        lead = a.shape[:-2]
        n2loc = self.n2 // self.D
        pairs = []
        for k, i in enumerate(sel):
            tabs = self.fntt.mxu_tables(i)
            lo, hi = up.split64(a[..., k, :].reshape(lead + (self.n1, n2loc)))
            lo, hi = MX._stage(lo, hi, jnp.asarray(tabs.a1), tabs, -2)
            lo, hi = MX._lazy_tmul(lo, hi, self._twiddle_shard(tabs.t1, n2loc),
                                   tabs)
            pairs.append(up.join64(lo, hi))
        y = jnp.stack(pairs, axis=-3)                  # (..., l, n1, n2loc)
        y = jax.lax.all_to_all(y, self.axis, split_axis=y.ndim - 2,
                               concat_axis=y.ndim - 1, tiled=True)
        y = jnp.swapaxes(y, -1, -2)                    # (..., l, n2, n1loc)
        outs = []
        for k, i in enumerate(sel):
            tabs = self.fntt.mxu_tables(i)
            lo, hi = up.split64(y[..., k, :, :])
            lo, hi = MX._stage(lo, hi, jnp.asarray(tabs.a2), tabs, -2)
            lo, hi = MX._strict(lo, hi, tabs)
            outs.append(up.join64(lo, hi))
        return jnp.stack(outs, axis=-3).reshape(lead + (len(sel), -1))

    def _intt_mxu(self, a, sel):
        from ..ops import mxu_ntt as MX
        from ..ops import u32pair as up

        lead = a.shape[:-2]
        n1loc = self.n1 // self.D
        pairs = []
        for k, i in enumerate(sel):
            tabs = self.fntt.mxu_tables(i)
            lo, hi = up.split64(a[..., k, :].reshape(lead + (self.n2, n1loc)))
            lo, hi = MX._stage(lo, hi, jnp.asarray(tabs.a2i), tabs, -2)
            lo, hi = MX._lazy_tmul(lo, hi, self._twiddle_shard(tabs.t1i, n1loc),
                                   tabs)
            pairs.append(up.join64(lo, hi))
        y = jnp.stack(pairs, axis=-3)                  # (..., l, n2, n1loc)
        y = jax.lax.all_to_all(y, self.axis, split_axis=y.ndim - 2,
                               concat_axis=y.ndim - 1, tiled=True)
        y = jnp.swapaxes(y, -1, -2)                    # (..., l, n1, n2loc)
        outs = []
        for k, i in enumerate(sel):
            tabs = self.fntt.mxu_tables(i)
            lo, hi = up.split64(y[..., k, :, :])
            lo, hi = MX._stage(lo, hi, jnp.asarray(tabs.a1i), tabs, -2)
            lo, hi = MX._strict(lo, hi, tabs)
            outs.append(up.join64(lo, hi))
        return jnp.stack(outs, axis=-3).reshape(lead + (len(sel), -1))

    def ntt(self, a, idx: Sequence[int]):
        """coeff local flat (..., l, N/D) [(n1, n2loc)-order] →
        eval local flat [(n2, n1loc)-order]."""
        sel = list(idx)
        if self.impl == "mxu":
            return self._ntt_mxu(a, sel)
        lead = a.shape[:-1]
        n2loc = self.n2 // self.D
        y = a.reshape(lead + (self.n1, n2loc))
        tw_w, tw_sh = (self._slice_cols(t, sel) for t in self._twist)
        td_w, td_sh = (self._slice_cols(t, sel) for t in self._twiddle)
        y = _per_limb_mul(y, tw_w, tw_sh, self._qs[sel])
        y = _per_limb_stage(y, self._gs1, sel, self._qs, self.n1, _col_gs64)
        y = _per_limb_mul(y, td_w, td_sh, self._qs[sel])
        y = jax.lax.all_to_all(y, self.axis, split_axis=y.ndim - 2,
                               concat_axis=y.ndim - 1, tiled=True)
        y = jnp.swapaxes(y, -1, -2)           # (..., n2, n1/D)
        y = _per_limb_stage(y, self._gs2, sel, self._qs, self.n2, _col_gs64)
        return y.reshape(lead + (-1,))

    def intt(self, a, idx: Sequence[int]):
        """eval local flat [(n2, n1loc)-order] → coeff local flat
        [(n1, n2loc)-order]."""
        sel = list(idx)
        if self.impl == "mxu":
            return self._intt_mxu(a, sel)
        lead = a.shape[:-1]
        n1loc = self.n1 // self.D
        y = a.reshape(lead + (self.n2, n1loc))
        y = _per_limb_stage(y, self._ct2, sel, self._qs, self.n2, _col_ct64)
        y = jax.lax.all_to_all(y, self.axis, split_axis=y.ndim - 2,
                               concat_axis=y.ndim - 1, tiled=True)
        y = jnp.swapaxes(y, -1, -2)           # (..., n1, n2/D)
        itd_w, itd_sh = (self._slice_cols(t, sel) for t in self._itwiddle)
        itw_w, itw_sh = (self._slice_cols(t, sel) for t in self._itwist)
        y = _per_limb_mul(y, itd_w, itd_sh, self._qs[sel])
        y = _per_limb_stage(y, self._ct1, sel, self._qs, self.n1, _col_ct64)
        y = _per_limb_mul(y, itw_w, itw_sh, self._qs[sel])
        return y.reshape(lead + (-1,))


def _per_limb_mul(y, w, sh, qs):
    """Shoup-multiply (..., l, m, lanes) by per-limb (l, m, lanes) tables."""
    from ..core.modarith import shoup_mul

    outs = [
        shoup_mul(y[..., i, :, :], w[i], sh[i], jnp.uint64(qs[i]))
        for i in range(y.shape[-3])
    ]
    return jnp.stack(outs, axis=-3)


def _per_limb_stage(y, tab, sel, qs, m, col_fn):
    """Run a per-limb column NTT stage chain (tables differ per modulus)."""
    w, sh = tab
    outs = [
        col_fn(y[..., k, :, :], w[i], sh[i], jnp.uint64(qs[i]), m)
        for k, i in enumerate(sel)
    ]
    return jnp.stack(outs, axis=-3)


# ---------------------------------------------------------------------------
# Boundary reshapes: standard flat arrays <-> sharded matrix views
# ---------------------------------------------------------------------------

def eval_matrix(x, n1: int, n2: int):
    """Flat eval-order (..., N) → (..., n2, n1) matrix (shard last axis)."""
    return x.reshape(x.shape[:-1] + (n2, n1))


def eval_flat(x):
    return x.reshape(x.shape[:-2] + (-1,))


def _eval_spec(ndim: int, axis: str):
    return P(*([None] * (ndim - 1) + [axis]))


# ---------------------------------------------------------------------------
# Sharded ops (public API): standard flat arrays in, flat out
# ---------------------------------------------------------------------------

def re_encrypt_sharded(sctx: ShardedEvalContext, ct: Ciphertext,
                       rekey: KeySwitchKey) -> Ciphertext:
    """changeCipherDomain with the key switch executed coefficient-sharded
    over the coef axis (bit-exact vs the replicated path)."""
    n1, n2, ax = sctx.n1, sctx.n2, sctx.axis
    l = ct.nlimbs
    mont = rekey.mont

    def body(c_m, rk_m):
        # locals: eval matrices (..., n2, n1/D) → flat (..., N/D)
        c = eval_flat(c_m)
        rk = eval_flat(rk_m)
        q, _, _ = sctx.limb_consts(sctx.q_idx(l))
        d0, d1 = ev.keyswitch(sctx, c[1], KeySwitchKey(data=rk, mont=mont), l)
        return eval_matrix(jnp.stack([modadd(c[0], d0, q), d1]),
                           n1 // sctx.D, n2)

    fn = sctx.cached_jit(("reenc", l), lambda: jax.jit(jax.shard_map(
        body, mesh=sctx.mesh, check_vma=False,
        in_specs=(_eval_spec(4, ax), _eval_spec(5, ax)),
        out_specs=_eval_spec(4, ax),
    )))
    out = fn(eval_matrix(ct.data, n1, n2), eval_matrix(rekey.data, n1, n2))
    return Ciphertext(data=eval_flat(out), scale=ct.scale)


def _gather_full(sctx: ShardedEvalContext, y):
    """all_gather a local flat (..., N/D) eval-order poly into the full flat
    (..., N) eval vector (called INSIDE the shard_map body). Split out of the
    automorphism so a batch of rotations on the same poly gathers ONCE."""
    n1, n2, D = sctx.n1, sctx.n2, sctx.D
    n1loc = n1 // D
    lead = y.shape[:-1]
    ym = y.reshape(lead + (n2, n1loc))
    gathered = jax.lax.all_gather(ym, sctx.axis)          # (D, ..., n2, n1loc)
    return jnp.moveaxis(gathered, 0, -2).reshape(lead + (n2 * n1,))


def _perm_local(sctx: ShardedEvalContext, full, g: int):
    """This shard's n1-column block of the automorphism X→X^g applied to a
    gathered full eval vector (new[k] = old[perm[k]], perm from
    :meth:`CkksContext.galois_perm` which corrects for the four-step eval
    order). The permutation itself is free (static gather indices)."""
    n1, n2, D = sctx.n1, sctx.n2, sctx.D
    n1loc = n1 // D
    pm = np.asarray(sctx.galois_perm(g)).reshape(n2, n1)
    i = jax.lax.axis_index(sctx.axis)
    my_src = jax.lax.dynamic_slice_in_dim(jnp.asarray(pm, jnp.int32),
                                          i * n1loc, n1loc, axis=1)
    return jnp.take(full, my_src.reshape(-1), axis=-1)


def _automorphism_local(sctx: ShardedEvalContext, y, g: int):
    """Galois automorphism on a coefficient-sharded eval-domain poly: one
    all_gather over the coef axis, then a static local slice of the global
    bin permutation."""
    return _perm_local(sctx, _gather_full(sctx, y), g)


def _galois_keyswitch_sharded(sctx: ShardedEvalContext, ct: Ciphertext,
                              g: int, key: KeySwitchKey) -> Ciphertext:
    """Shared body for sharded rotate/conjugate: automorphism X→X^g on both
    components + one sharded key switch of c1' (compiled once per (g, l))."""
    n1, n2, ax = sctx.n1, sctx.n2, sctx.axis
    l = ct.nlimbs
    mont = key.mont

    def build():
        def body(c_m, rk_m):
            c = eval_flat(c_m)
            rk = eval_flat(rk_m)
            q, _, _ = sctx.limb_consts(sctx.q_idx(l))
            c0p = _automorphism_local(sctx, c[0], g)
            c1p = _automorphism_local(sctx, c[1], g)
            d0, d1 = ev.keyswitch(sctx, c1p, KeySwitchKey(data=rk, mont=mont), l)
            return eval_matrix(jnp.stack([modadd(c0p, d0, q), d1]),
                               n1 // sctx.D, n2)

        return jax.jit(jax.shard_map(
            body, mesh=sctx.mesh, check_vma=False,
            in_specs=(_eval_spec(4, ax), _eval_spec(5, ax)),
            out_specs=_eval_spec(4, ax),
        ))

    fn = sctx.cached_jit(("galois", g, l), build)
    out = fn(eval_matrix(ct.data, n1, n2), eval_matrix(key.data, n1, n2))
    return Ciphertext(data=eval_flat(out), scale=ct.scale)


def rotate_sharded(sctx: ShardedEvalContext, ct: Ciphertext, r: int,
                   rot_key: KeySwitchKey) -> Ciphertext:
    """EvalRotate with both the automorphism and the key switch executed
    coefficient-sharded (bit-exact vs eval.rotate on the replicated path)."""
    return _galois_keyswitch_sharded(
        sctx, ct, ev.rot_to_galois(r, sctx.params.n), rot_key)


def conjugate_sharded(sctx: ShardedEvalContext, ct: Ciphertext,
                      conj_key: KeySwitchKey) -> Ciphertext:
    """EvalConj sharded (automorphism g = 2N−1)."""
    return _galois_keyswitch_sharded(sctx, ct, 2 * sctx.params.n - 1, conj_key)


def rotate_hoisted_sharded(sctx: ShardedEvalContext, ct: Ciphertext,
                           rotations: Sequence[int], rot_keys: dict) -> list:
    """Hoisted rotations, sharded: ONE sharded decompose+extend
    (keyswitch_core), then per rotation the automorphism permutes the
    extended digits/c0 (all_gather each) and the cheap inner product runs
    per-shard. Mirrors eval.rotate_hoisted (automorphism commutes with the
    coefficient-wise base extension)."""
    n1, n2, ax = sctx.n1, sctx.n2, sctx.axis
    l = ct.nlimbs
    gs = tuple(ev.rot_to_galois(r, sctx.params.n) for r in rotations)
    mont = all(rot_keys[r].mont for r in rotations)

    def build():
        def body(c_m, *rk_ms):
            c = eval_flat(c_m)
            q, _, _ = sctx.limb_consts(sctx.q_idx(l))
            digits = ev.keyswitch_core(sctx, c[1], l)
            # gather the extended digits and c0 ONCE — identical across
            # rotations, so hoist the all_gathers out of the g loop (the
            # per-g work is then a free static permutation slice + the
            # cheap inner product).
            digits_full = [_gather_full(sctx, d) for d in digits]
            c0_full = _gather_full(sctx, c[0])
            outs = []
            for g, rk_m in zip(gs, rk_ms):
                rk = KeySwitchKey(data=eval_flat(rk_m), mont=mont)
                dig_rot = [_perm_local(sctx, d, g) for d in digits_full]
                d0, d1 = ev.keyswitch_apply(sctx, dig_rot, rk, l)
                c0p = _perm_local(sctx, c0_full, g)
                outs.append(jnp.stack([modadd(c0p, d0, q), d1]))
            return tuple(eval_matrix(o, n1 // sctx.D, n2) for o in outs)

        return jax.jit(jax.shard_map(
            body, mesh=sctx.mesh, check_vma=False,
            in_specs=(_eval_spec(4, ax),) + (_eval_spec(5, ax),) * len(rotations),
            out_specs=(_eval_spec(4, ax),) * len(rotations),
        ))

    fn = sctx.cached_jit(("hoisted", gs, l), build)
    outs = fn(eval_matrix(ct.data, n1, n2),
              *[eval_matrix(rot_keys[r].data, n1, n2) for r in rotations])
    return [Ciphertext(data=eval_flat(o), scale=ct.scale) for o in outs]


def _psum_mod(x, q, axis: str):
    """Modular psum (multikey._psum_mod pattern): raw u64 psum of < 16
    shards of residues < 2^60 cannot wrap; fold back into [0, q)."""
    s = jax.lax.psum(x, axis)
    for shift in (3, 2, 1, 0):
        step = q * jnp.uint64(1 << shift)
        s = jnp.where(s >= step, s - step, s)
    return s


def fedavg_round_sharded(sctx: ShardedEvalContext, stacks, rk12, rk21,
                         scale: float, client_axis: str = "client") -> tuple:
    """The full reference server round over a client × coef mesh.

    ``stacks``: u64[n_clients, B, 2, l, N] eval-order ciphertext stacks (every
    client's B ciphertexts), sharded over BOTH mesh axes. Per shard: PRE the
    local non-hub clients into the hub domain (sharded key switches; the hub
    client — the LAST one, the orchestrator's aggregation domain — is used
    as-is), modular psum over ``client`` for the FedAvg sum,
    EvalMult(1/n)+rescale, then PRE the aggregate back (reference flow
    server_fns.sh:62-80 generalized). Returns (agg, agg_back) flat global
    arrays, both replicated over client.
    """
    n1, n2, ax = sctx.n1, sctx.n2, sctx.axis
    n_clients = stacks.shape[0]
    B = stacks.shape[1]
    l = stacks.shape[3]
    q, _, _ = sctx.limb_consts(sctx.q_idx(l))

    def body(st_m, rk12_m, rk21_m):
        st = eval_flat(st_m)                      # (local_clients, B, 2, l, nloc)
        k12 = KeySwitchKey(data=eval_flat(rk12_m))
        k21 = KeySwitchKey(data=eval_flat(rk21_m))
        local_clients = st.shape[0]
        base = jax.lax.axis_index(client_axis) * local_clients
        # vmap over the B ciphertexts: each stage is traced once for all B
        # instead of unrolling B copies of the keyswitch graph

        def ks12(d):
            d0, d1 = ev.keyswitch(sctx, d[1], k12, l)
            return jnp.stack([modadd(d[0], d0, q), d1])

        acc = None
        for c in range(local_clients):
            ks = jax.vmap(ks12)(st[c])            # (B, 2, l, nloc)
            # hub = last client: its cts are already in the hub domain
            is_hub = (base + c) == (n_clients - 1)
            ks = jnp.where(is_hub, st[c], ks)
            acc = ks if acc is None else modadd(acc, ks, q)
        tot = _psum_mod(acc, q, client_axis)       # (B, 2, l, nloc)

        def avg_back(t):
            avg = ev.mult_scalar(sctx, Ciphertext(t, scale), 1.0 / n_clients)
            e0, e1 = ev.keyswitch(sctx, avg.data[1], k21, avg.nlimbs)
            back = jnp.stack([modadd(avg.data[0], e0, q[: avg.nlimbs]), e1])
            return avg.data, back

        outs_a, outs_b = jax.vmap(avg_back)(tot)
        return (eval_matrix(outs_a, n1 // sctx.D, n2),
                eval_matrix(outs_b, n1 // sctx.D, n2))

    fn = sctx.cached_jit(
        ("fedavg", client_axis, n_clients, B, l, float(scale)),
        lambda: jax.jit(jax.shard_map(
            body, mesh=sctx.mesh, check_vma=False,
            in_specs=(P(client_axis, None, None, None, None, ax),
                      _eval_spec(5, ax), _eval_spec(5, ax)),
            out_specs=(_eval_spec(5, ax), _eval_spec(5, ax)),
        )))
    agg_m, back_m = fn(eval_matrix(stacks, n1, n2),
                       eval_matrix(rk12, n1, n2), eval_matrix(rk21, n1, n2))
    return eval_flat(agg_m), eval_flat(back_m)

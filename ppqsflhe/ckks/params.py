"""CKKS-RNS parameters and crypto context.

JAX replacement for OpenFHE's ``GenCryptoContext(CCParams<
CryptoContextCKKSRNS>)`` + ``CryptoContextCKKSRNS`` parameter objects
(reference call sites: server/src/genCC.cpp:32-79). The context owns:

- the RNS modulus chains: ciphertext chain Q = [q0..qL] (q0 largest/"first
  modulus", rescale drops the highest active index — OpenFHE tower order,
  SURVEY.md §2.3) and the hybrid-key-switch special primes P;
- one :class:`~ppqsflhe.core.ntt.NttBasis` over the concatenated QP basis
  (per-op transforms slice its limb-major tables);
- per-limb Montgomery constants and lazily-cached per-level rescale /
  base-extension precomputes.

The checked-in reference artifacts pin an exact chain (REFERENCE_MODULI /
REFERENCE_ROOTS, decoded from client_1-private.key — SURVEY.md §2.3); use
``CkksParams.reference()`` for bit-compatible interop tests.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Dict, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import primes
from ..core.modarith import U64
from ..core.ntt import NttBasis
from ..core.rns import BaseExtender

# Decoded from /root/reference/client/storage/client_1/private/client_1-private.key
# (cereal-JSON DCRTPoly towers, fields cm/v and ru/v): SURVEY.md §2.3.
REFERENCE_MODULI = (1152921504606748673, 1099510054913, 1099511922689, 557057)
REFERENCE_ROOTS = (62213374832584, 42618759, 36692422, 19)


# ntt_impl names that earlier contexts were saved with, mapped to the
# plain-JAX path computing the same four-step transform (same eval order,
# so every artifact made under the old name stays valid).
_RETIRED_NTT_IMPLS = {"pallas": "xla", "pallas_mxu": "mxu"}


def canonical_ntt_impl(name: str) -> str:
    """The ntt_impl to run for a name read from a config or a context."""
    name = _RETIRED_NTT_IMPLS.get(name, name)
    if name not in ("xla", "mxu"):
        raise ValueError(f"unknown ntt_impl {name!r} (xla or mxu)")
    return name


@dataclass(frozen=True)
class CkksParams:
    """Static scheme parameters (hashable; everything derived lives on the
    context)."""

    n: int = 1 << 14                  # ring dimension (reference: 16384)
    q_moduli: Tuple[int, ...] = ()    # ciphertext modulus chain [q0..qL]
    p_moduli: Tuple[int, ...] = ()    # special primes for hybrid keyswitch
    q_roots: Tuple[int, ...] | None = None   # optional pinned 2N-th roots (Q)
    p_roots: Tuple[int, ...] | None = None
    scale_bits: int = 40              # Δ = 2^scale_bits (reference: 40)
    dnum: int = 2                     # hybrid KS digit count (reference: 2)
    slots: int = 0                    # batch size; 0 → N/2 (reference: 8192)
    sigma: float = 3.19
    # NTT backend: 'radix2' (stage-unrolled, std bit-reversed eval order) or
    # 'fourstep' (matrix-shaped factorization, kernel eval order; see
    # ops/fourstep.py). Orders differ only internally: all pointwise ops
    # are order-agnostic and Galois permutations are order-corrected by
    # CkksContext.galois_perm.
    ntt_backend: str = "radix2"
    ntt_impl: str = "xla"             # 'xla' | 'mxu' (fourstep only)
    # FLEXIBLEAUTOEXT (the reference's rs=3, SURVEY.md §2.3): the chain ends
    # with a small extra prime; fresh plaintexts encode at Δ·q_ext and the
    # extension limb is auto-dropped before the first multiplication, so a
    # depth-d circuit uses d+2 towers like OpenFHE's.
    flexible_ext: bool = False
    # PRE security mode (genCC.cpp:55-58 PREMode; tested bounds
    # test/server/src/test_s_CC.cpp: PREMode ∈ {INDCPA, INDCCA}).
    # 'INDCPA': ReEncrypt = one key switch (the reference's configured mode).
    # 'INDCCA': HRA-hardened — every ReEncrypt additionally re-randomizes
    # with a fresh encryption of zero under the TARGET public key plus
    # uniform flooding noise (pre_flood_bits), so a re-encrypted ciphertext
    # is statistically unlinkable to its input even given honest
    # re-encryption oracle access. Default 30 matches the reference
    # context's ss=30 parameter (SURVEY.md §2.3; like threshold smudging,
    # the ACHIEVED statistical distance is 2^-(30 − keyswitch-noise bits) —
    # see ckks/threshold.py and docs/SECURITY.md). Precision cost at
    # Δ=2^40: ≈ √(N/2)·2^-10 absolute per slot (~0.01-0.1 on the
    # reference payload).
    pre_mode: str = "INDCPA"
    pre_flood_bits: int = 30

    @staticmethod
    def generate(
        n: int = 1 << 14,
        mult_depth: int = 2,
        scale_bits: int = 40,
        first_mod_bits: int = 60,
        dnum: int = 2,
        slots: int = 0,
        extra_mod_bits: int = 0,
        ntt_backend: str = "radix2",
        ntt_impl: str = "xla",
    ) -> "CkksParams":
        """Build a fresh NTT-friendly chain, OpenFHE-style: one first modulus
        of ``first_mod_bits``, ``mult_depth`` scaling primes of ``scale_bits``
        and optionally a FLEXIBLEAUTOEXT-style small extra prime."""
        m = 2 * n
        q = [primes.first_prime_down(first_mod_bits, m)]
        q += primes.prime_chain(scale_bits, mult_depth, m, avoid=set(q))
        flexible_ext = False
        if extra_mod_bits:
            q += [primes.next_prime_up(1 << (extra_mod_bits - 1), m)]
            flexible_ext = True
        # Special primes: enough 60-bit primes to cover the largest KS digit.
        alpha = -(-len(q) // dnum)
        digit_bits = max(
            sum(int(x).bit_length() for x in q[i * alpha : (i + 1) * alpha])
            for i in range(dnum)
        )
        n_special = max(1, -(-digit_bits // 60))
        p = primes.prime_chain(60, n_special, m, avoid=set(q))
        return CkksParams(
            n=n, q_moduli=tuple(q), p_moduli=tuple(p),
            scale_bits=scale_bits, dnum=dnum, slots=slots or n // 2,
            ntt_backend=ntt_backend, ntt_impl=ntt_impl,
            flexible_ext=flexible_ext,
        )

    @staticmethod
    def reference(slots: int = 8192) -> "CkksParams":
        """The exact parameter set of the checked-in reference artifacts."""
        q = REFERENCE_MODULI
        m = 2 * (1 << 14)
        p = tuple(primes.prime_chain(60, 2, m, avoid=set(q)))
        return CkksParams(
            n=1 << 14, q_moduli=q, p_moduli=p, q_roots=REFERENCE_ROOTS,
            scale_bits=40, dnum=2, slots=slots,
        )

    @staticmethod
    def reference_shaped(n: int) -> "CkksParams":
        """The reference chain at N=2^14; at other ring dimensions a fresh
        chain of the same shape (60-bit first modulus, two 40-bit scaling
        primes, a 20-bit extension prime, dnum 2)."""
        if n == 1 << 14:
            return CkksParams.reference()
        return CkksParams.generate(n=n, mult_depth=2, scale_bits=40,
                                   extra_mod_bits=20, dnum=2)

    @property
    def num_q(self) -> int:
        return len(self.q_moduli)

    @property
    def num_p(self) -> int:
        return len(self.p_moduli)

    @property
    def scale(self) -> float:
        return float(2 ** self.scale_bits)

    def security_bits(self) -> int:
        """Conservative classical security estimate from the HE-standard
        tables (homomorphicencryption.org v1.1, ternary secret): returns the
        largest standard level (128/192/256) whose log2(QP) bound admits
        this parameter set, or 0 if below 128-bit. The reference context
        uses HEStd_NotSet (slv=0, SURVEY.md §2.3) — ring dim taken as given
        — so this is a diagnostic, not a gate."""
        logqp = 0
        for q in self.q_moduli + self.p_moduli:
            logqp += int(q).bit_length()
        # HE-standard max log2(Q) for ternary secrets (classical)
        table = {
            1024: (27, 19, 14), 2048: (54, 37, 29), 4096: (109, 75, 58),
            8192: (218, 152, 118), 16384: (438, 305, 237),
            32768: (881, 611, 476), 65536: (1772, 1228, 956),
        }
        n = self.n
        key = min((k for k in table if k >= n), default=None)
        if key is None:
            return 256  # beyond table: deeply conservative rings
        b128, b192, b256 = table[key]
        if logqp <= b256:
            return 256
        if logqp <= b192:
            return 192
        if logqp <= b128:
            return 128
        return 0


def _const_stack(vals, fn=lambda x: x):
    # NOTE: returns host numpy (not jnp) so lazily-built precomputes are safe
    # to cache and reuse across jit traces (a device array created inside a
    # trace is a tracer and must not escape).
    return np.array([fn(v) for v in vals], np.uint64).reshape(-1, 1)


class SecurityWarning(UserWarning):
    """Raised (as a warning) when a context is built below 128-bit security."""


class CkksContext:
    """Derived tables + lazily cached per-level precomputes."""

    def __init__(self, params: CkksParams):
        self.params = params
        # The reference runs HEStd_NotSet (SURVEY.md §2.3) — parameters are
        # taken as given — but silently accepting a sub-128-bit chain is a
        # footgun, so surface the estimate at build time (genCC twin).
        bits = params.security_bits()
        if bits < 128:
            import warnings

            warnings.warn(
                f"CKKS parameters (N={params.n}, log2(QP)="
                f"{sum(int(q).bit_length() for q in params.q_moduli + params.p_moduli)}) "
                f"fall below 128-bit HE-standard security (estimate: {bits}-bit)",
                SecurityWarning,
                stacklevel=2,
            )
        self.moduli_qp = tuple(params.q_moduli) + tuple(params.p_moduli)
        roots = None
        if params.q_roots is not None:
            p_roots = params.p_roots or tuple(
                primes.root_of_unity(2 * params.n, p) for p in params.p_moduli
            )
            roots = tuple(params.q_roots) + p_roots
        self.basis = NttBasis(params.n, self.moduli_qp, roots)
        self.fntt = None
        if params.ntt_backend == "fourstep":
            from ..ops.fourstep import FourStepNtt

            self.fntt = FourStepNtt(params.n, self.moduli_qp, self.basis.psis)
        self._galois_cache: Dict[int, np.ndarray] = {}

        qp = self.moduli_qp
        self.q_vec = _const_stack(qp)                                   # (L+K, 1)
        self.qinv_vec = _const_stack(qp, primes.mont_qinv_neg)
        self.r2_vec = _const_stack(qp, primes.mont_r2)
        self._ext_cache: Dict[tuple, BaseExtender] = {}
        self._rescale_cache: Dict[int, tuple] = {}
        self._moddown_cache: Dict[int, tuple] = {}
        self._ks_decomp_cache: Dict[int, tuple] = {}  # eval._ks_decomp_consts

        # Digit partition of Q limb indices for hybrid KS (fixed at keygen).
        L = params.num_q
        alpha = -(-L // params.dnum)
        self.digit_groups: Tuple[Tuple[int, ...], ...] = tuple(
            tuple(range(i * alpha, min((i + 1) * alpha, L)))
            for i in range(params.dnum)
            if i * alpha < L
        )

    # -- limb index helpers -------------------------------------------------

    def q_idx(self, nlimbs: int) -> Tuple[int, ...]:
        return tuple(range(nlimbs))

    def p_idx(self) -> Tuple[int, ...]:
        L = self.params.num_q
        return tuple(range(L, L + self.params.num_p))

    def limb_consts(self, idx: Sequence[int]):
        sel = np.asarray(idx, dtype=np.int32)
        return self.q_vec[sel], self.qinv_vec[sel], self.r2_vec[sel]

    # -- NTT on limb subsets ------------------------------------------------

    # The named scopes mark every limb transform in the compiled module's
    # op metadata, so a profiler trace can attribute device time to them.

    @jax.named_scope("ntt")
    def ntt(self, a, idx: Sequence[int]):
        if self.fntt is not None:
            return self.fntt.ntt(a, implementation=self.params.ntt_impl,
                                 idx=tuple(idx))
        from ..core.ntt import _ntt_impl

        sel = np.asarray(idx, dtype=np.int32)
        return _ntt_impl(
            a, self.basis.psi_rev[sel], self.basis.psi_rev_shoup[sel],
            self.basis.q_vec[sel], self.params.n,
        )

    @jax.named_scope("intt")
    def intt(self, a, idx: Sequence[int]):
        if self.fntt is not None:
            return self.fntt.intt(a, implementation=self.params.ntt_impl,
                                  idx=tuple(idx))
        from ..core.ntt import _intt_impl

        sel = np.asarray(idx, dtype=np.int32)
        return _intt_impl(
            a, self.basis.ipsi_rev[sel], self.basis.ipsi_rev_shoup[sel],
            self.basis.ninv[sel], self.basis.ninv_shoup[sel],
            self.basis.q_vec[sel], self.params.n,
        )

    def galois_perm(self, g: int) -> np.ndarray:
        """Eval-order permutation for the automorphism X→X^g, corrected for
        the active NTT backend's eval ordering (new[i] = old[perm[i]])."""
        if g not in self._galois_cache:
            from .eval import _galois_perm

            P = _galois_perm(self.params.n, g)
            if self.fntt is not None:
                T = self.fntt.perm_to_std
                Tinv = np.argsort(T)
                P = T[P[Tinv]]
            self._galois_cache[g] = P.astype(np.int32)
        return self._galois_cache[g]

    # -- cached precomputes --------------------------------------------------

    def extender(self, src_idx: Tuple[int, ...], dst_idx: Tuple[int, ...]) -> BaseExtender:
        key = (src_idx, dst_idx)
        if key not in self._ext_cache:
            src = [self.moduli_qp[i] for i in src_idx]
            dst = [self.moduli_qp[i] for i in dst_idx]
            self._ext_cache[key] = BaseExtender(src, dst)
        return self._ext_cache[key]

    def rescale_consts(self, nlimbs: int):
        """Constants for dropping limb (nlimbs-1): for each remaining limb i,
        [q_dropped^{-1}]_{q_i} with Shoup companion, and [q_dropped]_{q_i}."""
        if nlimbs not in self._rescale_cache:
            ql = self.moduli_qp[nlimbs - 1]
            rem = [self.moduli_qp[i] for i in range(nlimbs - 1)]
            inv = [primes.mod_inverse(ql % q, q) for q in rem]
            self._rescale_cache[nlimbs] = (
                _const_stack(inv),
                np.array([primes.shoup_precompute(v, q) for v, q in zip(inv, rem)],
                         np.uint64).reshape(-1, 1),
                _const_stack([ql % q for q in rem]),
                np.array([primes.shoup_precompute(ql % q, q) for q in rem],
                         np.uint64).reshape(-1, 1),
            )
        return self._rescale_cache[nlimbs]

    def moddown_consts(self, nlimbs: int):
        """Constants for exact-ish division by P over the first nlimbs Q limbs:
        [P^{-1}]_{q_i} (+Shoup)."""
        if nlimbs not in self._moddown_cache:
            P = 1
            for p in self.params.p_moduli:
                P *= p
            qs = [self.moduli_qp[i] for i in range(nlimbs)]
            inv = [primes.mod_inverse(P % q, q) for q in qs]
            self._moddown_cache[nlimbs] = (
                _const_stack(inv),
                np.array([primes.shoup_precompute(v, q) for v, q in zip(inv, qs)],
                         np.uint64).reshape(-1, 1),
            )
        return self._moddown_cache[nlimbs]

    @functools.lru_cache(maxsize=None)
    def p_mod_q(self, nlimbs: int):
        """[P]_{q_i} for active limbs, as (nlimbs,1) u64."""
        P = 1
        for p in self.params.p_moduli:
            P *= p
        return _const_stack([P % self.moduli_qp[i] for i in range(nlimbs)])

    @functools.lru_cache(maxsize=None)
    def digit_g_mod_q(self, nlimbs: int):
        """Hybrid-KS CRT reconstruction factors per digit at a given level.

        For active basis Q_l = prod of first ``nlimbs`` q's partitioned into
        digit groups D_j (intersected with active limbs):
            g_j = (Q_l/D_j) * [(Q_l/D_j)^{-1}]_{D_j}  mod Q_l
        returned as residues over the active limbs: u64[ndigits, nlimbs, 1].
        """
        active = list(range(nlimbs))
        groups = [tuple(i for i in g if i < nlimbs) for g in self.digit_groups]
        groups = [g for g in groups if g]
        Q = 1
        for i in active:
            Q *= self.moduli_qp[i]
        out = np.zeros((len(groups), nlimbs, 1), np.uint64)
        for j, g in enumerate(groups):
            Dj = 1
            for i in g:
                Dj *= self.moduli_qp[i]
            Qt = Q // Dj
            gj = Qt * primes.mod_inverse(Qt % Dj, Dj) % Q
            for i in active:
                out[j, i, 0] = gj % self.moduli_qp[i]
        return out, groups

"""CKKS canonical-embedding encode/decode.

Replaces OpenFHE's ``MakeCKKSPackedPlaintext`` / ``GetRealPackedValue``
(reference call sites: client/src/encryptModelWeights.cpp:82-110,
decryptModelWeights.cpp:81-110). Slot i of a packed vector lives at the
primitive 2N-th root ξ^{5^i} (ξ = e^{iπ/N}), so Galois rotations by g=5^r are
cyclic slot shifts; the conjugate half carries the mirrored values, making
coefficients real.

This is a *host boundary* op by design: Δ=2^40 encoding needs ~50-bit
mantissas, so the O(N log N) twisted FFT runs in numpy f64 on the host (microseconds at N=2^14) while all ring arithmetic stays on device.
Scalar (all-slots-equal) values encode exactly as constant polynomials with
no FFT at any scale — that path covers the reference's EvalMult(ct, 0.5)
(server/src/aggregateEncryptedWeights.cpp:83) without precision loss.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..core.rns import decompose_int


class Encoder:
    def __init__(self, n: int, slots: int | None = None):
        self.n = n
        self.slots = slots or n // 2
        if self.n % (2 * self.slots) != 0:
            raise ValueError("slots must divide N/2")
        m = 2 * n
        # slot i ↔ root exponent 5^i mod 2N; FFT bin k_i = (5^i - 1)/2
        g = 1
        idx = np.zeros(n // 2, dtype=np.int64)
        for i in range(n // 2):
            idx[i] = (g - 1) // 2
            g = (g * 5) % m
        self.slot_to_bin = idx
        self.conj_bin = (n - 1) - idx  # bin of exponent 2N - 5^i
        j = np.arange(n)
        self.twist = np.exp(1j * np.pi * j / n)        # ξ^j
        self.itwist = np.conj(self.twist)

    # -- vector packing -----------------------------------------------------

    def encode(self, values, scale: float) -> np.ndarray:
        """Real/complex vector (≤ slots entries) → integer coefficients
        (int64 numpy, centered). Shorter vectors are zero-padded to ``slots``;
        sparse packing replicates across N/2 (OpenFHE semantics)."""
        z = np.zeros(self.slots, dtype=np.complex128)
        v = np.asarray(values)
        if v.size > self.slots:
            raise ValueError(f"{v.size} values > {self.slots} slots")
        z[: v.size] = v
        reps = (self.n // 2) // self.slots
        zfull = np.tile(z, reps)
        evals = np.zeros(self.n, dtype=np.complex128)
        evals[self.slot_to_bin] = zfull * scale
        evals[self.conj_bin] = np.conj(zfull) * scale
        coeffs = (np.fft.fft(evals) / self.n) * self.itwist
        return np.round(coeffs.real).astype(np.int64)

    def decode(self, coeffs, scale: float, num: int | None = None) -> np.ndarray:
        """Centered f64/int coefficients → complex slot values (first `num`)."""
        a = np.asarray(coeffs, dtype=np.float64) * self.twist
        evals = self.n * np.fft.ifft(a)
        z = evals[self.slot_to_bin[: self.slots]] / scale
        return z[: num if num is not None else self.slots]

    def encode_batch(self, values_list, scale: float) -> np.ndarray:
        """Batched :meth:`encode`: many vectors → int64[B, N] via ONE stacked
        FFT instead of B sequential host FFTs (the reference's per-layer
        chunk loop, encryptModelWeights.cpp:67-119, produces hundreds of
        vectors per call — at 16 clients × 154 chunks the serial path is
        thousands of host FFTs)."""
        B = len(values_list)
        z = np.zeros((B, self.slots), dtype=np.complex128)
        for i, v in enumerate(values_list):
            v = np.asarray(v)
            if v.size > self.slots:
                raise ValueError(f"{v.size} values > {self.slots} slots")
            z[i, : v.size] = v
        reps = (self.n // 2) // self.slots
        zfull = np.tile(z, (1, reps))
        evals = np.zeros((B, self.n), dtype=np.complex128)
        evals[:, self.slot_to_bin] = zfull * scale
        evals[:, self.conj_bin] = np.conj(zfull) * scale
        coeffs = (np.fft.fft(evals, axis=-1) / self.n) * self.itwist
        return np.round(coeffs.real).astype(np.int64)

    # -- exact constant path ------------------------------------------------

    def encode_constant(self, c: float, scale: float) -> int:
        """All-slots-equal constant → the single integer round(c*scale)."""
        return int(round(c * scale))

    # -- RNS helpers ---------------------------------------------------------

    def to_rns(self, coeffs_int, moduli: Sequence[int]) -> np.ndarray:
        """Centered integer coefficients → residue stack u64[L, N]."""
        return decompose_int(coeffs_int, moduli)

    def to_rns_batch(self, coeffs_int64: np.ndarray, moduli: Sequence[int]) -> np.ndarray:
        """int64[B, N] (machine-width — the encode_batch output; Δ·|v| ≪ 2^63)
        → u64[B, L, N], vectorized (no per-element Python bigint loop)."""
        x = np.asarray(coeffs_int64, dtype=np.int64)
        out = np.empty((x.shape[0], len(moduli), x.shape[1]), dtype=np.uint64)
        for i, q in enumerate(moduli):
            out[:, i, :] = np.mod(x, np.int64(q)).astype(np.uint64)
        return out

"""ppqsflhe — multikey-CKKS federated learning framework in JAX.

A from-scratch re-design of the CDACHPCIE25/PPQSFLHE privacy-preserving
federated-learning pipeline (reference: GRU clients + OpenFHE CKKS + proxy
re-encryption + Mongoose HTTP) as an idiomatic JAX/XLA framework:

- ``core``      : RNS modular arithmetic (u64 lanes, Montgomery/Shoup) and
                  negacyclic NTT/iNTT — the DCRTPoly replacement.
- ``ckks``      : RNS-CKKS scheme — encoding, RLWE keygen/encrypt/decrypt,
                  homomorphic eval (add / mult / rescale / relinearize /
                  rotations with hoisting), hybrid key switching, proxy
                  re-encryption, multikey aggregation.
- ``ops``       : the four-step NTT (u32-pair and int8 digit-matmul forms)
                  and the coefficient-sharded NTT over a device mesh.
- ``fl``        : the federated-learning workload layer — the 7 reference
                  binaries (genCC, keyGen, REkeyGen, encryptModelWeights,
                  decryptModelWeights, changeCipherDomain,
                  aggregateEncryptedWeights) as Python APIs + CLIs with the
                  reference's file contracts.
- ``train``     : JAX GRU local trainer (replaces the Keras client).
- ``comm``      : HTTP artifact exchange (reference: server/src/runMserver.cpp)
                  + metrics CSVs.
- ``orchestration``: rounds driver (reference: orchestration/run.sh).
- ``parallel``  : mesh/axis helpers for client/limb/coefficient sharding.

The integer compute path requires 64-bit lanes; importing this package enables
``jax_enable_x64``. Model training stays f32 — f64 is only used on host for
encode/decode.
"""

import os as _os

import jax as _jax

_jax.config.update("jax_enable_x64", True)

# Persistent compilation cache: the fused crypto graphs take seconds to
# minutes to compile. JAX reads JAX_COMPILATION_CACHE_DIR itself; without it
# the cache lives at a fixed path in the checkout, so every process of this
# checkout finds what an earlier one compiled.
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _cache = _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))), ".jax_cache")
    _os.makedirs(_cache, exist_ok=True)
    _jax.config.update("jax_compilation_cache_dir", _cache)
_jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.3)

__version__ = "0.1.0"

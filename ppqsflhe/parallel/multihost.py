"""Multi-host execution — the jax.distributed replacement for the
reference's HTTP file hops between hosts (SURVEY.md §2.6: "DCN
(jax.distributed multi-host) replacing the HTTP hops for key/ciphertext
distribution").

One process per host joins a ``jax.distributed`` cluster; the global device
mesh spans every host's chips with the ``client`` axis laid out
process-major, so each host keeps ITS clients' ciphertext residues local
and the encrypted FedAvg / threshold fusions become single ``psum``
collectives across hosts — no serialize→HTTP→deserialize round-trips on the data path. (The HTTP/file
control plane in :mod:`ppqsflhe.comm` remains available for WAN-grade
federation where hosts do not share a JAX cluster.)

Tested with multi-process CPU (gloo collectives) in
tests/test_multihost.py; on GPU hosts the same code runs with the
coordinator address, process count and process id passed explicitly.
"""

from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Join the jax.distributed cluster. Pass the arguments (or set the standard
    JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID env vars,
    which this reads as a convenience)."""
    kw = {}
    if coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS"):
        kw["coordinator_address"] = (coordinator_address
                                     or os.environ["JAX_COORDINATOR_ADDRESS"])
    if num_processes or os.environ.get("JAX_NUM_PROCESSES"):
        kw["num_processes"] = int(num_processes
                                  or os.environ["JAX_NUM_PROCESSES"])
    if process_id is not None or os.environ.get("JAX_PROCESS_ID"):
        pid = process_id if process_id is not None else os.environ["JAX_PROCESS_ID"]
        kw["process_id"] = int(pid)
    jax.distributed.initialize(**kw)


def global_client_mesh() -> Mesh:
    """All global devices on one ``client`` axis, process-major: device j of
    process p sits at position p·local_count + j, so a host's clients shard
    onto its own chips."""
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    return Mesh(np.array(devs), ("client",))


def host_local_array(mesh: Mesh, local_np: np.ndarray, axis: str = "client"):
    """Assemble the global (n_total, …) array whose shard on THIS host is
    ``local_np`` (shape (n_local, …)) — the zero-copy multi-host equivalent
    of stacking every client's upload on one server."""
    ndim = local_np.ndim
    sharding = NamedSharding(mesh, P(axis, *([None] * (ndim - 1))))
    return jax.make_array_from_process_local_data(sharding, local_np)


def aggregate_multihost(ctx, local_stack: np.ndarray, mesh: Mesh, scale: float,
                        n_clients_total: int, average: bool = True):
    """Cross-host encrypted FedAvg: ``local_stack`` is this host's
    (clients_local, B, k, l, n) ciphertext residues (already in the common
    key domain — PRE'd or joint-key). One modular psum over the global
    ``client`` axis; every host gets the replicated aggregate.

    Degenerate single-process case reduces to multikey.aggregate_sharded's
    semantics, so the same tests pin both."""
    from ..ckks.multikey import aggregate_sharded

    garr = host_local_array(mesh, local_stack)
    return aggregate_sharded(ctx, garr, mesh, scale, n_clients_total,
                             average=average)


def partial_decrypt_multihost(ctx, ct, s_eval_local: np.ndarray,
                              rng_local: np.ndarray, mesh: Mesh,
                              smudging_bits: int | None = None):
    """Cross-host threshold decryption: each host contributes its clients'
    smudged partials; one psum fuses them globally (ckks/threshold.py's
    partial_decrypt_psum over the multi-host mesh)."""
    from ..ckks import threshold as th

    if smudging_bits is None:
        smudging_bits = th.DEFAULT_SMUDGING_BITS
    s_g = host_local_array(mesh, s_eval_local)
    k_g = host_local_array(mesh, rng_local)
    return th.partial_decrypt_psum(ctx, ct, s_g, k_g, mesh,
                                   smudging_bits=smudging_bits)

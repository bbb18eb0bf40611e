"""Device-mesh axes for the framework's parallelism dimensions.

The reference's only parallelism is a bash loop over 2 client processes
(orchestration/client_fns.sh:37,66); SURVEY.md §2.5 maps its *logical*
structure onto a device mesh:

- ``client`` axis — federated data parallelism: each shard holds its clients'
  ciphertext residues; aggregation is a ``jax.lax.psum`` over this axis.
- ``limb`` axis — RNS tower parallelism (the reference computes towers
  sequentially on CPU): limb-major arrays shard naturally on dim -2.
- ``coef`` axis — polynomial-coefficient sharding for the distributed NTT
  (ops/sharded_ntt.py) — the sequence-parallel analogue.

All helpers work on any device set (the GPUs of one host, or the
CPU-virtual 8-device mesh used by the tests).
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(axis_sizes: dict[str, int] | None = None, devices=None) -> Mesh:
    """Build a mesh; default puts all devices on the `client` axis."""
    devices = list(devices if devices is not None else jax.devices())
    if axis_sizes is None:
        axis_sizes = {"client": len(devices)}
    names = tuple(axis_sizes)
    sizes = tuple(axis_sizes.values())
    if int(np.prod(sizes)) != len(devices):
        raise ValueError(f"mesh {axis_sizes} != {len(devices)} devices")
    arr = np.array(devices).reshape(sizes)
    return Mesh(arr, names)


def client_sharding(mesh: Mesh):
    """Sharding for a (n_clients, ...) ciphertext stack over the client axis."""
    extra = (None,) * 3
    return NamedSharding(mesh, P("client", *extra))


def limb_sharding(mesh: Mesh, ndim: int, limb_axis: int = -2):
    spec = [None] * ndim
    spec[limb_axis % ndim] = "limb"
    return NamedSharding(mesh, P(*spec))

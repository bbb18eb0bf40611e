"""Test configuration: the CPU backend with a virtual 8-device mesh, unless
JAX_PLATFORMS names another platform (GPU-only tests: ``JAX_PLATFORMS=
cuda,cpu python -m pytest -m gpu tests/``).

Must run before any jax import (pytest loads conftest first).
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

if jax.devices()[0].platform == "cpu":
    assert len(jax.devices()) >= 8, (
        "xla_force_host_platform_device_count=8 did not apply — XLA_FLAGS was "
        "already consumed; run pytest from a clean environment")


# ---------------------------------------------------------------------------
# Fast/slow lane split: `pytest -m "not slow"` is the core lane (<3 min);
# the full suite stays the round-close gate. Slow = >15 s on a 2-core host
# (measured via --durations). GPU-only tests carry the `gpu` marker and skip
# (inside a fixture) when JAX's first device is not a GPU.
# ---------------------------------------------------------------------------

import pytest  # noqa: E402

_SLOW_TESTS = {
    # sharded full-scheme bit-exactness (shard_map keyswitch pipelines)
    "test_rotate_sharded_bitexact",
    "test_re_encrypt_sharded_bitexact",
    "test_fedavg_round_sharded_bitexact",
    "test_fedavg_round_sharded_mxu_bitexact",
    "test_sharded_mxu_ntt_matches_replicated",
    # composed fourstep-backend rounds
    "test_fourstep_backend_full_round",
    "test_fourstep_backend_rotation",
    "test_fourstep_backend_ct_mult",
    # multi-process / orchestrated end-to-end
    "test_two_process_dcn_fedavg",
    "test_two_round_fl_run",
    "test_graft_entry_contract",
    "test_keygen_unseeded_end_to_end",
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: >15s end-to-end tests (excluded from the core lane)")
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skips elsewhere")


def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.name.split("[")[0] in _SLOW_TESTS:
            item.add_marker(pytest.mark.slow)

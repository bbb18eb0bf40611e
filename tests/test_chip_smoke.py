"""chip_smoke.py: it refuses to run without a GPU, and its kernel phase
holds on the CPU backend at a small ring. The orchestrated-round phase is
exercised in test_orchestrator.py."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu(tmp_path, alone):
    """No accelerator (JAX on the CPU), or no repository beside the script:
    a non-zero exit and no result line."""
    script = os.path.join(REPO, "chip_smoke.py")
    if alone:
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, str(script)], cwd=str(tmp_path),
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_kernel_phase_on_cpu():
    """Every portable NTT path and the key switch, bit-equal between two
    compilations on the CPU backend, at N=2^10."""
    import chip_smoke

    cpu = jax.devices("cpu")[0]
    chip_smoke.kernel_phase((1 << 10,), cpu, cpu, batch=2)


@pytest.fixture
def gpu():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda,cpu python -m pytest "
                    "-m gpu tests/")
    return dev


@pytest.mark.gpu
def test_kernel_phase_on_gpu(gpu):
    """The kernel phase at the reference ring, GPU against CPU."""
    import chip_smoke

    chip_smoke.kernel_phase((1 << 14,), gpu, jax.devices("cpu")[0], batch=2)

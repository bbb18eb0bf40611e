"""What the package needs from its installation: where it keeps its
compile cache, and that the main path runs without pandas."""

import csv
import json
import os
import subprocess
import sys
from datetime import datetime, timedelta

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code, env=None, timeout=600):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO, **(env or {}))
    return subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("from_env", [True, False])
def test_compile_cache_dir(tmp_path, from_env):
    """JAX_COMPILATION_CACHE_DIR, when set, is where the cache goes (the
    package sets none of its own); otherwise it is <checkout>/.jax_cache."""
    env = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)} if from_env else {}
    if not from_env:
        env["JAX_COMPILATION_CACHE_DIR"] = ""
    r = _run("import jax, ppqsflhe; print(jax.config.jax_compilation_cache_dir)",
             env)
    assert r.returncode == 0, r.stderr[-2000:]
    want = str(tmp_path) if from_env else os.path.join(REPO, ".jax_cache")
    assert r.stdout.strip().splitlines()[-1] == want


def test_orchestrator_runs_without_pandas(tmp_path):
    """One trained + encrypted FL round at ring 256 through the CLI with
    pandas blocked in sys.modules: the main path never imports it."""
    t0 = datetime(2024, 7, 1)
    rng = np.random.default_rng(0)
    clients = []
    for i in (1, 2):
        path = str(tmp_path / f"c{i}.csv")
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["Timestamp", "Data"])
            for h in range(10 * 24):
                w.writerow([(t0 + timedelta(hours=h)).strftime("%d-%m-%Y %H:%M"),
                            float(100 + 20 * np.sin(h / 24 * 2 * np.pi)
                                  + rng.normal(0, 2))])
        clients.append({"client_id": f"client_{i}", "data_file": path,
                        "train_end_date": "2024-07-08 23:00:00",
                        "test_start_date": "2024-07-09 00:00:00",
                        "lookback": 12, "epochs": 1})
    cfg = str(tmp_path / "oConfig.json")
    with open(cfg, "w") as f:
        json.dump({"ROUNDS": 1, "N_CLIENTS": 2, "COMM_MODE": "local",
                   "WORK_DIR": str(tmp_path / "run"), "FAIL_FAST": True,
                   "LAZY_LEVELS": True, "SEED": 3,
                   "CC_CONFIG": {"ring_dim": 256, "batch_size": 128,
                                 "multiplicative_depth": 2},
                   "CLIENT_CONFIGS": clients}, f)
    r = _run("import sys; sys.modules['pandas'] = None\n"
             "from ppqsflhe.orchestration.cli import main\n"
             f"assert main([{cfg!r}]) == 0\n"
             "assert sys.modules['pandas'] is None\n")
    assert r.returncode == 0, r.stderr[-3000:]
    for i in (1, 2):
        assert os.path.exists(tmp_path / "run" / f"client_{i}"
                              / "decrypted_weights.json")

"""Orchestrator CLI — the run.sh entry point equivalent.

  python -m ppqsflhe.orchestration.cli <oConfig.json> [--resume]

Config schema (superset of the reference orchestration/oConfig.json):
{
  "ROUNDS": 5, "N_CLIENTS": 2, "WORK_DIR": "./fl_run",
  "COMM_MODE": "MONGOOSE" | "local",      # MONGOOSE → http (reference name)
  "SERVER_IP": "127.0.0.1", "SERVER_PORT": 8080,
  "CC_CONFIG": { ...config_cc.json schema... },
  "CLIENT_CONFIGS": [ { ...CLIENT section... }, ... ],
  "TRAIN": true
}
"""

from __future__ import annotations

import json
import sys

from .orchestrator import Orchestrator, OrchestratorConfig


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    resume = "--resume" in argv
    argv = [a for a in argv if a != "--resume"]
    if not argv:
        print(__doc__)
        return 2
    with open(argv[0]) as f:
        cfg = json.load(f)
    mode = cfg.get("COMM_MODE", "local")
    oc = OrchestratorConfig(
        rounds=int(cfg.get("ROUNDS", 5)),
        n_clients=int(cfg.get("N_CLIENTS", 2)),
        work_dir=cfg.get("WORK_DIR", "./fl_run"),
        comm_mode="http" if mode.upper() == "MONGOOSE" else mode,
        host=cfg.get("SERVER_IP", "127.0.0.1"),
        port=int(cfg.get("SERVER_PORT", 0)),
        cc_config=cfg.get("CC_CONFIG", {}),
        client_configs=cfg.get("CLIENT_CONFIGS", []),
        train=bool(cfg.get("TRAIN", True)),
        seed=int(cfg.get("SEED", 1234)),
        protocol=cfg.get("PROTOCOL", "pre"),
        lazy_levels=bool(cfg.get("LAZY_LEVELS", False)),
        fail_fast=bool(cfg.get("FAIL_FAST", False)),
        min_clients=int(cfg.get("MIN_CLIENTS", 1)),
    )
    results = Orchestrator(oc).run(resume=resume)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python
"""Drive the committed model-quality parity run (ADVICE r4 low #2: threshold-mode model-quality twin).

Runs the full orchestrated 5-round 2-client FL pipeline on the reference's
own training data (client{1,2}_training_data.csv) with the reference CKKS
chain, then evaluates every round checkpoint the way the reference's
c_evalulate_rounds.py does and writes per-round metrics CSVs + plots under
runs/parity_r5/results/. Compare against the reference's committed run
(client_1_metrics_rounds_20250918_172812.csv, SURVEY.md §6)."""

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, REPO)
os.chdir(REPO)


def main():
    with open(os.path.join(HERE, "oConfig.parity.json")) as f:
        cfg = json.load(f)
    from ppqsflhe.orchestration.cli import main as omain

    rc = omain([os.path.join(HERE, "oConfig.parity.json")])
    assert rc == 0, "orchestrated run failed"

    from ppqsflhe.train.evaluate import evaluate_rounds

    out_dir = os.path.join(HERE, "results")
    for ccfg in cfg["CLIENT_CONFIGS"]:
        mdf = evaluate_rounds(ccfg, out_dir=out_dir)
        print(mdf[[c for c in mdf.columns if "MAE" in c or c == "round"]])


if __name__ == "__main__":
    main()

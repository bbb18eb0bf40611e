#!/usr/bin/env python
"""Per-step breakdown of the orchestrated end-to-end round.

Runs a full 2-round orchestrated FL run at the reference shape (N=2^14
chain, 27 cts/client, 2 clients, seeded compact wire, lazy levels,
train=False with the reference's real weight payload) and reports where
the warm round's wall-clock goes, parsed from the orchestrator's
ms-resolution step log. Round 1 pays jit compiles; round 2 is the warm
number the PERF.md table quotes.

Backend: whatever JAX selects (the GPU when there is one; the CPU with
JAX_PLATFORMS=cpu). Prints one JSON line with the warm-round total, the
per-step table and the device it ran on.
"""

import contextlib
import io
import json
import os
import re
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)


def main() -> None:
    import shutil
    import tempfile

    import numpy as np

    from ppqsflhe.orchestration import Orchestrator, OrchestratorConfig

    work = tempfile.mkdtemp(prefix="bench_orch_")
    ref_w = ("/root/reference/client/storage/client_1/private/"
             "sample_weights_c1.json")
    w_paths = []
    for i in (1, 2):
        p = os.path.join(work, f"w{i}.json")
        if os.path.exists(ref_w):
            shutil.copy(ref_w, p)
        else:
            import json as _j

            rng = np.random.default_rng(i)
            _j.dump({"weights_summary": [{
                "layer": "d", "shape": [39041], "mean": 0.0, "std_dev": 1.0,
                "values": rng.normal(0, 0.2, 39041).tolist()}]},
                open(p, "w"))
        w_paths.append(p)

    cfg = OrchestratorConfig(
        rounds=2, n_clients=2, work_dir=os.path.join(work, "run"),
        comm_mode="http",
        cc_config={"multiplicative_depth": 2, "scaling_mod_size": 40,
                   "batch_size": 8192, "PREMode": "INDCPA",
                   "use_reference_chain": True},
        client_configs=[{"INPUT_WEIGHTS_PATH": w} for w in w_paths],
        train=False, seed=11, lazy_levels=True,
        binary_wire=os.environ.get("PPQSFLHE_ORCH_BIN", "1") == "1",
    )

    buf = io.StringIO()

    class Tee(io.TextIOBase):
        def write(self, s):
            buf.write(s)
            sys.stderr.write(s)
            return len(s)

        def flush(self):
            sys.stderr.flush()

    t0 = time.time()
    with contextlib.redirect_stdout(Tee()):
        Orchestrator(cfg).run()
    total = time.time() - t0

    # parse the ms step log into per-step durations per round. A step's
    # duration = gap to the NEXT log line ("[ts] [role] [step] msg" marks a
    # step's START); "[orchestrator] [round]" lines mark round COMPLETION.
    ts_re = re.compile(r"^\[(\d{4}-\d\d-\d\dT[\d:.]+)\] \[([^\]]+)\] "
                       r"\[([^\]]+)\]")
    from datetime import datetime

    events = []
    for line in buf.getvalue().splitlines():
        m = ts_re.match(line)
        if m:
            events.append((datetime.fromisoformat(m.group(1)).timestamp(),
                           m.group(2), m.group(3)))
    bounds = [i for i, e in enumerate(events) if e[2] == "round"]
    tables = []
    prev = next((i for i, e in enumerate(events) if e[2] == "init"), -1)
    for ri, b in enumerate(bounds):
        seg = events[prev + 1 : b + 1]
        prev = b
        rows = []
        for (t, role, step), (t2, _, _) in zip(seg, seg[1:]):
            rows.append({"step": f"{role}:{step}",
                         "ms": round((t2 - t) * 1e3, 1)})
        tables.append({"round": ri + 1,
                       "total_s": round(seg[-1][0] - seg[0][0], 2),
                       "steps": rows})
    warm = tables[-1] if tables else {}
    import jax

    dev = jax.devices()[0]
    print(json.dumps({"metric": "orchestrated_round_s_warm",
                      "value": warm.get("total_s"),
                      "unit": "s", "total_run_s": round(total, 1),
                      "rounds": tables,
                      "device": {"platform": dev.platform,
                                 "kind": dev.device_kind,
                                 "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()

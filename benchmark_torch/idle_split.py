"""One traced run of a cell, with the device's idle time split by the
program span that the device loop's thread was in.

    python3 benchmark_torch/idle_split.py --workload <cell> --seed <n> \
        --seconds <s>

It runs the cell as ``run.py --trace 1`` does and prints run.py's result
line, then one line: ``{"window_s", "idle_s", "idle_split": {span: s},
"covered": share of the idle time inside some span}``, where the split
(``spans.idle_split``) adds up to ``idle_s``. The benchmark's own runs do
not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path[0] = str(ROOT)

import torch  # noqa: E402

from benchmark_torch import harness, spans  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    torch.set_num_threads(harness.HOST_THREADS)
    kept = []

    def keep_run(bench: harness.Bench) -> None:
        """Keeps the Run of the window (the last one a job is given)."""
        run_job = bench.run_job

        def job(j, run, close, sampler):
            kept[:] = [run]
            return run_job(j, run, close, sampler)
        bench.run_job = job

    out = harness.run_cell(args.workload, args.seed, args.seconds, True,
                           T_START, ROOT, hook=keep_run)
    print(json.dumps(out), flush=True)
    run = kept[0]
    split = spans.idle_split(run)
    tr = run.trace
    idle = tr.window_s - tr.busy_s(run.cards) if tr is not None else None
    covered = (1.0 - split["no span"] / idle) if split and idle else None
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "window_s": tr.window_s if tr is not None else None,
                      "idle_s": idle, "idle_split": split,
                      "covered": covered}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The controls of a cell's comparison, run through the harness itself.

    python3 benchmark_torch/control.py --workload <cell> --seeds 1,2,3 \
        --seconds 10

A control is the plain reference put in the program's place and computed
one precision below what the configuration states (``reference``'s TF32
matrix operands where the cell resamples, bfloat16 elsewhere). `plant`
puts it there through `harness.run_cell`'s hook: the run's warm-up,
window, sample and comparison are the cell's own, at its sizes, and its
result has to read ``correct`` false. A cell on several cards runs its
control on the first card with the cell's batch: the control replaces
the split with the rest of the render. One result line a seed; the
benchmark's own runs do not run this. ``tests/test_control.py`` keeps
the same check at a size the CPU holds.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path[0] = str(ROOT)

import torch  # noqa: E402

from benchmark_torch import harness, reference, spec, traffic  # noqa: E402


def precision_of(cell: spec.Cell) -> str:
    """The control's precision: TF32 products where the cell resamples
    (its products are stated IEEE float32), else bfloat16."""
    return "tf32" if harness.resize_of(cell) else "bfloat16"


def plant(precision: str):
    """A `run_cell` hook that renders every job with the reference at
    `precision`, from the look's own table (the runner's loader then
    hands back the look's index, not a parsed table)."""
    def hook(bench: harness.Bench) -> None:
        dev, tables = bench.devices[0], {}

        def load(path, device):
            return bench.looks.index(path)

        def factory(look):
            if look not in tables:
                tables[look] = torch.from_numpy(traffic.look_table(
                    bench.spec.traffic, bench.n, look)).to(dev)
            table = tables[look]
            return lambda y, u, v: reference.render(
                y, u, v, table, bench.pipe, bench.resize, precision)
        bench.load_lut_table = load
        bench.render_fn_factory = factory
    return hook


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("control: torch sees no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = spec.load_cell(args.workload, ROOT)
    prec = precision_of(cell)
    devices = [torch.device("cuda", 0)] * cell.chips
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        with torch.no_grad():
            out = harness.run_cell(cell.name, seed, args.seconds, False, t,
                                   ROOT, devices=devices,
                                   device_arg="cuda:0", hook=plant(prec))
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "control": prec, "correct": out["correct"],
                          "attempted": out["attempted"],
                          "compared": out["compared"],
                          "seconds": time.perf_counter() - t}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

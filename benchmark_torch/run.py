"""Run one benchmark cell once and print its result as the last line.

    python3 benchmark_torch/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

Needs the cards the cell asks for; without them it exits non-zero and
prints no result. Every cache the run writes lies inside the checkout.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "benchmark_torch" / "cache"
# fixed cache directories inside the checkout, set before torch loads
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["PYTORCH_KERNEL_CACHE_PATH"] = str(CACHE / "torch_kernels")
# the package, not this directory, on the path: no module here shadows one
# of the standard library
sys.path[0] = str(ROOT)

from benchmark_torch import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START, ROOT))

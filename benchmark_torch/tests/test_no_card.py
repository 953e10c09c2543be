"""Without a card the benchmark fails: no CPU fallback, no result line."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from .conftest import HERE, REPO

ARGS = ["--workload", "uhd8_c33.native", "--seed", str(2 ** 31 + 5),
        "--seconds", "1", "--trace", "0"]


def _run(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "benchmark_torch/run.py", *ARGS],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def _no_result(out: str) -> bool:
    for line in out.strip().splitlines()[-1:]:
        try:
            json.loads(line)
        except ValueError:
            return True
        return False
    return True


def test_run_without_a_card_exits_non_zero():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = _run(REPO)
    assert proc.returncode != 0
    assert _no_result(proc.stdout)
    assert "no CUDA device" in proc.stderr


def test_run_without_the_program_exits_non_zero(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(HERE, tmp_path / "benchmark_torch",
                    ignore=shutil.ignore_patterns("looks", "cache", "out",
                                                  "__pycache__"))
    proc = _run(tmp_path)
    assert proc.returncode != 0
    assert _no_result(proc.stdout)

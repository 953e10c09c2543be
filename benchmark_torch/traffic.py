"""The one traffic generator: a mix's data file in, a seeded job plan out.

A traffic file (``traffic/<name>.json``) holds parameters only:

``kind``
    ``"queue"``: a closed-loop render queue, one job at a time, each job one
    clip; ``"stream"``: one continuous job that runs until the window
    closes.
``clip_frames`` [lo, hi]
    a queue's clip lengths, uniform over the range: each block of
    ``clip_block`` jobs takes ``clip_block`` lengths evenly spaced from lo
    to hi, in a seeded order, so every seed renders the same mix.
``looks``, ``look_draw``, ``look_block``, ``look_seed``
    how many looks (``.cube`` files) the queue draws from and how:
    ``"uniform"`` (each look once a block of ``looks`` jobs) or
    ``{"zipf": s}`` (look k, from 1, ``look_block / k^s`` times a block,
    rounded), each block in an order drawn from ``look_seed``. The looks'
    tables and their order come from ``look_seed``, not from the run's
    seed: a checkout writes each ``.cube`` once, and the runner's LRU
    misses the same looks for every seed (which look misses is work, and
    a seed that changed it would change the work of the window).
``params``
    the job's ``ProcessingParams`` fields beyond the configuration's (a
    delivery size: ``{"resolution": "1920x1080"}``).
``pool_frames``
    distinct frames made from the run's seed; a job's frames run through
    the pool from a seeded start.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, List, Optional

import numpy as np

from .frames import random_lut


@dataclass(frozen=True)
class Job:
    frames: Optional[int]   # None: a stream that runs until the close
    look: int
    pool_start: int


def look_counts(traffic: dict) -> List[int]:
    """How often each look appears in one block of look draws."""
    n = int(traffic["looks"])
    draw = traffic.get("look_draw", "uniform")
    if draw == "uniform":
        return [1] * n
    s = float(draw["zipf"])
    block = int(traffic["look_block"])
    return [max(1, int(round(block / (k ** s)))) for k in range(1, n + 1)]


def jobs(traffic: dict, seed: int) -> Iterator[Job]:
    """The job plan of one run: an endless sequence of jobs whose clip
    lengths (their order) and frames come from `seed`."""
    rng = np.random.default_rng([seed, 0x7A11])
    look_rng = np.random.default_rng([int(traffic.get("look_seed", 0)),
                                      0x100C])
    pool = int(traffic["pool_frames"])
    if traffic["kind"] == "stream":
        yield Job(None, int(look_rng.integers(traffic["looks"])),
                  int(rng.integers(pool)))
        return
    if traffic["kind"] != "queue":
        raise ValueError(f"unknown traffic kind {traffic['kind']!r}")
    lo, hi = traffic["clip_frames"]
    lengths = np.rint(np.linspace(lo, hi, int(traffic["clip_block"])))
    looks = np.repeat(np.arange(int(traffic["looks"])), look_counts(traffic))
    clip_q, look_q = [], []
    while True:
        if not clip_q:
            clip_q = [int(x) for x in rng.permutation(lengths)]
        if not look_q:
            look_q = [int(x) for x in look_rng.permutation(looks)]
        yield Job(clip_q.pop(), look_q.pop(), int(rng.integers(pool)))


def look_table(traffic: dict, n: int, look: int) -> np.ndarray:
    """Look `look`'s table: (N, N, N, 3) float32, from the mix's look seed."""
    return random_lut(n, int(traffic.get("look_seed", 0)) * 1000 + look)


def cube_text(table: np.ndarray) -> str:
    """A .cube file of `table` [r, g, b], red fastest, nine significant
    digits: a float32 reads back exactly."""
    n = table.shape[0]
    rows = table.transpose(2, 1, 0, 3).reshape(-1, 3)
    body = "\n".join(f"{r:.9g} {g:.9g} {b:.9g}" for r, g, b in rows.tolist())
    return f"LUT_3D_SIZE {n}\n{body}\n"


def look_path(cache: Path, traffic: dict, n: int, look: int) -> Path:
    """The look's .cube under `cache`, written once (atomically)."""
    path = cache / f"look_n{n}_s{int(traffic.get('look_seed', 0))}_{look}.cube"
    if not path.exists():
        cache.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".tmp")
        tmp.write_text(cube_text(look_table(traffic, n, look)))
        tmp.replace(path)
    return path

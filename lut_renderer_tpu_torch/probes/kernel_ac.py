"""Kernels A and C: their stage probe, and each against another revision.

    python -m lut_renderer_tpu_torch.probes.kernel_ac [--baseline DIR]
                                                      [--out FILE]

Runs on the card only. Kernels A (exact table) and C (coarse + residual)
build in stages (STAGES, tetrahedral; csrc/planar_probe.cu, in the probes'
own library, harness.probe_library):

  io       load the planes and store them: the memory floor
  weights  adds the domain map, the cells and the interp's sums over
           stand-in corners, with no table load
  coarse   (C) the coarse term with its loads, the residual skipped
  resid    (C) the residual term with its loads, the coarse term skipped
  full     the production kernel

So weights - io is the arithmetic, full - weights the wait on the table's
gathers. The stages run at 4K x 2 (STAGE_CASES: A at 33^3, 65^3 and
129^3, C at 65^3 and 129^3 coarse2f) on two kinds of planes: ``ramp``, the
RGB that the plain layout hands the LUT for harness.yuv_frames, and
``uniform``, seeded uniform planes (harness.uniform_rgb). Beside them:

  layout    the io and full stages of A 33^3 and C 129^3 coarse2f on ramp
            planes, in turns, moved as float4 (16-byte aligned planes) and
            sample by sample (the planes at an unaligned offset)
  8K        kernel B's io stage on a 7680x4320 420p8 frame
            (kernel_b.prepared_launch)

These port the TPU ablations of the experiments/ scripts on rows 1-3 of
the kernel table (PERF.md maps each script to the number that answers
it here).

``--baseline DIR`` names the csrc/ directory of another revision of this
package whose lut3d.cu and coarse2.cu take a prefix of today's params
(commit 7ef7f79 and later), for example ``git archive <rev>
lut_renderer_tpu_torch/csrc`` unpacked under a git-ignored directory.
Those two are built, and the baseline and current kernels run in turns
(baseline, current, current, baseline) on the same planes over
COMPARE_CASES, on ramp, uniform and tie-heavy planes
(harness.tie_frames), and over every (interp, residual interp)
instantiation at 65^3; their outputs are compared bit for bit. Any
difference fails the run.

The last line of standard output is one JSON object with every time (ms
per call, CUDA-graph replays of prepared launches) and the card's name and
power limit; ``--out`` writes it to a file as well.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
from pathlib import Path

import torch

from ..ops import _build, lut3d
from ..ops.prepare import Coarse2Table, LutTable
from ..ops.render import RenderConfig
from . import kernel_b
from .harness import (
    SEED,
    card_line,
    plain_rgb,
    probe_library,
    random_lut,
    tie_frames,
    time_ms,
    uniform_rgb,
    yuv_frames,
)

TETRA = "tetrahedral"
# io loads and stores the planes; weights adds the domain map, the cells
# and the sums over stand-in corners, no table load; coarse and resid
# (kernel C only) each run one term with its loads; full is the
# production kernel
STAGES = ("io", "weights", "coarse", "resid", "full")
_COARSE2_ONLY_STAGES = ("coarse", "resid")
# kernels A and C, as another revision builds them
BASELINE_SOURCES = ("lut3d.cu", "coarse2.cu")
ENTRY_POINTS = ("lut3d_launch", "coarse2_launch")
INTERPS = ("nearest", "trilinear", "tetrahedral", "pyramid", "prism")
SHAPE = (2, 2160, 3840)  # the main path's batch of 4K frames
PLANES = ("ramp", "uniform", "ties")
STAGE_PLANES = ("ramp", "uniform")
# name: (N, coarse2 tier or None for the exact table)
STAGE_CASES = {"A 33^3": (33, None), "A 65^3": (65, None),
               "A 129^3": (129, None), "C 65^3 coarse2f": (65, "coarse2f"),
               "C 129^3 coarse2f": (129, "coarse2f")}
LAYOUT_CASES = ("A 33^3", "C 129^3 coarse2f")
# (N, tier or None, interp): A's 5 instantiations at 33^3; C's three tiers
# and coarse2f_tri at 65^3, 97^3 and 129^3
COMPARE_CASES = (
    [(33, None, interp) for interp in INTERPS]
    + [(n, tier, TETRA) for n in (65, 97, 129)
       for tier in ("coarse2f", "coarse2", "coarse2x", "coarse2f_tri")])
# with COMPARE_CASES, every (interp, residual interp) instantiation of C;
# held bit for bit only
INSTANTIATION_CASES = [(65, tier, interp) for tier in ("coarse2f",
                                                       "coarse2f_tri")
                       for interp in INTERPS if interp != TETRA]
_LUT_SEED = {33: 0, 65: 265, 97: 297, 129: 329}


def entry_point(table, stage: str) -> str:
    """The library entry that launches kernel A or C (by `table`'s kind) at
    `stage` of STAGES."""
    coarse2 = isinstance(table, Coarse2Table)
    if stage not in STAGES or (stage in _COARSE2_ONLY_STAGES
                               and not coarse2):
        raise ValueError(f"kernel {'C' if coarse2 else 'A'} has no stage "
                         f"{stage!r}")
    if stage == "full":
        return lut3d.entry_point(table)
    return f"{'coarse2' if coarse2 else 'lut3d'}_{stage}_launch"


def prepared_launch(r, g, b, table, interp: str = TETRA,
                    stage: str = "full", lib=None):
    """(launch, (ro, go, bo)) on CUDA tensors: each ``launch()`` runs
    kernel A or C at `stage` of STAGES on operands the wrapper checks
    once, into the same outputs, from `lib`, or by default the render
    library for full and the probe library for a stage. For timing the
    kernel apart from the wrapper's host work; it counts no launch. The
    stages below full are tetrahedral only."""
    interp = lut3d.canonical_interp(interp)
    if stage != "full" and interp != TETRA:
        raise ValueError(f"stage {stage!r} is built for tetrahedral only")
    name = entry_point(table, stage)
    if lib is None and stage != "full":
        lib = probe_library()
    p, out, keep = lut3d.launch_args(r, g, b, table, interp)
    keep += out  # the launch holds every tensor p points to

    def launch():
        _build.launch(name, p, keep[0].device, lib=lib)

    return launch, out


def table_of(n: int, tier, dev):
    table = LutTable.from_lut3d(random_lut(n, SEED + _LUT_SEED[n]), dev)
    return table if tier is None else Coarse2Table.from_lut_table(table, tier)


def planes_of(kind: str, dev, shape=SHAPE):
    """(r, g, b) on `dev` of one kind of PLANES."""
    b, h, w = shape
    if kind == "uniform":
        return uniform_rgb(SEED + 2, shape, dev)
    if kind == "ramp":
        return plain_rgb(yuv_frames(SEED + 1, b, h, w), RenderConfig(), dev)
    full = RenderConfig(in_full_range=True, work_full_range=True,
                        out_full_range=True)
    return plain_rgb(tie_frames(SEED + 3, b, h, w), full, dev)


def _in_turns(a, b) -> tuple:
    """(a's ms, b's ms) from runs in turns a, b, b, a."""
    t = [time_ms(f, 20, graph=True) for f in (a, b, b, a)]
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2


def stage_times(dev, cases=None) -> dict:
    """{case: {planes: {stage: ms}}} of STAGE_CASES (or `cases` of them)."""
    out = {}
    for kind in STAGE_PLANES:
        rgb = planes_of(kind, dev)
        for name in cases or STAGE_CASES:
            table = table_of(*STAGE_CASES[name], dev)
            stages = [s for s in STAGES
                      if s not in _COARSE2_ONLY_STAGES
                      or isinstance(table, Coarse2Table)]
            out.setdefault(name, {})[kind] = {
                s: time_ms(prepared_launch(*rgb, table, TETRA, s)[0],
                           20, graph=True) for s in stages}
        del rgb
    return out


def layout_times(dev) -> dict:
    """{case: {path: {stage: ms}}} of LAYOUT_CASES on ramp planes: the io
    and full stages on planes moved as float4 (``vector``: 16-byte
    aligned) and sample by sample (``scalar``: the same pixels one element
    further on, not aligned), the two paths in turns; raises unless their
    outputs are equal."""
    flat = [t.reshape(-1) for t in planes_of("ramp", dev)]
    paths = {"vector": [t[4:] for t in flat],
             "scalar": [t[1:-3] for t in flat]}
    assert lut3d.vector_io(*paths["vector"])
    assert not lut3d.vector_io(*paths["scalar"])
    out = {}
    for case in LAYOUT_CASES:
        table = table_of(*STAGE_CASES[case], dev)
        for stage in ("io", "full"):
            vec, want = prepared_launch(*paths["vector"], table, TETRA,
                                        stage)
            sca, got = prepared_launch(*paths["scalar"], table, TETRA, stage)
            vec()
            sca()
            if stage == "full":
                # the scalar planes start three pixels before the vector ones
                _check_equal([t[3:] for t in got], [t[:-3] for t in want],
                             f"{case} scalar against vector path")
            a, b = _in_turns(vec, sca)
            for path, ms in (("vector", a), ("scalar", b)):
                out.setdefault(case, {}).setdefault(path, {})[stage] = ms
    return out


def kernel_b_8k(dev) -> dict:
    """Kernel B's io and full stages on one 7680x4320 420p8 frame, 33^3."""
    cfg = RenderConfig()
    planes = [torch.from_numpy(p).to(dev)
              for p in yuv_frames(SEED + 8, 1, 4320, 7680)]
    table = table_of(33, None, dev)
    return {s: time_ms(kernel_b.prepared_launch(*planes, table, cfg, s)[0],
                       20, graph=True) for s in ("io", "full")}


def _check_equal(got, want, what: str) -> None:
    torch.cuda.synchronize()
    for a, e, plane in zip(got, want, "rgb"):
        if not torch.equal(a, e):
            d = (a - e).abs()
            raise AssertionError(
                f"{what}: plane {plane} differs, max|d|={float(d.max())} on "
                f"{int((d > 0).sum())} samples")


def compare(dev, baseline) -> dict:
    """{case: {planes: {baseline_ms, current_ms, max_abs_diff}}} over
    COMPARE_CASES, in turns; INSTANTIATION_CASES checked bit for bit only.
    Raises unless every output equals the baseline's."""
    out = {}
    for kind in PLANES:
        rgb = planes_of(kind, dev)
        for n, tier, interp in COMPARE_CASES + INSTANTIATION_CASES:
            table = table_of(n, tier, dev)
            old, want = prepared_launch(*rgb, table, interp, lib=baseline)
            new, got = prepared_launch(*rgb, table, interp)
            old()
            new()
            name = f"{'C' if tier else 'A'} {n}^3 {tier or 'exact'} {interp}"
            _check_equal(got, want, f"{name} {kind} against the baseline")
            if (n, tier, interp) not in COMPARE_CASES:
                continue
            a, b = _in_turns(old, new)
            out.setdefault(name, {})[kind] = dict(
                baseline_ms=a, current_ms=b, max_abs_diff=0)
            print(json.dumps({name: {kind: out[name][kind]}}), flush=True)
        del rgb
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", type=Path,
                    help="csrc/ directory of the kernels A and C to compare "
                         "with")
    ap.add_argument("--out", type=Path, help="also write the JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ac probe: no CUDA device; it runs on the card only",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    report = {"card": card_line(), "device": torch.cuda.get_device_name(0)}
    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    _build.load_library()
    report["build_s"] = _build.build_seconds
    baseline = (_build.build_library(args.baseline, BASELINE_SOURCES,
                                     ENTRY_POINTS, name="libbaseline_ac")
                if args.baseline else None)
    for key, fn in (("stages_ms", lambda: stage_times(dev)),
                    ("layout_ms", lambda: layout_times(dev)),
                    ("kernel_b_8k_ms", lambda: kernel_b_8k(dev))):
        report[key] = fn()
        print(json.dumps({key: report[key]}), flush=True)
    if baseline is not None:
        report["compare_ms"] = compare(dev, baseline)
    line = json.dumps(report)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())

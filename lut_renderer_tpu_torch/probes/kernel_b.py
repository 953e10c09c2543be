"""Kernel B's stage probe, and kernel B against another revision of it.

    python -m lut_renderer_tpu_torch.probes.kernel_b [--baseline DIR]
                                                     [--out FILE]

Runs on the card only. It ports the JAX package's probes of the fused
YUV->YUV path (experiments/r5_fused_yuv.py, r3_posty_kernel.py,
r3_rowphase.py) and of the 33^3 LUT body stage by stage
(experiments/r6_33cube_floor.py). Kernel B builds in three stages
(STAGES; io and color are csrc/fused420_probe.cu, in the probes' own
library, harness.probe_library):

  io     load, convert, quantise and store; the colour math is the identity
  color  adds the range normalisation, YUV<->RGB, dither and the chroma
         downsample; the LUT is the identity
  full   the production kernel

At 4K x 2 420p8 with a 33^3 tetrahedral LUT, on ramp-plus-noise and on
uniform-random frames, io says what memory and indexing cost, color - io
the colour math, full - color the LUT.

``--baseline DIR`` names the csrc/ directory of another revision of this
package that builds kernel B's stages itself (commit 7ef7f79 and later),
for example ``git archive <rev> lut_renderer_tpu_torch/csrc`` unpacked
there. Its fused420.cu and fused420_coarse2.cu are built, with its
fused420_probe.cu where it has one (before it, fused420.cu held the
stages), its stages are timed beside the current kernel's, and then the two full kernels run in
turns (baseline, current, current, baseline) on the same planes over
kernel B's cases (COMPARE_CASES), on ramp, uniform-random and tie-heavy
frames (harness.tie_frames), with their outputs compared bit for bit. Any
difference fails the run.

The last line of standard output is one JSON object with every time (ms
per call, CUDA events) and the card's name and power limit; ``--out``
writes it to a file as well.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
from dataclasses import replace
from pathlib import Path

import torch

from ..ops import _build, fused420
from ..ops.prepare import Coarse2Table, LutTable
from ..ops.render import RenderConfig
from .harness import (
    KERNEL_B_CASES,
    SEED,
    card_line,
    probe_library,
    random_lut,
    tie_frames,
    time_ms,
    uniform_frames,
    yuv_frames,
)

# io loads, converts, quantises and stores with the colour math the
# identity; color adds the range normalisation, YUV<->RGB, dither and
# downsample; full is the production kernel
STAGES = ("io", "color", "full")
# the frames every comparison runs on; the stages are timed on the first two
FRAMES = {"ramp": yuv_frames, "uniform": uniform_frames, "ties": tie_frames}
STAGE_FRAMES = ("ramp", "uniform")

BASELINE_SOURCES = ("fused420.cu", "fused420_coarse2.cu")
# a revision's stage builds, where they are a file apart
BASELINE_PROBE_SOURCE = "fused420_probe.cu"
BASELINE_ENTRY_POINTS = ("fused420_launch", "fused420_coarse2_launch",
                         "fused420_io_launch", "fused420_color_launch")

# beside KERNEL_B_CASES, the cases chip_smoke's phase 3 builds itself:
# RenderConfig overrides, (batch, height, width), (LUT size, seed offset),
# planes' seed offset, coarse2 tier or None
COMPARE_CASES = {
    "4K 420p8 33^3": (dict(), (2, 2160, 3840), (33, 0), 1, None),
    "4K 420p8 65^3 coarse2f": (dict(lut_precision="coarse2f"),
                               (2, 2160, 3840), (65, 265), 1, "coarse2f"),
    "4K 420p8 129^3 coarse2f": (dict(lut_precision="coarse2f"),
                                (2, 2160, 3840), (129, 329), 1, "coarse2f"),
    "422p10 129^3 coarse2x random dither": (
        dict(lut_precision="coarse2f", in_depth=10, out_depth=10,
             in_subsampling="422", out_subsampling="422", dither="random"),
        (1, 1080, 1920), (129, 329), 30, "coarse2x"),
    **{name: (kw, shape, lut, seed, None)
       for name, (kw, shape, lut, seed) in KERNEL_B_CASES.items()},
}


def build_baseline(csrc: Path):
    """The kernel B library, stages included, of another revision's csrc/
    directory."""
    sources = BASELINE_SOURCES
    if (csrc / BASELINE_PROBE_SOURCE).exists():
        sources += (BASELINE_PROBE_SOURCE,)
    return _build.build_library(csrc, sources, BASELINE_ENTRY_POINTS,
                                name="libbaseline_kernel_b")


def entry_point(table, stage: str) -> str:
    """The library entry that launches kernel B at `stage` of STAGES for
    `table`'s kind (io and color read no table)."""
    if stage not in STAGES:
        raise ValueError(f"unknown kernel B stage {stage!r}")
    return (fused420.entry_point(table) if stage == "full"
            else f"fused420_{stage}_launch")


def prepared_launch(y, u, v, table, cfg, stage: str = "full", lib=None):
    """(launch, (yo, uo, vo)) on CUDA tensors: each ``launch()`` runs
    kernel B at `stage` of STAGES on operands the wrapper checks and lays
    out once, into the same outputs, from `lib`, or by default the render
    library for full and the probe library for a stage. For timing the
    kernel apart from the wrapper's host work; it counts no launch."""
    name = entry_point(table, stage)
    if lib is None and stage != "full":
        lib = probe_library()
    p, out, keep = fused420.launch_args(y, u, v, table, cfg, None)
    keep += out + (table,)  # the launch holds every tensor p points to

    def launch():
        _build.launch(name, p, keep[0].device, lib=lib)

    return launch, out


def case_inputs(name: str, frames: str, dev):
    """(cfg, device planes, table) of COMPARE_CASES[name]."""
    kw, (b, h, w), (n, lut_seed), seed, tier = COMPARE_CASES[name]
    cfg = replace(RenderConfig(), **kw)
    table = LutTable.from_lut3d(random_lut(n, SEED + lut_seed), dev)
    if tier is not None:
        table = Coarse2Table.from_lut_table(table, tier)
    planes = FRAMES[frames](SEED + seed, b, h, w, cfg.in_depth,
                            cfg.in_subsampling)
    return cfg, [torch.from_numpy(p).to(dev) for p in planes], table


def stage_times(dev, baseline=None) -> dict:
    """{kernel: {frames: {stage: ms}}} at 4K x 2 420p8, 33^3 tetrahedral:
    the current kernel, and the baseline's when its library is given."""
    out = {}
    for frames in STAGE_FRAMES:
        cfg, planes, table = case_inputs("4K 420p8 33^3", frames, dev)
        runs = {"current": {s: prepared_launch(*planes, table, cfg, s)[0]
                            for s in STAGES}}
        if baseline is not None:
            runs["baseline"] = {s: prepared_launch(*planes, table, cfg, s,
                                                   baseline)[0]
                                for s in STAGES}
        for kernel, fns in runs.items():
            out.setdefault(kernel, {})[frames] = {
                s: time_ms(fn, 20, graph=True) for s, fn in fns.items()}
    return out


def compare(dev, baseline) -> dict:
    """{case: {frames: {baseline_ms, current_ms}}}: the two full kernels in
    turns on the same planes; raises unless their outputs are bit-equal."""
    out = {}
    for name in COMPARE_CASES:
        for frames in FRAMES:
            cfg, planes, table = case_inputs(name, frames, dev)
            old, want = prepared_launch(*planes, table, cfg, lib=baseline)
            new, got = prepared_launch(*planes, table, cfg)
            old()
            new()
            torch.cuda.synchronize()
            for a, e, plane in zip(got, want, "yuv"):
                if not torch.equal(a, e):
                    d = (a.int() - e.int()).abs()
                    raise AssertionError(
                        f"{name} {frames}: plane {plane} differs from the "
                        f"baseline, max|d|={int(d.max())} on "
                        f"{int((d > 0).sum())} samples")
            t = [time_ms(f, 20, graph=True) for f in (old, new, new, old)]
            out.setdefault(name, {})[frames] = dict(
                baseline_ms=(t[0] + t[3]) / 2, current_ms=(t[1] + t[2]) / 2,
                max_abs_diff=0)
            print(json.dumps({name: {frames: out[name][frames]}}),
                  flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", type=Path,
                    help="csrc/ directory of the kernel B to compare with")
    ap.add_argument("--out", type=Path, help="also write the JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_b probe: no CUDA device; it runs on the card only",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    report = {"card": card_line(), "device": torch.cuda.get_device_name(0)}
    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    _build.load_library()
    report["build_s"] = _build.build_seconds
    baseline = build_baseline(args.baseline) if args.baseline else None
    report["stages_ms"] = stage_times(dev, baseline)
    print(json.dumps({"stages_ms": report["stages_ms"]}), flush=True)
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

"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from lut_renderer_tpu_torch/csrc,
holds each against its plain PyTorch version on the card, drives the
port's main render path at the headline size (4K 8-bit 4:2:0 frames, a 33^3
tetrahedral LUT) and its big-cube path (a 129^3 LUT at the coarse2f tier),
and, where hostio's FFmpeg libraries load, renders a clip file to file
through the port's CLI. Phases:

  1. card and build      nvidia-smi name/power limit, versions, build time
  2. kernel A            LUT on planar RGB vs plain: 4K x 2 x 5 interps at
                         33^3 (uniform planes), ramp planes (the plain
                         layout's RGB of the paths' frames), the scalar
                         path (planes one element off), 1080p at 65^3 and
                         129^3; <= 1e-5 absolute; times of launches
                         prepared once on both kinds of planes, the
                         trilinear case beside torch's grid_sample
  2C. kernel C           coarse + residual LUT vs plain: 4K x 2 at 65^3,
                         97^3, 129^3 x coarse2f/coarse2/coarse2x, 5 interps
                         at 129^3 coarse2f and coarse2f_tri (every
                         instantiation), ramp planes; <= 1e-5 absolute;
                         times on both kinds of planes beside kernel A's
                         exact table at each N; the 129^3 table build
  2P. stage probe        the probes' own library of stage builds
                         (probes/harness.probe_library), then kernels A
                         (33^3) and C (129^3 coarse2f) built in stages
                         (probes/kernel_ac.py) at 4K x 2, timed on both
                         kinds of planes
  3. kernel B            whole-frame YUV->YUV vs plain: 4K 420p8 (ramp and
                         uniform-random frames) and the geometry/depth/
                         range/dither matrix, exact and coarse2f tables;
                         max |d| <= 1 code value on fewer than 1e-3 of
                         pixels; times of launches prepared once
  3P. stage probe        kernel B built as io, color and full
                         (probes/kernel_b.py) at 4K x 2 33^3, timed on both
                         kinds of frames
  4. main path           the executor's device loop over 48 seeded 4K
                         frames; kernel launch counts, fps end to end
  4C. big-cube path      the same loop over 16 4K frames at 129^3
                         coarse2f (kernel B's coarse2 instantiation), and
                         an error-diffusion job through kernel C
  5. file to file        CLI render --device cuda vs --device cpu
  6. resize path         the device loop over seeded frames with a resize
                         (kernel A at the input size, then the banded
                         resample kernel): 4K -> 1080p (16 frames, batch 2,
                         also ordered dither and error diffusion) and
                         1080p -> 4K (16, batch 8); kernel A's and the
                         resample's launch counts; the first batch against
                         the plain version; fps, and per batch kernel A,
                         the resample (bit-equal to its plain version;
                         beside its bound, the plain version's time and
                         the dense torch.matmul pair's, library_ms), the
                         rest, H2D and D2H
  6T. resample precision resample_plane against a float64 product, then
                         again with allow_tf32=True: bit-equal
  7. split               make_sharded_render_fn over two streams of card 0
                         (and over every card where there are several),
                         main and resize paths: bit-equal to the whole
                         batch
  8. serve               the port's warmup, QueueServer on a Unix socket,
                         ping/status/shutdown through the CLI client (and
                         a resized job where hostio loads)
  9. BASELINE configs    each stage of BASELINE.json's five configurations
                         (probes/baseline.py: RenderConfig derived by the
                         policy from a synthetic probe result) through the
                         device loop over seeded frames: the 4K 422p10
                         pro master (kernel B) and its delivery stage (no
                         LUT, the plain layout's torch ops, on the master's
                         frames), 1080p 65^3 10-bit -> 8-bit ordered
                         dither, 8K 10-bit at batch 1 (and split over two
                         streams of card 0, bit-equal), 1080p trilinear,
                         1080p full range; fps (cold pass apart), per batch
                         H2D / render / D2H, kernel B's launches, peak
                         device memory, the first batch against its plain
                         version

Any failure raises and exits non-zero. The one thing caught is hostio's
own report that this machine has no FFmpeg libraries (no cv2, or
FFIUnavailable), which skips phase 5 and phase 8's job and says why. Without a CUDA device it
exits non-zero before printing any result. The last line is
{"ok": true, "device": {...}}; the line before it holds the kernels' JSON
(each kernel's time on the paths' planes and on uniform ones, its stages,
plain time, least possible time and its share of it, launches on its
path; kernel B's entry also holds phase 9's records) and the one before
that the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time
from dataclasses import replace
from pathlib import Path

import numpy as np

TETRA = "tetrahedral"
INTERPS = ("nearest", "trilinear", "tetrahedral", "pyramid", "prism")
LUT_ATOL = 1e-5
MAX_CODE_DIFF, MAX_DIFF_RATE = 1, 1e-3
COARSE2 = ("coarse2f", "coarse2", "coarse2x")
# float code values out of the plain layout: the LUT's 1e-5 through the
# output matrix and the code-value scale (255 at 8 bits)
ED_ATOL = 0.01
# the resample against a float64 product of its f32 inputs: full f32 over
# K <= 3840 terms reads about 1e-6; TF32's 10-bit mantissa about 1e-3
RESAMPLE_RTOL = 1e-5
BIG = "coarse2f"  # the big-cube path's tier

# The least time the card could take, from the H100 SXM peaks: 3.35 TB/s
# of device memory and 67 TFLOP/s of f32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# f32 operations per pixel, counted from the sources (a division, a
# min/max and a floor count one each): the domain mapping 8 per channel,
# the tetrahedral sum 25; kernel C adds the corner weights (4), the
# per-axis remap (36), the 8-corner coarse sum (48) and the residual's
# dequantisation (12); kernel B adds YUV->RGB (20), RGB->YUV (15) and the
# quantise/downsample (8) per luma pixel.
FLOPS_PER_PX = {"A": 60, "C": 160, "B": 103, "B coarse2": 203}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bound(nbytes: float, flops: float):
    """(ms, "bytes" or "operations"): the larger of the two floors."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def table_bytes(table) -> int:
    """Bytes of every tensor a LutTable or Coarse2Table holds."""
    names = ("coarse", "resid", "resid_scale") if hasattr(table, "coarse") \
        else ("table",)
    return sum(getattr(table, n).numel() * getattr(table, n).element_size()
               for n in names)


def code_diff(got, want, what: str) -> int:
    """Integer contract on (y, u, v); returns the max |d|."""
    worst = 0
    for name, a, e in zip("yuv", got, want):
        if a.shape != e.shape or a.dtype != e.dtype:
            fail(f"{what} plane {name}: {a.shape} {a.dtype} vs "
                 f"{e.shape} {e.dtype}")
        d = np.abs(a.cpu().numpy().astype(np.int64)
                   - e.cpu().numpy().astype(np.int64))
        rate = float(np.mean(d > 0))
        if d.max() > MAX_CODE_DIFF or rate >= MAX_DIFF_RATE:
            fail(f"{what} plane {name}: max|d|={d.max()} rate={rate}")
        worst = max(worst, int(d.max()))
    return worst


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch sees no CUDA device; this script runs on the card only")
    if len(sys.argv) > 1:
        fail(f"takes no arguments, got {sys.argv[1:]}")
    dev = torch.device("cuda", 0)
    # wall-clock seconds of each phase (the script's time on the card)
    phase_s, last = {}, [None, time.perf_counter()]

    def mark(name):
        now = time.perf_counter()
        if last[0] is not None:
            phase_s[last[0]] = round(now - last[1], 2)
        last[:] = [name, now]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from lut_renderer_tpu_torch.engine.executor import (
        _pick_batch_size,
        render_batches,
    )
    from lut_renderer_tpu_torch.ops import _build, fused420, lut3d, resample
    from lut_renderer_tpu_torch.ops.prepare import Coarse2Table, LutTable
    from lut_renderer_tpu_torch.ops.pixel import render_planes
    from lut_renderer_tpu_torch.ops.render import RenderConfig, make_render_fn
    from lut_renderer_tpu_torch.probes import kernel_ac, kernel_b
    from lut_renderer_tpu_torch.probes.harness import (
        KERNEL_B_CASES,
        PROBE_SOURCES,
        SEED,
        card_line,
        plain_rgb,
        probe_library,
        random_lut,
        time_ms,
        uniform_frames,
        uniform_rgb,
        yuv_frames,
    )

    # ---- 1. card and build ------------------------------------------------
    mark("1")
    card = card_line()
    print(f"phase 1 card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}", flush=True)
    # build from the sources: drop any library an earlier run left
    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    _build.load_library()
    print(f"phase 1 build: nvcc {' '.join(_build.NVCC_FLAGS)} -> "
          f"{_build.BUILD_DIR.name}/ in {_build.build_seconds:.2f} s",
          flush=True)

    report = {}

    # ---- 2. kernel A vs its plain version ---------------------------------
    mark("2")
    main_cfg = RenderConfig()
    # the main path's batch: 2 frames of 3840x2160 (executor batch rule);
    # planes of two kinds: ramp, the RGB that the plain layout hands the
    # LUT for the paths' frames, and uniform (every cell equally likely,
    # neighbours in unrelated cells)
    bsz = _pick_batch_size(3840, 2160)
    rgb_r = plain_rgb(yuv_frames(SEED + 1, bsz, 2160, 3840), main_cfg, dev)
    rgb_u = uniform_rgb(SEED, (bsz, 2160, 3840), dev)

    def lut_check(table, rgb, interps, what):
        plain = (lut3d.apply_lut_planes_coarse2_reference
                 if isinstance(table, Coarse2Table)
                 else lut3d.apply_lut_planes_reference)
        worst = 0.0
        for interp in interps:
            got = lut3d.apply_lut_planes(*rgb, table, interp)
            want = plain(*rgb, table, interp)
            torch.cuda.synchronize()
            err = max(float((a - e).abs().max()) for a, e in zip(got, want))
            if not err <= LUT_ATOL:
                fail(f"{what} {interp}: max|d|={err}")
            worst = max(worst, err)
        return worst

    table33 = LutTable.from_lut3d(random_lut(33, SEED), dev)
    err_a = lut_check(table33, rgb_u, INTERPS, "kernel A 4K 33^3 uniform")
    err_a = max(err_a, lut_check(table33, rgb_r, (TETRA,),
                                 "kernel A 4K 33^3 ramp"))
    # one element off: the planes are not 16-byte aligned (the scalar path)
    # and the pixel count is not a multiple of 4
    odd = [t.reshape(-1)[1:] for t in rgb_u]
    err_a = max(err_a, lut_check(table33, odd, (TETRA,),
                                 "kernel A 4K 33^3 scalar path"))
    for n in (65, 129):
        table = LutTable.from_lut3d(random_lut(n, SEED + n), dev)
        err_a = max(err_a, lut_check(table, [t[0, :1080, :1920] for t in rgb_u],
                                     (TETRA,), f"kernel A 1080p {n}^3"))
    # times of launches prepared once, replayed from a CUDA graph
    a_ms = time_ms(kernel_ac.prepared_launch(*rgb_r, table33, TETRA)[0], 20,
                   graph=True)
    a_uniform = time_ms(
        kernel_ac.prepared_launch(*rgb_u, table33, TETRA)[0], 20, graph=True)
    a_plain = time_ms(
        lambda: lut3d.apply_lut_planes_reference(*rgb_r, table33, TETRA), 3)
    # the library yardstick of the trilinear case: grid_sample on the
    # (1, 3, N, N, N) table, grid (x, y, z) = (b, g, r) in [-1, 1]
    tab_t = table33.table[..., :3].permute(3, 0, 1, 2)[None].contiguous()
    grid = torch.stack([c.clamp(0, 1).reshape(-1) * 2 - 1
                        for c in reversed(rgb_u)], -1).view(1, 1, 1, -1, 3)

    def library():
        return torch.nn.functional.grid_sample(
            tab_t, grid, mode="bilinear", padding_mode="border",
            align_corners=True)

    tri_launch, tri = kernel_ac.prepared_launch(*rgb_u, table33, "trilinear")
    tri_launch()
    lib_err = float((library()[0, :, 0, 0].reshape(3, *rgb_u[0].shape)
                     - torch.stack(tri)).abs().max())
    a_tri = time_ms(tri_launch, 20, graph=True)
    lib_ms = time_ms(library, 20)
    print(f"phase 2 kernel A: 5 interps at 4K 33^3 (uniform planes), ramp "
          f"planes, the scalar path, 1080p 65^3/129^3 tetrahedral, "
          f"max|d|={err_a:.3g} (<= {LUT_ATOL}); {bsz}x3840x2160 "
          f"tetrahedral: kernel {a_ms:.4f} ms on ramp planes, {a_uniform:.4f} "
          f"ms on uniform ones, plain {a_plain:.3f} ms; trilinear (uniform): "
          f"kernel {a_tri:.4f} ms, torch grid_sample {lib_ms:.3f} ms (max|d| "
          f"{lib_err:.3g} vs kernel)", flush=True)
    report["A"] = dict(err=err_a, ms=a_ms, uniform_ms=a_uniform,
                       plain_ms=a_plain, library_ms=lib_ms,
                       trilinear_ms=a_tri, library_err=lib_err,
                       table=table_bytes(table33))
    del tri, grid, tab_t, tri_launch, odd

    # ---- 2C. kernel C vs its plain version --------------------------------
    mark("2C")
    err_c, c_times = 0.0, {}
    for n in (65, 97, 129):
        exact = LutTable.from_lut3d(random_lut(n, SEED + n), dev)
        for tier in COARSE2:
            table = Coarse2Table.from_lut_table(exact, tier)
            interps = INTERPS if (n, tier) == (129, BIG) else (TETRA,)
            err_c = max(err_c, lut_check(table, rgb_u, interps,
                                         f"kernel C {n}^3 {tier}"))
            if tier != BIG:
                continue
            err_c = max(err_c, lut_check(table, rgb_r, (TETRA,),
                                         f"kernel C {n}^3 {tier} ramp"))
            # kernel A on the exact table and kernel C on the same planes,
            # in turns (A, C, C, A)
            c_times[n] = dict(A_table=table_bytes(exact),
                              C_table=table_bytes(table))
            for kind, rgb in (("ramp", rgb_r), ("uniform", rgb_u)):
                run_a = kernel_ac.prepared_launch(*rgb, exact, TETRA)[0]
                run_c = kernel_ac.prepared_launch(*rgb, table, TETRA)[0]
                t = [time_ms(f, 20, graph=True)
                     for f in (run_a, run_c, run_c, run_a)]
                c_times[n][kind] = dict(A_ms=(t[0] + t[3]) / 2,
                                        C_ms=(t[1] + t[2]) / 2)
    # every (interp, residual interp) instantiation: the _tri tier under
    # each interp
    # the LUT table build at 129^3 on the device (ops/prepare, warm): the
    # exact table from a parsed LUT, then its coarse + residual tables
    lut129 = random_lut(129, SEED + 129)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    big_exact = LutTable.from_lut3d(lut129, dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    big_c = Coarse2Table.from_lut_table(big_exact, BIG)
    torch.cuda.synchronize()
    build_ms = {"exact 129^3": (t1 - t0) * 1e3,
                f"{BIG} 129^3": (time.perf_counter() - t1) * 1e3}
    err_c = max(err_c, lut_check(
        Coarse2Table.from_lut_table(big_exact, "coarse2f_tri"), rgb_u,
        INTERPS, "kernel C 129^3 coarse2f_tri"))
    c_plain = time_ms(lambda: lut3d.apply_lut_planes_coarse2_reference(
        *rgb_r, big_c, TETRA), 2, warmup=1)
    print(f"phase 2C kernel C: 4K x {bsz} at 65^3/97^3/129^3 x "
          f"{'/'.join(COARSE2)} tetrahedral, 5 interps at 129^3 {BIG} and "
          f"coarse2f_tri, ramp planes; max|d|={err_c:.3g} (<= {LUT_ATOL}); "
          f"{bsz}x3840x2160 tetrahedral {BIG}, ramp / uniform planes: "
          + ", ".join(
              f"{n}^3 kernel C {v['ramp']['C_ms']:.4f} / "
              f"{v['uniform']['C_ms']:.4f} ms vs kernel A exact "
              f"{v['ramp']['A_ms']:.4f} / {v['uniform']['A_ms']:.4f} ms"
              for n, v in c_times.items())
          + f"; plain at 129^3 {c_plain:.3f} ms; table build "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in build_ms.items()),
          flush=True)
    report["C"] = dict(err=err_c, ms=c_times[129]["ramp"]["C_ms"],
                       uniform_ms=c_times[129]["uniform"]["C_ms"],
                       plain_ms=c_plain, table=c_times[129]["C_table"])
    del big_c, big_exact, exact, table

    # ---- 2P. the stage probe of kernels A and C -----------------------------
    mark("2P")
    t0 = time.perf_counter()
    probe_library()
    print(f"phase 2P build: {', '.join(PROBE_SOURCES)} -> the probes' "
          f"library in {time.perf_counter() - t0:.2f} s", flush=True)
    ac_stages = kernel_ac.stage_times(dev, ("A 33^3", "C 129^3 coarse2f"))
    print("phase 2P kernels A and C stages, 4K x 2 tetrahedral (io: "
          "load/store; weights: + domain map, cells, sums; coarse / resid: "
          "one term of C with its loads; full: production): " + "; ".join(
              f"{case} {kind} " + ", ".join(
                  f"{s} {ms:.4f} ms" for s, ms in t.items())
              for case, kinds in ac_stages.items()
              for kind, t in kinds.items()), flush=True)

    # ---- 3. kernel B vs its plain version ---------------------------------
    mark("3")
    lut33 = random_lut(33, SEED)

    def fused_check(cfg, b, h, w, lut, seed, what, tier=None):
        table = LutTable.from_lut3d(lut, dev)
        if tier is not None:
            table = Coarse2Table.from_lut_table(table, tier)
        planes = [torch.from_numpy(p).to(dev) for p in
                  yuv_frames(seed, b, h, w, cfg.in_depth,
                             cfg.in_subsampling)]
        got = fused420.render_fused420(*planes, table, cfg)
        want = fused420.render_fused420_reference(*planes, table, cfg)
        torch.cuda.synchronize()
        return code_diff(got, want, f"kernel B {what}"), planes, table

    worst_b, planes4k, tab = fused_check(main_cfg, bsz, 2160, 3840, lut33,
                                         SEED + 1, "4K 420p8")
    cases = KERNEL_B_CASES
    for what, (kw, (b, h, w), (n, lut_seed), seed) in cases.items():
        lut = lut33 if n == 33 else random_lut(n, SEED + lut_seed)
        d, _, _ = fused_check(replace(main_cfg, **kw), b, h, w, lut,
                              SEED + seed, what)
        worst_b = max(worst_b, d)
    # kernel times: launches prepared once and replayed from a CUDA graph,
    # so that the wrapper's host work stays out of the device time; ramp
    # frames (the main path's) and uniform-random codes (the worst case for
    # divergence and gathers)
    uniform4k = [torch.from_numpy(p).to(dev)
                 for p in uniform_frames(SEED + 1, bsz, 2160, 3840)]
    d = code_diff(fused420.render_fused420(*uniform4k, tab, main_cfg),
                  fused420.render_fused420_reference(*uniform4k, tab,
                                                     main_cfg),
                  "kernel B 4K 420p8 uniform-random")
    worst_b = max(worst_b, d)
    b_ms = time_ms(kernel_b.prepared_launch(*planes4k, tab, main_cfg)[0], 20,
                   graph=True)
    b_uniform = time_ms(
        kernel_b.prepared_launch(*uniform4k, tab, main_cfg)[0], 20,
        graph=True)
    b_wrapper = time_ms(
        lambda: fused420.render_fused420(*planes4k, tab, main_cfg), 20)
    b_plain = time_ms(
        lambda: fused420.render_fused420_reference(*planes4k, tab, main_cfg), 3)
    print(f"phase 3 kernel B: 4K 420p8 ramp and uniform-random + "
          f"{len(cases)} cases, max|d|={worst_b} code value(s) (contract "
          f"<= 1 on < 1e-3 of px); {bsz}x3840x2160 420p8 tetrahedral: "
          f"kernel {b_ms:.3f} ms (uniform-random frames {b_uniform:.3f} "
          f"ms; through the wrapper {b_wrapper:.3f} ms), plain "
          f"{b_plain:.3f} ms", flush=True)
    report["B"] = dict(err=worst_b, ms=b_ms, plain_ms=b_plain,
                       uniform_ms=b_uniform, table=table_bytes(tab))
    del uniform4k

    # kernel B's coarse2 instantiation at 4K, beside the exact one at the
    # same N on the same planes (exact, coarse2, coarse2, exact)
    worst_b2, b2_times = 0, {}
    big_cfg = replace(main_cfg, lut_precision=BIG)
    for n in (65, 129):
        lut = random_lut(n, SEED + 200 + n)
        d, planes, tab2 = fused_check(big_cfg, bsz, 2160, 3840, lut,
                                      SEED + 1, f"4K 420p8 {n}^3 {BIG}",
                                      tier=BIG)
        worst_b2 = max(worst_b2, d)
        tab_x = LutTable.from_lut3d(lut, dev)
        run_x = kernel_b.prepared_launch(*planes, tab_x, main_cfg)[0]
        run_2 = kernel_b.prepared_launch(*planes, tab2, big_cfg)[0]
        t = [time_ms(f, 20, graph=True) for f in (run_x, run_2, run_2, run_x)]
        b2_times[n] = dict(B_ms=(t[0] + t[3]) / 2, B_coarse2_ms=(t[1] + t[2]) / 2)
        if n == 129:
            uniform = [torch.from_numpy(p).to(dev)
                       for p in uniform_frames(SEED + 1, bsz, 2160, 3840)]
            d = code_diff(fused420.render_fused420(*uniform, tab2, big_cfg),
                          fused420.render_fused420_reference(*uniform, tab2,
                                                             big_cfg),
                          f"kernel B 4K 420p8 {n}^3 {BIG} uniform-random")
            worst_b2 = max(worst_b2, d)
            b2_uniform = time_ms(
                kernel_b.prepared_launch(*uniform, tab2, big_cfg)[0], 20,
                graph=True)
            b2_plain = time_ms(lambda: fused420.render_fused420_reference(
                *planes, tab2, big_cfg), 2, warmup=1)
            report["B coarse2"] = dict(ms=b2_times[n]["B_coarse2_ms"],
                                       plain_ms=b2_plain,
                                       uniform_ms=b2_uniform,
                                       table=table_bytes(tab2))
            del uniform
    d, _, _ = fused_check(replace(big_cfg, in_depth=10, out_depth=10,
                                  in_subsampling="422",
                                  out_subsampling="422", dither="random"),
                          1, 1080, 1920, random_lut(129, SEED + 329),
                          SEED + 30, "422p10 129^3 coarse2x", tier="coarse2x")
    worst_b2 = max(worst_b2, d)
    report["B coarse2"]["err"] = worst_b2
    print(f"phase 3 kernel B coarse2: 4K 420p8 at 65^3 and 129^3 {BIG} "
          f"(129^3 also on uniform-random frames) + 1080p 422p10 129^3 "
          f"coarse2x random dither, max|d|={worst_b2} code value(s); "
          f"{bsz}x3840x2160 420p8 tetrahedral: " + ", ".join(
              f"{n}^3 coarse2 {v['B_coarse2_ms']:.3f} ms vs exact "
              f"{v['B_ms']:.3f} ms" for n, v in b2_times.items())
          + f"; 129^3 coarse2 on uniform-random frames {b2_uniform:.3f} ms; "
          f"plain at 129^3 {b2_plain:.3f} ms", flush=True)
    del planes4k, rgb_r, rgb_u, planes

    # ---- 3P. kernel B's stage probe -------------------------------------
    mark("3P")
    stages = kernel_b.stage_times(dev)["current"]
    print("phase 3P kernel B stages, 4K x 2 420p8 33^3 tetrahedral (io: "
          "load/convert/quantise/store; color: + range, YUV<->RGB, dither, "
          "downsample; full: + LUT): " + "; ".join(
              f"{frames} frames " + ", ".join(
                  f"{s} {ms:.4f} ms" for s, ms in t.items())
              for frames, t in stages.items()), flush=True)

    # ---- 4. main path -----------------------------------------------------
    mark("4")
    n_frames = 48
    frames = yuv_frames(SEED + 4, n_frames, 2160, 3840)
    batches = [(frames[0][i:i + bsz], frames[1][i:i + bsz],
                frames[2][i:i + bsz], bsz) for i in range(0, n_frames, bsz)]
    # a second job of the same path: error-diffusion output takes the plain
    # layout, whose LUT step is kernel A (the host finishes the dither)
    ed_cfg = replace(main_cfg, dither="error_diffusion_host")
    ed_batches = batches[:4]
    head_fn = make_render_fn(lut33, main_cfg, dev)
    ed_fn = make_render_fn(lut33, ed_cfg, dev)

    def no_plain(*a, **k):
        raise AssertionError("a plain version ran on the main path")

    # a first pass warms PyTorch's pinned host-memory cache; it is timed as
    # a cold start and its launches are not counted
    t0 = time.perf_counter()
    for _ in render_batches(iter(batches), head_fn, dev):
        pass
    cold_fps = n_frames / (time.perf_counter() - t0)

    plains = ((fused420, "render_fused420_reference"),
              (lut3d, "apply_lut_planes_reference"),
              (lut3d, "apply_lut_planes_coarse2_reference"),
              (resample, "resample_plane_reference"))
    counters = {"A": (lut3d, "launches"), "C": (lut3d, "coarse2_launches"),
                "B": (fused420, "launches"),
                "B coarse2": (fused420, "coarse2_launches")}

    def start_path():
        """Plain versions raise; every launch count is set to 0."""
        saved = [getattr(m, name) for m, name in plains]
        for m, name in plains:
            setattr(m, name, no_plain)
        for m, name in counters.values():
            setattr(m, name, 0)
        torch.cuda.synchronize()
        return saved

    def end_path(saved):
        """The launch counts of the path; the plain versions back."""
        torch.cuda.synchronize()
        for (m, name), fn in zip(plains, saved):
            setattr(m, name, fn)
        return {k: getattr(m, name) for k, (m, name) in counters.items()}

    saved = start_path()
    # outputs are consumed as they come, as the encoder thread does, so the
    # pinned output buffers recycle; only the first batch is kept
    first_out, n_out = None, 0
    t0 = time.perf_counter()
    for o in render_batches(iter(batches), head_fn, dev):
        if o[0].shape != (bsz, 2160, 3840) or o[1].shape != (bsz, 1080, 1920) \
                or o[0].dtype != np.uint8:
            fail(f"main path output shape {o[0].shape} {o[0].dtype}")
        if first_out is None:
            first_out = [p.copy() for p in o[:3]]
        n_out += o[3]
    wall = time.perf_counter() - t0
    t1 = time.perf_counter()
    for o in render_batches(iter(ed_batches), ed_fn, dev):
        if not all(np.isfinite(p).all() for p in o[:3]):
            fail("error-diffusion planes not finite")
    ed_wall = time.perf_counter() - t1
    launches = end_path(saved)

    if launches != {"A": len(ed_batches), "C": 0, "B": len(batches),
                    "B coarse2": 0}:
        fail(f"main path launches {launches}, expected B={len(batches)} "
             f"A={len(ed_batches)}")
    if n_out != n_frames:
        fail(f"main path returned {n_out} of {n_frames} frames")
    first = [torch.from_numpy(p).to(dev) for p in batches[0][:3]]
    want = fused420.render_fused420_reference(*first,
                                              LutTable.from_lut3d(lut33, dev),
                                              main_cfg)
    d_main = code_diff([torch.from_numpy(p) for p in first_out],
                       [w.cpu() for w in want], "main path first batch")
    fps = n_frames / wall
    # the layer split of one batch: H2D, kernel, D2H (CUDA events)
    host = [torch.from_numpy(p).pin_memory() for p in batches[1][:3]]
    h2d_ms = time_ms(lambda: [h.to(dev, non_blocking=True) for h in host], 10)
    dev_in = [h.to(dev) for h in host]
    dev_out = head_fn(*dev_in)
    pinned = [torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
              for o in dev_out]
    d2h_ms = time_ms(lambda: [p.copy_(o, non_blocking=True)
                              for p, o in zip(pinned, dev_out)], 10)
    print(f"phase 4 main path: {n_frames} frames 3840x2160 420p8 33^3 "
          f"tetrahedral in {len(batches)} batches of {bsz}: {wall:.3f} s = "
          f"{fps:.2f} fps end to end (H2D and D2H included; first, cold "
          f"pass {cold_fps:.2f} fps); per batch "
          f"H2D {h2d_ms:.3f} ms, kernel B {b_ms:.3f} ms, D2H {d2h_ms:.3f} "
          f"ms; first batch vs plain max|d|={d_main}; error-diffusion job "
          f"{len(ed_batches) * bsz} frames in {ed_wall:.3f} s via kernel A; "
          f"launches {launches}; card {card}", flush=True)
    del frames, batches, ed_batches, first_out, dev_in, dev_out, pinned, host

    # ---- 4C. big-cube path: 129^3 at the coarse2f tier ----------------------
    mark("4C")
    n_big = 16
    lut129 = random_lut(129, SEED + 129)
    frames = yuv_frames(SEED + 40, n_big, 2160, 3840)
    big_batches = [(frames[0][i:i + bsz], frames[1][i:i + bsz],
                    frames[2][i:i + bsz], bsz) for i in range(0, n_big, bsz)]
    big_ed = big_batches[:2]
    big_ed_cfg = replace(big_cfg, dither="error_diffusion_host")
    big_fn = make_render_fn(lut129, big_cfg, dev)
    big_ed_fn = make_render_fn(lut129, big_ed_cfg, dev)
    t0 = time.perf_counter()
    for _ in render_batches(iter(big_batches), big_fn, dev):
        pass
    big_cold = n_big / (time.perf_counter() - t0)

    saved = start_path()
    first_out, n_out = None, 0
    t0 = time.perf_counter()
    for o in render_batches(iter(big_batches), big_fn, dev):
        if o[0].shape != (bsz, 2160, 3840) or o[0].dtype != np.uint8:
            fail(f"big-cube path output shape {o[0].shape} {o[0].dtype}")
        if first_out is None:
            first_out = [p.copy() for p in o[:3]]
        n_out += o[3]
    big_wall = time.perf_counter() - t0
    t1 = time.perf_counter()
    ed_first = None
    for o in render_batches(iter(big_ed), big_ed_fn, dev):
        if not all(np.isfinite(p).all() for p in o[:3]):
            fail("big-cube error-diffusion planes not finite")
        if ed_first is None:
            ed_first = [p.copy() for p in o[:3]]
    big_ed_wall = time.perf_counter() - t1
    big_launches = end_path(saved)

    if big_launches != {"A": 0, "C": len(big_ed), "B": 0,
                        "B coarse2": len(big_batches)}:
        fail(f"big-cube path launches {big_launches}, expected B coarse2="
             f"{len(big_batches)} C={len(big_ed)}")
    if n_out != n_big:
        fail(f"big-cube path returned {n_out} of {n_big} frames")
    big_table = Coarse2Table.from_lut_table(LutTable.from_lut3d(lut129, dev),
                                            BIG)
    first = [torch.from_numpy(p).to(dev) for p in big_batches[0][:3]]
    want = fused420.render_fused420_reference(*first, big_table, big_cfg)
    d_big = code_diff([torch.from_numpy(p) for p in first_out],
                      [w.cpu() for w in want], "big-cube path first batch")
    # the error-diffusion job's float planes against the plain layout with
    # the plain coarse2 LUT: the LUT's 1e-5 times the matrices' gain
    want = render_planes(*first, big_ed_cfg, lambda r, g, b:
                         lut3d.apply_lut_planes_coarse2_reference(
                             r, g, b, big_table, big_ed_cfg.interp))
    d_ed = max(float(np.abs(a - e.cpu().numpy()).max())
               for a, e in zip(ed_first, want))
    if not d_ed <= ED_ATOL:
        fail(f"big-cube error-diffusion planes max|d|={d_ed} > {ED_ATOL}")
    big_fps = n_big / big_wall
    print(f"phase 4C big-cube path: {n_big} frames 3840x2160 420p8 129^3 "
          f"{BIG} tetrahedral in {len(big_batches)} batches of {bsz}: "
          f"{big_wall:.3f} s = {big_fps:.2f} fps end to end (first, cold "
          f"pass {big_cold:.2f} fps); first batch vs plain max|d|={d_big}; "
          f"error-diffusion job {len(big_ed) * bsz} frames in "
          f"{big_ed_wall:.3f} s via kernel C, float planes vs plain "
          f"max|d|={d_ed:.3g} code values; launches {big_launches}",
          flush=True)
    del frames, big_batches, big_ed, first_out, ed_first, want, first

    # ---- 5. file to file --------------------------------------------------
    mark("5")
    from lut_renderer_tpu_torch.hostio.ffi import FFIUnavailable, get_ffi

    # only hostio's own "no FFmpeg libraries here" skips the phase; any
    # other failure fails the run
    try:
        import cv2  # noqa: F401
        get_ffi()
        probe = None
    except ImportError as exc:
        if exc.name != "cv2":
            raise
        probe = f"ImportError: {exc}"
    except FFIUnavailable as exc:
        probe = f"FFIUnavailable: {exc}"
    if probe is not None:
        print(f"phase 5 file to file: skipped, hostio cannot load its "
              f"FFmpeg libraries ({probe[:160]})", flush=True)
    else:
        from lut_renderer_tpu_torch.app import cli
        from lut_renderer_tpu_torch.colorcore import write_cube_file
        from lut_renderer_tpu_torch.hostio.decode import VideoDecoder
        from lut_renderer_tpu_torch.utils.fixtures import make_gradient_clip

        tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_", dir=Path.cwd()))
        # the CLI's settings and LUT history stay inside the run's directory
        os.environ["LUT_TPU_CONFIG_DIR"] = str(tmp / "config")
        os.environ["LUT_TPU_THUMB_DIR"] = str(tmp / "thumbs")
        try:
            clip = make_gradient_clip(tmp / "clip.mp4", 640, 360, frames=24,
                                      pattern="zoneplate")
            cube = write_cube_file(tmp / "look.cube", lut33)
            decoded = {}
            for device in ("cuda", "cpu"):
                out_dir = tmp / device
                before = fused420.launches
                rc = cli.main(["render", str(clip), "--lut", str(cube),
                               "--out-dir", str(out_dir), "--codec", "ffv1",
                               "--pix-fmt", "yuv420p", "--device", device])
                if rc != 0:
                    fail(f"CLI render --device {device} exited {rc}")
                if device == "cuda" and fused420.launches == before:
                    fail("CLI render --device cuda launched no kernel B")
                (out,) = [p for p in out_dir.iterdir() if p.is_file()]
                with VideoDecoder(out) as dec:
                    fr = list(dec)
                decoded[device] = [torch.from_numpy(np.stack(
                    [getattr(f, c) for f in fr])) for c in "yuv"]
            d_file = code_diff(decoded["cuda"], decoded["cpu"],
                               "file to file cuda vs cpu")
            print(f"phase 5 file to file: hostio loads; CLI render 640x360 "
                  f"x{decoded['cuda'][0].shape[0]} frames --device cuda vs "
                  f"--device cpu, max|d|={d_file}", flush=True)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    # ---- 6. resize path: kernel A, then the resample -------------------------
    mark("6")
    from lut_renderer_tpu_torch.ops.resample import (
        bands_on,
        resample_plane,
        resample_plane_dense,
        resample_plane_reference,
        weights_on,
    )

    def resample_fn(fn, wv, wh):
        return lambda r, g, b: tuple(fn(p, wv, wh) for p in (r, g, b))

    def resize_path(what, in_wh, out_wh, n_frames, seed, **kw):
        """The executor's device loop over seeded frames resized in_wh ->
        out_wh (kernel A at the input size, then the resample); its launch
        counts, the first batch against the plain version, fps, and the
        per-batch split from CUDA events."""
        (w, h), (ow, oh) = in_wh, out_wh
        cfg = replace(main_cfg, resize=out_wh, **kw)
        ed = cfg.dither == "error_diffusion_host"
        b = _pick_batch_size(w, h)
        fr = yuv_frames(seed, n_frames, h, w)
        bats = [(fr[0][i:i + b], fr[1][i:i + b], fr[2][i:i + b],
                 len(fr[0][i:i + b])) for i in range(0, n_frames, b)]
        fn = make_render_fn(lut33, cfg, dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        for _ in render_batches(iter(bats), fn, dev):
            pass
        cold = n_frames / (time.perf_counter() - t0)
        saved = start_path()
        rs_before = resample.launches
        first, n_out = None, 0
        t0 = time.perf_counter()
        for o in render_batches(iter(bats), fn, dev):
            if o[0].shape[1:] != (oh, ow) \
                    or o[1].shape[1:] != (oh // 2, ow // 2):
                fail(f"{what} output shapes {o[0].shape} {o[1].shape}")
            if ed and not all(np.isfinite(p).all() for p in o[:3]):
                fail(f"{what} error-diffusion planes not finite")
            if first is None:
                first = [p.copy() for p in o[:3]]
            n_out += o[3]
        wall = time.perf_counter() - t0
        counts = end_path(saved)
        rs_launches = resample.launches - rs_before
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        if counts != {"A": len(bats), "C": 0, "B": 0, "B coarse2": 0}:
            fail(f"{what} launches {counts}, expected A={len(bats)}")
        if rs_launches != 3 * len(bats):
            fail(f"{what} resample launches {rs_launches}, expected "
                 f"{3 * len(bats)}")
        if n_out != n_frames:
            fail(f"{what} returned {n_out} of {n_frames} frames")
        # the plain version: kernel A's plain twin, the resample's
        planes = [torch.from_numpy(p).to(dev) for p in bats[0][:3]]
        wv, wh = weights_on((h, w), out_wh, dev)
        bv, bh = bands_on((h, w), out_wh, dev)
        want = render_planes(*planes, cfg, lambda r, g, bb:
                             lut3d.apply_lut_planes_reference(
                                 r, g, bb, table33, cfg.interp),
                             resample_fn(resample_plane_reference, bv, bh))
        if ed:
            d = max(float(np.abs(a - e.cpu().numpy()).max())
                    for a, e in zip(first, want))
            if not d <= ED_ATOL:
                fail(f"{what} float planes max|d|={d} > {ED_ATOL}")
        else:
            d = code_diff([torch.from_numpy(p) for p in first],
                          [x.cpu() for x in want], f"{what} first batch")
        # one batch's split (CUDA events): kernel A on the RGB the plain
        # layout hands it, the resample of its output, the whole render
        # function (the rest is what remains), H2D and D2H
        rgb = plain_rgb(bats[1][:3] if len(bats) > 1 else bats[0][:3], cfg,
                        dev)
        a_ms = time_ms(kernel_ac.prepared_launch(*rgb, table33, TETRA)[0], 10,
                       graph=True)
        lut_out = kernel_ac.prepared_launch(*rgb, table33, TETRA)
        lut_out[0]()
        # the resample of kernel A's output: the kernel (launches captured
        # in a CUDA graph, as kernel A's), bit-equal to its plain version;
        # the plain version and the dense products (library_ms) beside it
        rs = resample_fn(resample_plane, bv, bh)
        rs_plain = resample_fn(resample_plane_reference, bv, bh)
        rs_dense = resample_fn(resample_plane_dense, wv, wh)
        if not all(torch.equal(a, e) for a, e in zip(rs(*lut_out[1]),
                                                      rs_plain(*lut_out[1]))):
            fail(f"{what} resample kernel differs from its plain version")
        rs_ms = time_ms(lambda: rs(*lut_out[1]), 10, graph=True)
        rs_plain_ms = time_ms(lambda: rs_plain(*lut_out[1]), 3)
        rs_lib_ms = time_ms(lambda: rs_dense(*lut_out[1]), 3)
        dev_in = [torch.from_numpy(p).to(dev) for p in bats[-1][:3]]
        total_ms = time_ms(lambda: fn(*dev_in), 5)
        host = [torch.from_numpy(p).pin_memory() for p in bats[-1][:3]]
        h2d = time_ms(lambda: [x.to(dev, non_blocking=True) for x in host], 10)
        outs = fn(*dev_in)
        pinned = [torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                  for o in outs]
        d2h = time_ms(lambda: [p.copy_(o, non_blocking=True)
                               for p, o in zip(pinned, outs)], 10)
        # the resample's work on this batch: dense products as the library
        # runs them, and the least time for its function (planes in and out
        # once; the banded taps of the weights)
        dense_flops = 3 * b * 2 * (oh * h * w + oh * w * ow)
        banded_flops = 3 * b * 2 * (int((wv != 0).sum()) * w
                                    + int((wh != 0).sum()) * oh)
        rs_bound, rs_by = bound(3 * b * 4 * (h * w + oh * ow), banded_flops)
        rec = dict(frames=n_frames, batch=b, fps=n_frames / wall,
                   cold_fps=cold, max_abs_diff=d, launches=counts["A"],
                   peak_device_gb=peak_gb, kernel_a_ms=a_ms,
                   resample_ms=rs_ms, resample_plain_ms=rs_plain_ms,
                   resample_library_ms=rs_lib_ms,
                   resample_launches=rs_launches,
                   rest_ms=total_ms - a_ms - rs_ms,
                   render_fn_ms=total_ms, h2d_ms=h2d, d2h_ms=d2h,
                   resample_dense_gflop=dense_flops / 1e9,
                   resample_dense_floor_ms=dense_flops / F32_FLOPS_PER_S
                   * 1e3,
                   resample_bound_ms=rs_bound, resample_bound_by=rs_by,
                   resample_share=rs_bound / rs_ms)
        print(f"phase 6 {what}: {n_frames} frames {w}x{h} -> {ow}x{oh} "
              f"420p8 33^3 tetrahedral{' ' + cfg.dither if kw else ''} in "
              f"{len(bats)} batches of {b}: {rec['fps']:.2f} fps end to end "
              f"(cold pass {cold:.2f}); per batch kernel A {a_ms:.4f} ms, "
              f"resample {rs_ms:.4f} ms (bound {rs_bound:.4f} ms by {rs_by},"
              f" share {rec['resample_share']:.3%}; plain {rs_plain_ms:.3f} "
              f"ms; dense torch.matmul pair {rs_lib_ms:.3f} ms, "
              f"{rec['resample_dense_gflop']:.1f} GFLOP, f32 floor "
              f"{rec['resample_dense_floor_ms']:.3f} ms), rest of the plain "
              f"layout "
              f"{rec['rest_ms']:.3f} ms (render fn {total_ms:.3f}), H2D "
              f"{h2d:.3f} ms, D2H {d2h:.3f} ms; first batch vs plain "
              f"max|d|={d:.3g}; launches {counts}, resample {rs_launches}; "
              f"peak device memory "
              f"{peak_gb:.2f} GB; card {card}", flush=True)
        return rec

    resize = {
        "4K->1080p": resize_path("4K->1080p", (3840, 2160), (1920, 1080),
                                 16, SEED + 60),
        "1080p->4K": resize_path("1080p->4K", (1920, 1080), (3840, 2160),
                                 16, SEED + 61),
        "4K->1080p ordered": resize_path("4K->1080p ordered", (3840, 2160),
                                         (1920, 1080), 8, SEED + 62,
                                         dither="ordered"),
        "4K->1080p error diffusion": resize_path(
            "4K->1080p error diffusion", (3840, 2160), (1920, 1080), 4,
            SEED + 63, dither="error_diffusion_host"),
    }

    # ---- 6T. the resample's precision, and TF32 invariance ---------------
    mark("6T")
    precision = {}
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    for what, (h, w), out_wh in (("4K->1080p", (2160, 3840), (1920, 1080)),
                                 ("1080p->4K", (1080, 1920), (3840, 2160))):
        x = torch.rand((2, h, w), generator=g, device=dev)
        wv, wh = weights_on((h, w), out_wh, dev)
        got = resample_plane(x, wv, wh)
        ref = torch.matmul(torch.matmul(wv.double(), x.double()),
                           wh.double().t())
        rel = float((got.double() - ref).abs().max() / ref.abs().max())
        if not rel < RESAMPLE_RTOL:
            fail(f"resample {what}: max relative error {rel} >= "
                 f"{RESAMPLE_RTOL} against float64 (not full f32)")
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            again = resample_plane(x, wv, wh)
            # the same product outside ops.resample, under TF32: what the
            # switch keeps out
            loose = torch.matmul(torch.matmul(wv, x), wh.t())
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        if not torch.equal(got, again):
            fail(f"resample {what}: output changed with allow_tf32=True")
        loose_rel = float((loose.double() - ref).abs().max()
                          / ref.abs().max())
        precision[what] = dict(max_rel_err=rel, tf32_bit_equal=True,
                               unguarded_tf32_max_rel_err=loose_rel)
        print(f"phase 6T resample precision {what} x2: max relative error "
              f"{rel:.3g} against float64 (< {RESAMPLE_RTOL}); bit-equal "
              f"with allow_tf32=True set by the phase (a plain matmul "
              f"under TF32: {loose_rel:.3g})", flush=True)
    del x, got, again, loose, ref

    # ---- 7. the batch split over two streams of one card ---------------------
    mark("7")
    from lut_renderer_tpu_torch.parallel import (
        default_mesh,
        make_sharded_render_fn,
    )

    meshes = [["cuda:0", "cuda:0"]]
    if torch.cuda.device_count() > 1:
        meshes.append([str(d) for d in default_mesh()])
    split = {}
    for mesh in meshes:
        for what, cfg, key, (w, h) in (
                ("main path", main_cfg, "B", (3840, 2160)),
                ("resize path", replace(main_cfg, resize=(1920, 1080)), "A",
                 (3840, 2160))):
            fn = make_render_fn(lut33, cfg, dev)
            sharded = make_sharded_render_fn(lut33, cfg, mesh)
            # two frames a chunk, then one chunk a frame short
            for n in (2 * len(mesh), 2 * len(mesh) - 1):
                fr = yuv_frames(SEED + 70 + n, n, h, w)
                planes = [torch.from_numpy(p).to(dev) for p in fr]
                whole = fn(*planes)
                saved = start_path()
                parts = sharded(*planes)
                from_host = sharded(*(torch.from_numpy(p).pin_memory()
                                      for p in fr))
                counts = end_path(saved)
                if counts[key] != 2 * len(mesh) or sum(counts.values()) \
                        != counts[key]:
                    fail(f"split {mesh} {what}: launches {counts}")
                for a, e, c in zip(parts, whole, from_host):
                    if not (torch.equal(a, e) and torch.equal(c, e)):
                        fail(f"split {mesh} {what} batch {n}: not bit-equal "
                             f"to the whole batch")
            split[f"{'+'.join(mesh)} {what}"] = "bit-equal"
            print(f"phase 7 split over {mesh} ({what}, 4K 420p8 33^3, "
                  f"batches of {2 * len(mesh)} and {2 * len(mesh) - 1}, "
                  f"device and pinned host inputs): "
                  f"bit-equal to the whole batch; kernel {key} launched "
                  f"once a chunk", flush=True)
    del planes, whole, parts, from_host

    # ---- 8. serve ----------------------------------------------------------
    mark("8")
    import contextlib
    import io

    from lut_renderer_tpu_torch.app import cli
    from lut_renderer_tpu_torch.app.server import QueueServer
    from lut_renderer_tpu_torch.engine.warmup import warmup_kernels

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_serve_", dir=Path.cwd()))
    os.environ["LUT_TPU_CONFIG_DIR"] = str(tmp / "config")
    os.environ["LUT_TPU_THUMB_DIR"] = str(tmp / "thumbs")

    def client(req):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["client", json.dumps(req), "--socket", str(sock)])
        resp = json.loads(buf.getvalue())
        if rc != 0 or not resp.get("ok"):
            fail(f"serve: client {req} -> rc {rc}, {resp}")
        return resp

    try:
        t0 = time.perf_counter()
        recs = warmup_kernels("cuda")
        warm_s = time.perf_counter() - t0
        if not all(r["ok"] for r in recs):
            fail(f"serve warmup: {recs}")
        # a short relative path: a Unix socket's path is at most 107 bytes
        sock = Path(os.path.relpath(tmp)) / "serve.sock"
        t0 = time.perf_counter()
        server = QueueServer(sock, device="cuda")
        server.start()
        start_s = time.perf_counter() - t0
        try:
            ping = client({"op": "ping"})
            status = client({"op": "status"})
            submitted = "skipped, hostio cannot load its FFmpeg libraries"
            if probe is None:
                from lut_renderer_tpu_torch.colorcore import write_cube_file
                from lut_renderer_tpu_torch.hostio.decode import VideoDecoder
                from lut_renderer_tpu_torch.utils.fixtures import (
                    make_gradient_clip,
                )

                clip = make_gradient_clip(tmp / "clip.mp4", 640, 360,
                                          frames=12, pattern="zoneplate")
                cube = write_cube_file(tmp / "look.cube", lut33)
                resp = client({"op": "submit", "files": [str(clip)],
                               "lut": str(cube), "out_dir": str(tmp / "out"),
                               "params": {"video_codec": "ffv1",
                                          "resolution": "320x180"}})
                (tid,) = resp["task_ids"]
                if not server.manager.wait_all(timeout=300):
                    fail("serve: the submitted job did not finish")
                task = client({"op": "status", "task_id": tid})["task"]
                if task["status"] != "completed":
                    fail(f"serve: job {task['status']}: {task['error']}")
                with VideoDecoder(task["output"]) as dec:
                    if (dec.width, dec.height) != (320, 180):
                        fail(f"serve: output {dec.width}x{dec.height}, "
                             f"expected 320x180")
                submitted = "640x360 clip -> 320x180 output"
            client({"op": "shutdown"})
            if not server.shutdown_requested.wait(10):
                fail("serve: shutdown was not signalled")
        finally:
            server.stop()
        print(f"phase 8 serve: warmup {warm_s:.2f} s ("
              + ", ".join(f"{r['label']} {r['seconds']} s" for r in recs)
              + f"), QueueServer up in {start_s:.3f} s on device cuda; "
              f"client ping {ping}, status of {len(status['tasks'])} "
              f"task(s), submit: {submitted}; shutdown", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # ---- 9. BASELINE configurations through the device loop ---------------
    mark("9")
    from lut_renderer_tpu_torch.ops.render import lut_operands_for
    from lut_renderer_tpu_torch.probes.baseline import baseline_stages
    from lut_renderer_tpu_torch.probes.harness import device_frames

    sub_shift = {"420": (1, 1), "422": (1, 0), "444": (0, 0)}  # (x, y)

    def batches_of(frames, b):
        n = len(frames[0])
        return [(frames[0][i:i + b], frames[1][i:i + b], frames[2][i:i + b],
                 min(b, n - i)) for i in range(0, n, b)]

    def baseline_run(st, bats, lut):
        """The stage's render function over `bats` through the device loop:
        a cold pass, then a counted one; the first batch against its plain
        version; one batch's CUDA-event split; peak device memory."""
        cfg, (w, h) = st.cfg, (st.info.width, st.info.height)
        sx, sy = sub_shift[cfg.out_subsampling]
        shapes = [(h, w), (h >> sy, w >> sx), (h >> sy, w >> sx)]
        dtype = np.uint16 if cfg.out_depth > 8 else np.uint8
        fn = make_render_fn(lut, cfg, dev)
        t0 = time.perf_counter()
        for _ in render_batches(iter(bats), fn, dev):
            pass
        cold = st.frames / (time.perf_counter() - t0)
        torch.cuda.reset_peak_memory_stats(dev)
        saved = start_path()
        rs_before = resample.launches
        first, n_out = None, 0
        t0 = time.perf_counter()
        for o in render_batches(iter(bats), fn, dev):
            if [p.shape[1:] for p in o[:3]] != shapes \
                    or any(p.dtype != dtype for p in o[:3]):
                fail(f"{st.name}: output {[p.shape for p in o[:3]]} "
                     f"{o[0].dtype}, expected {shapes} {dtype.__name__}")
            if first is None:
                # held, not copied: its pinned buffers stay out of reuse
                first = o[:3]
            n_out += o[3]
        wall = time.perf_counter() - t0
        counts = end_path(saved)
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        want_b = len(bats) if lut is not None else 0
        if counts != {"A": 0, "C": 0, "B": want_b, "B coarse2": 0}:
            fail(f"{st.name}: launches {counts}, expected B={want_b}")
        if n_out != st.frames:
            fail(f"{st.name}: returned {n_out} of {st.frames} frames")
        # the plain version: kernel B's plain twin on the card, or with no
        # LUT (the plain layout's torch ops only) the same function on the
        # CPU
        if lut is not None:
            want = fused420.render_fused420_reference(
                *(torch.from_numpy(p).to(dev) for p in bats[0][:3]),
                lut_operands_for(lut, cfg, dev), cfg)
        else:
            want = make_render_fn(None, cfg, "cpu")(
                *(torch.from_numpy(p) for p in bats[0][:3]))
        d = code_diff([torch.from_numpy(p) for p in first],
                      [x.cpu() for x in want], f"{st.name} first batch")
        # one batch's split (CUDA events): H2D from pinned memory, the
        # render function, D2H into pinned memory
        host = [torch.from_numpy(p).pin_memory() for p in bats[-1][:3]]
        h2d = time_ms(lambda: [x.to(dev, non_blocking=True) for x in host], 10)
        dev_in = [x.to(dev) for x in host]
        render_ms = time_ms(lambda: fn(*dev_in), 10)
        outs = fn(*dev_in)
        pinned = [torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                  for o in outs]
        d2h = time_ms(lambda: [p.copy_(o, non_blocking=True)
                               for p, o in zip(pinned, outs)], 10)
        b = len(bats[0][0])
        rec = dict(config=st.name,
                   source=f"{w}x{h} {st.info.pix_fmt}",
                   output=f"{st.spec.pix_fmt} ({st.spec.video_codec})",
                   lut=f"{st.lut_size}^3 {cfg.interp}" if lut is not None
                   else None,
                   dither=cfg.dither,
                   range="full -> limited" if cfg.in_full_range
                   and not cfg.out_full_range else "limited",
                   frames=st.frames, batch=b, fps=st.frames / wall,
                   cold_fps=cold, h2d_ms=h2d, render_ms=render_ms,
                   d2h_ms=d2h, kernel_b_launches=counts["B"],
                   peak_device_gb=peak_gb, max_abs_diff=d)
        print(f"phase 9 {st.name}: {st.frames} frames {rec['source']} -> "
              f"{rec['output']}, {rec['lut'] or 'no LUT'}, dither "
              f"{cfg.dither}, in batches of {b}: {rec['fps']:.2f} fps end to "
              f"end (cold pass {cold:.2f}); per batch H2D {h2d:.3f} ms, "
              f"render {render_ms:.3f} ms, D2H {d2h:.3f} ms; kernel B "
              f"launches {counts['B']}; peak device memory {peak_gb:.2f} "
              f"GB; first batch vs plain max|d|={d}; card {card}",
              flush=True)
        del dev_in, outs, pinned, host, want
        return rec

    baseline = baseline_stages()
    # a stage's output that a later stage takes as its source (the pro
    # master), by path
    kept = {}
    configs = []
    for st in baseline:
        lut = (random_lut(st.lut_size, SEED + 90 + st.lut_size)
               if st.lut_size else None)
        b = _pick_batch_size(st.info.width, st.info.height)
        if st.spec.source in kept:
            bats = batches_of(kept.pop(st.spec.source), b)
        else:
            bats = batches_of(device_frames(
                SEED + 90 + len(configs), st.frames, st.info.height,
                st.info.width, st.cfg.in_depth, st.cfg.in_subsampling, dev), b)
        configs.append(baseline_run(st, bats, lut))
        if any(s.spec.source == st.spec.output for s in baseline):
            # the frames the next stage decodes, kept on the host
            outs = [[p.copy() for p in o[:3]] for o in render_batches(
                iter(bats), make_render_fn(lut, st.cfg, dev), dev)]
            kept[st.spec.output] = [np.concatenate([o[k] for o in outs])
                                    for k in range(3)]
            del outs
        if st.info.width == 7680:
            # the split over two streams of card 0, in lockstep with the
            # single run: at the executor's batch (one frame: a one-frame
            # chunk and an empty one) and at run_stage's batch for two
            # devices (2: a frame a chunk)
            split8k = {}
            for sb in (b, 2):
                sbats = bats if sb == b else batches_of(
                    [np.concatenate([x[k] for x in bats]) for k in range(3)],
                    sb)
                single = make_render_fn(lut, st.cfg, dev)
                sharded = make_sharded_render_fn(lut, st.cfg,
                                                 ["cuda:0", "cuda:0"])
                saved = start_path()
                for whole, part in zip(
                        render_batches(iter(sbats), single, dev),
                        render_batches(iter(sbats), sharded, dev)):
                    if not all(np.array_equal(a, e)
                               for a, e in zip(part[:3], whole[:3])):
                        fail(f"{st.name}: split at batch {sb} not "
                             f"bit-equal to the single run")
                counts = end_path(saved)
                chunks = sum(min(2, len(x[0])) for x in sbats)
                if counts["B"] != len(sbats) + chunks:
                    fail(f"{st.name}: split at batch {sb} launches {counts}, "
                         f"expected B={len(sbats) + chunks}")
                split8k[f"batch {sb}"] = dict(bit_equal=True, chunks=chunks)
            configs[-1]["split_cuda0_cuda0"] = split8k
            print(f"phase 9 {st.name} split over ['cuda:0', 'cuda:0'], "
                  f"in lockstep with the single run: bit-equal at batch {b} "
                  f"({split8k[f'batch {b}']['chunks']} one-frame chunks, the "
                  f"empty ones skipped) and at batch 2 "
                  f"({split8k['batch 2']['chunks']} chunks)", flush=True)
        del bats
    mark(None)

    # every kernel at the main paths' shape: a batch of 2 4K frames
    px = bsz * 2160 * 3840
    io_bytes = {"A": 24 * px, "C": 24 * px,  # 3 f32 planes in, 3 out
                "B": 3 * px, "B coarse2": 3 * px}  # 420p8 in and out
    meta = {
        "A": ("lut3d (kernel A)", "lut3d.cu",
              "lut_renderer_tpu/ops/lut3d.py:699", launches["A"]),
        "B": ("fused420 (kernel B, exact table)", "fused420.cu",
              "lut_renderer_tpu/ops/fused420.py:280", launches["B"]),
        "B coarse2": ("fused420 (kernel B, coarse2 table)",
                      "fused420_coarse2.cu",
                      "lut_renderer_tpu/ops/fused420.py:280",
                      big_launches["B coarse2"]),
        "C": ("coarse2 (kernel C)", "coarse2.cu",
              "lut_renderer_tpu/ops/lut3d.py:771", big_launches["C"]),
    }
    kernels = []
    for key, (name, src, replaces, n_launch) in meta.items():
        r = report[key]
        bound_ms, bound_by = bound(io_bytes[key] + r["table"],
                                   FLOPS_PER_PX[key] * px)
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"lut_renderer_tpu_torch/csrc/{src}",
            "replaces": replaces, "launches": n_launch,
            "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": r.get("library_ms"),
            "uniform_ms": r["uniform_ms"], "share": bound_ms / r["ms"]})
    kernels[0].update(library_case="trilinear, uniform planes, torch "
                                   "grid_sample",
                      trilinear_ms=report["A"]["trilinear_ms"],
                      stages_ms=ac_stages["A 33^3"])
    kernels[0]["resize_path_launches"] = {k: v["launches"]
                                          for k, v in resize.items()}
    kernels[1]["stages_ms"] = stages
    # phase 9: every BASELINE configuration's stage through the device loop
    kernels[1]["baseline_configs"] = configs
    kernels[3]["stages_ms"] = ac_stages["C 129^3 coarse2f"]
    # the banded resample at phase 6's two resize shapes (4K -> 1080p x 2
    # first); its plain version is the same taps in plain PyTorch
    rs_paths = {k: resize[k] for k in ("4K->1080p", "1080p->4K")}
    rs_main = rs_paths["4K->1080p"]
    kernels.append({
        "name": "resample (banded)", "route": "cuda",
        "source": "lut_renderer_tpu_torch/csrc/resample.cu",
        "replaces": "none: lut_renderer_tpu/ops/resample.py resample_plane's "
                    "two einsums, outside any Pallas kernel",
        "launches": sum(v["resample_launches"] for v in resize.values()),
        "max_abs_err": 0.0, "ms": rs_main["resample_ms"],
        "plain_ms": rs_main["resample_plain_ms"],
        "bound_ms": rs_main["resample_bound_ms"],
        "bound_by": rs_main["resample_bound_by"],
        "library_ms": rs_main["resample_library_ms"],
        "library_case": "the dense torch.matmul pair a frame and plane, IEEE "
                        "f32 (resample_plane_dense)",
        "share": rs_main["resample_share"],
        "resize_paths": {k: {f: v[f] for f in (
            "batch", "resample_ms", "resample_plain_ms",
            "resample_library_ms", "resample_bound_ms", "resample_share")}
            for k, v in rs_paths.items()}})
    print(json.dumps({"main_path_fps": fps, "cold_pass_fps": cold_fps,
                      "frames": n_frames,
                      "batch": bsz, "h2d_ms": h2d_ms, "d2h_ms": d2h_ms,
                      "big_cube_fps": big_fps, "big_cube_cold_fps": big_cold,
                      "big_cube_frames": n_big,
                      "kernel_c_vs_a_ms": c_times,
                      "kernel_b_coarse2_vs_exact_ms": b2_times,
                      "table_build_ms": build_ms, "resize_paths": resize,
                      "resample_precision": precision, "split": split,
                      "phase_seconds": phase_s}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

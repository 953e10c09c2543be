"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from lut_renderer_tpu_torch/csrc,
holds each against its plain PyTorch version on the card, drives the
port's main render path at the headline size (4K 8-bit 4:2:0 frames, a 33^3
tetrahedral LUT) and its big-cube path (a 129^3 LUT at the coarse2f tier),
and, where hostio's FFmpeg libraries load, renders a clip file to file
through the port's CLI. Phases:

  1. card and build      nvidia-smi name/power limit, versions, build time
  2. kernel A            LUT on planar RGB vs plain: 4K x 5 interps at 33^3,
                         1080p at 65^3 and 129^3; <= 1e-5 absolute; the
                         trilinear case beside torch's grid_sample
  2C. kernel C           coarse + residual LUT vs plain: 4K x 2 at 65^3,
                         97^3, 129^3 x coarse2f/coarse2/coarse2x, 5 interps
                         at 129^3, coarse2f_tri; <= 1e-5 absolute; times
                         beside kernel A's exact table at each N
  3. kernel B            whole-frame YUV->YUV vs plain: 4K 420p8 and the
                         geometry/depth/range/dither matrix, exact and
                         coarse2f tables; max |d| <= 1 code value on fewer
                         than 1e-3 of pixels
  4. main path           the executor's device loop over 48 seeded 4K
                         frames; kernel launch counts, fps end to end
  4C. big-cube path      the same loop over 16 4K frames at 129^3
                         coarse2f (kernel B's coarse2 instantiation), and
                         an error-diffusion job through kernel C
  5. file to file        CLI render --device cuda vs --device cpu

Any failure raises and exits non-zero. The one thing caught is hostio's
own report that this machine has no FFmpeg libraries (no cv2, or
FFIUnavailable), which skips phase 5 and says why. Without a CUDA device it
exits non-zero before printing any result. The last line is
{"ok": true, "device": {...}}; the line before it holds the kernels' JSON
(each kernel's time, plain time, least possible time and launches on its
path) and the one before that the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from dataclasses import replace
from pathlib import Path

import numpy as np

SEED = 20260
TETRA = "tetrahedral"
INTERPS = ("nearest", "trilinear", "tetrahedral", "pyramid", "prism")
LUT_ATOL = 1e-5
MAX_CODE_DIFF, MAX_DIFF_RATE = 1, 1e-3
COARSE2 = ("coarse2f", "coarse2", "coarse2x")
# float code values out of the plain layout: the LUT's 1e-5 through the
# output matrix and the code-value scale (255 at 8 bits)
ED_ATOL = 0.01
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


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


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


def random_lut(n: int, seed: int):
    from lut_renderer_tpu_torch.colorcore import Lut3D

    rng = np.random.default_rng(seed)
    lut = Lut3D.identity(n)
    table = np.clip(lut.table + rng.uniform(-0.06, 0.06, lut.table.shape)
                    .astype(np.float32), 0, 1).astype(np.float32)
    return Lut3D(table=table, title=f"smoke{n}")


def time_ms(fn, iters: int, warmup: int = 2, reps: int = 3) -> float:
    """Milliseconds per call of fn() on the card: CUDA events around
    `iters` back-to-back calls, the median of `reps` such runs."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        per_call.append(a.elapsed_time(b) / iters)
    return statistics.median(per_call)


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


def yuv_frames(seed: int, b: int, h: int, w: int, depth: int = 8,
               in_sub: str = "420"):
    """Seeded frames: smooth ramps that move per frame, plus noise."""
    rng = np.random.default_rng(seed)
    hi = (1 << depth) - 1
    dt = np.uint16 if depth > 8 else np.uint8
    hc = h // 2 if in_sub == "420" else h
    wc = w // 2 if in_sub in ("420", "422") else w

    def plane(hh, ww, fx, fy, i):
        ramp = (np.linspace(0, fx, ww, dtype=np.float32)[None, :]
                + np.linspace(0, fy, hh, dtype=np.float32)[:, None])
        noise = rng.integers(0, 8, (hh, ww)).astype(np.float32)
        return np.clip((ramp + 0.03 * i) % 1.0 * hi + noise, 0, hi).astype(dt)

    ys = np.stack([plane(h, w, 0.7, 0.3, i) for i in range(b)])
    us = np.stack([plane(hc, wc, 0.2, 0.6, i + 5) for i in range(b)])
    vs = np.stack([plane(hc, wc, 0.5, 0.1, i + 9) for i in range(b)])
    return ys, us, vs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch sees no CUDA device; this script runs on the card only")
    if len(sys.argv) > 1:
        fail(f"takes no arguments, got {sys.argv[1:]}")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from lut_renderer_tpu_torch.engine.executor import (
        _pick_batch_size,
        render_batches,
    )
    from lut_renderer_tpu_torch.ops import _build, fused420, lut3d
    from lut_renderer_tpu_torch.ops.prepare import Coarse2Table, LutTable
    from lut_renderer_tpu_torch.ops.pixel import render_planes
    from lut_renderer_tpu_torch.ops.render import RenderConfig, make_render_fn

    # ---- 1. card and build ------------------------------------------------
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
    def lut_check(n, h, w, interps, seed):
        table = LutTable.from_lut3d(random_lut(n, seed), dev)
        g = torch.Generator(device=dev).manual_seed(seed)
        rgb = [torch.rand((h, w), generator=g, device=dev) * 1.1 - 0.05
               for _ in range(3)]
        worst = 0.0
        for interp in interps:
            got = lut3d.apply_lut_planes(*rgb, table, interp)
            want = lut3d.apply_lut_planes_reference(*rgb, table, interp)
            torch.cuda.synchronize()
            err = max(float((a - e).abs().max()) for a, e in zip(got, want))
            if not err <= LUT_ATOL:
                fail(f"kernel A {n}^3 {interp} {w}x{h}: max|d|={err}")
            worst = max(worst, err)
        return table, rgb, worst

    # the main path's batch: 2 frames of 3840x2160 (executor batch rule)
    bsz = _pick_batch_size(3840, 2160)
    table33, rgb4k, err_a = lut_check(33, 2160, 3840, INTERPS, SEED)
    for n in (65, 129):
        _, _, e = lut_check(n, 1080, 1920, (TETRA,), SEED + n)
        err_a = max(err_a, e)
    rgb_b = [torch.stack([c] * bsz) for c in rgb4k]  # (bsz, 2160, 3840)
    a_ms = time_ms(lambda: lut3d.apply_lut_planes(*rgb_b, table33, TETRA), 20)
    a_plain = time_ms(
        lambda: lut3d.apply_lut_planes_reference(*rgb_b, table33, TETRA), 3)
    # the library yardstick of the trilinear case: grid_sample on the
    # (1, 3, N, N, N) table, grid (x, y, z) = (b, g, r) in [-1, 1]
    tab_t = table33.table[..., :3].permute(3, 0, 1, 2)[None].contiguous()
    grid = torch.stack([c.clamp(0, 1).reshape(-1) * 2 - 1
                        for c in reversed(rgb_b)], -1).view(1, 1, 1, -1, 3)

    def library():
        return torch.nn.functional.grid_sample(
            tab_t, grid, mode="bilinear", padding_mode="border",
            align_corners=True)

    tri = lut3d.apply_lut_planes(*rgb_b, table33, "trilinear")
    lib_err = float((library()[0, :, 0, 0].reshape(3, *rgb_b[0].shape)
                     - torch.stack(tri)).abs().max())
    a_tri = time_ms(lambda: lut3d.apply_lut_planes(*rgb_b, table33,
                                                   "trilinear"), 20)
    lib_ms = time_ms(library, 20)
    print(f"phase 2 kernel A: 5 interps at 4K 33^3 + 1080p 65^3/129^3 "
          f"tetrahedral, max|d|={err_a:.3g} (<= {LUT_ATOL}); "
          f"{bsz}x3840x2160 tetrahedral: kernel {a_ms:.3f} ms, "
          f"plain {a_plain:.3f} ms; trilinear: kernel {a_tri:.3f} ms, "
          f"torch grid_sample {lib_ms:.3f} ms (max|d| {lib_err:.3g} vs "
          f"kernel)", flush=True)
    report["A"] = dict(err=err_a, ms=a_ms, plain_ms=a_plain, library_ms=lib_ms,
                       trilinear_ms=a_tri, library_err=lib_err,
                       table=table_bytes(table33))
    del tri, grid, tab_t

    # ---- 2C. kernel C vs its plain version --------------------------------
    def coarse2_check(n, tier, interps, seed, rgb):
        exact = LutTable.from_lut3d(random_lut(n, seed), dev)
        table = Coarse2Table.from_lut_table(exact, tier)
        worst = 0.0
        for interp in interps:
            got = lut3d.apply_lut_planes(*rgb, table, interp)
            want = lut3d.apply_lut_planes_coarse2_reference(*rgb, table,
                                                            interp)
            torch.cuda.synchronize()
            err = max(float((a - e).abs().max()) for a, e in zip(got, want))
            if not err <= LUT_ATOL:
                fail(f"kernel C {n}^3 {tier} {interp}: max|d|={err}")
            worst = max(worst, err)
        return exact, table, worst

    err_c, c_times = 0.0, {}
    for n in (65, 97, 129):
        for tier in COARSE2:
            interps = INTERPS if (n, tier) == (129, BIG) else (TETRA,)
            exact, table, e = coarse2_check(n, tier, interps, SEED + n, rgb_b)
            err_c = max(err_c, e)
            if tier != BIG:
                continue
            # kernel A on the exact table and kernel C on the same inputs,
            # in turns (A, C, C, A)
            run_a = lambda: lut3d.apply_lut_planes(*rgb_b, exact, TETRA)  # noqa: E731
            run_c = lambda: lut3d.apply_lut_planes(*rgb_b, table, TETRA)  # noqa: E731
            t = [time_ms(f, 20) for f in (run_a, run_c, run_c, run_a)]
            c_times[n] = dict(A_ms=(t[0] + t[3]) / 2, C_ms=(t[1] + t[2]) / 2,
                              A_table=table_bytes(exact),
                              C_table=table_bytes(table))
    _, table_tri, e = coarse2_check(129, "coarse2f_tri", (TETRA,), SEED + 129,
                                    rgb_b)
    err_c = max(err_c, e)
    big_c = Coarse2Table.from_lut_table(
        LutTable.from_lut3d(random_lut(129, SEED + 129), dev), BIG)
    c_plain = time_ms(lambda: lut3d.apply_lut_planes_coarse2_reference(
        *rgb_b, big_c, TETRA), 2, warmup=1)
    print(f"phase 2C kernel C: 4K x {bsz} at 65^3/97^3/129^3 x "
          f"{'/'.join(COARSE2)} tetrahedral, 5 interps at 129^3 {BIG}, "
          f"coarse2f_tri; max|d|={err_c:.3g} (<= {LUT_ATOL}); "
          f"{bsz}x3840x2160 tetrahedral {BIG}: " + ", ".join(
              f"{n}^3 kernel C {v['C_ms']:.3f} ms vs kernel A exact "
              f"{v['A_ms']:.3f} ms" for n, v in c_times.items())
          + f"; plain at 129^3 {c_plain:.3f} ms", flush=True)
    report["C"] = dict(err=err_c, ms=c_times[129]["C_ms"], plain_ms=c_plain,
                       table=c_times[129]["C_table"])
    del table_tri, big_c

    # ---- 3. kernel B vs its plain version ---------------------------------
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

    main_cfg = RenderConfig()
    worst_b, planes4k, tab = fused_check(main_cfg, bsz, 2160, 3840, lut33,
                                         SEED + 1, "4K 420p8")
    cases = {
        "422p10->422p10": (dict(in_depth=10, out_depth=10,
                                in_subsampling="422", out_subsampling="422"),
                           (1, 1080, 1920), lut33),
        "422p10->420p8 ordered": (dict(in_depth=10, in_subsampling="422",
                                       dither="ordered"),
                                  (1, 1080, 1920), lut33),
        "full-range 420 requantise": (dict(in_full_range=True),
                                      (1, 1080, 1920), lut33),
        "random dither": (dict(dither="random"), (1, 1080, 1920), lut33),
        "444->444 odd width": (dict(in_subsampling="444",
                                    out_subsampling="444", dither="ordered"),
                               (1, 360, 641), lut33),
        "1080p 65^3": (dict(), (1, 1080, 1920), random_lut(65, SEED + 65)),
        "1080p 129^3": (dict(), (1, 1080, 1920), random_lut(129, SEED + 129)),
    }
    for i, (what, (kw, (b, h, w), lut)) in enumerate(cases.items()):
        d, _, _ = fused_check(replace(main_cfg, **kw), b, h, w, lut,
                              SEED + 10 + i, what)
        worst_b = max(worst_b, d)
    b_ms = time_ms(lambda: fused420.render_fused420(*planes4k, tab, main_cfg),
                   20)
    b_plain = time_ms(
        lambda: fused420.render_fused420_reference(*planes4k, tab, main_cfg), 3)
    print(f"phase 3 kernel B: 4K 420p8 + {len(cases)} cases, "
          f"max|d|={worst_b} code value(s) (contract <= 1 on < 1e-3 of px); "
          f"{bsz}x3840x2160 420p8 tetrahedral: kernel {b_ms:.3f} ms, "
          f"plain {b_plain:.3f} ms", flush=True)
    report["B"] = dict(err=worst_b, ms=b_ms, plain_ms=b_plain,
                       table=table_bytes(tab))

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
        run_x = lambda: fused420.render_fused420(*planes, tab_x, main_cfg)  # noqa: E731
        run_2 = lambda: fused420.render_fused420(*planes, tab2, big_cfg)  # noqa: E731
        t = [time_ms(f, 20) for f in (run_x, run_2, run_2, run_x)]
        b2_times[n] = dict(B_ms=(t[0] + t[3]) / 2, B_coarse2_ms=(t[1] + t[2]) / 2)
        if n == 129:
            b2_plain = time_ms(lambda: fused420.render_fused420_reference(
                *planes, tab2, big_cfg), 2, warmup=1)
            report["B coarse2"] = dict(ms=b2_times[n]["B_coarse2_ms"],
                                       plain_ms=b2_plain,
                                       table=table_bytes(tab2))
    d, _, _ = fused_check(replace(big_cfg, in_depth=10, out_depth=10,
                                  in_subsampling="422",
                                  out_subsampling="422", dither="random"),
                          1, 1080, 1920, random_lut(129, SEED + 329),
                          SEED + 30, "422p10 129^3 coarse2x", tier="coarse2x")
    worst_b2 = max(worst_b2, d)
    report["B coarse2"]["err"] = worst_b2
    print(f"phase 3 kernel B coarse2: 4K 420p8 at 65^3 and 129^3 {BIG} + "
          f"1080p 422p10 129^3 coarse2x random dither, max|d|={worst_b2} "
          f"code value(s); {bsz}x3840x2160 420p8 tetrahedral: " + ", ".join(
              f"{n}^3 coarse2 {v['B_coarse2_ms']:.3f} ms vs exact "
              f"{v['B_ms']:.3f} ms" for n, v in b2_times.items())
          + f"; plain at 129^3 {b2_plain:.3f} ms", flush=True)
    del planes4k, rgb4k, rgb_b, planes

    # ---- 4. main path -----------------------------------------------------
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
              (lut3d, "apply_lut_planes_coarse2_reference"))
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

    # every kernel at the main paths' shape: a batch of 2 4K frames
    px = bsz * 2160 * 3840
    io_bytes = {"A": 24 * px, "C": 24 * px,  # 3 f32 planes in, 3 out
                "B": 3 * px, "B coarse2": 3 * px}  # 420p8 in and out
    meta = {
        "A": ("lut3d (kernel A)", "lut3d.cu",
              "lut_renderer_tpu/ops/lut3d.py:699", launches["A"]),
        "B": ("fused420 (kernel B, exact table)", "fused420.cu",
              "lut_renderer_tpu/ops/fused420.py:280", launches["B"]),
        "B coarse2": ("fused420 (kernel B, coarse2 table)", "fused420.cu",
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
            "library_ms": r.get("library_ms")})
    kernels[0].update(library_case="trilinear, torch grid_sample",
                      trilinear_ms=report["A"]["trilinear_ms"])
    print(json.dumps({"main_path_fps": fps, "cold_pass_fps": cold_fps,
                      "frames": n_frames,
                      "batch": bsz, "h2d_ms": h2d_ms, "d2h_ms": d2h_ms,
                      "big_cube_fps": big_fps, "big_cube_cold_fps": big_cold,
                      "big_cube_frames": n_big,
                      "kernel_c_vs_a_ms": c_times,
                      "kernel_b_coarse2_vs_exact_ms": b2_times}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

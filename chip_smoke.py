"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from lut_renderer_tpu_torch/csrc,
holds each against its plain PyTorch version on the card, drives the
port's main render path at the headline size (4K 8-bit 4:2:0 frames, a 33^3
tetrahedral LUT), and, where hostio's FFmpeg libraries load, renders a clip
file to file through the port's CLI. Phases:

  1. card and build      nvidia-smi name/power limit, versions, build time
  2. kernel A            LUT on planar RGB vs plain: 4K x 5 interps at 33^3,
                         1080p at 65^3 and 129^3; <= 1e-5 absolute
  3. kernel B            whole-frame YUV->YUV vs plain: 4K 420p8 and the
                         geometry/depth/range/dither matrix; max |d| <= 1
                         code value on fewer than 1e-3 of pixels
  4. main path           the executor's device loop over 48 seeded 4K
                         frames; kernel launch counts, fps end to end
  5. file to file        CLI render --device cuda vs --device cpu

Any failure raises and exits non-zero; nothing is caught. Without a CUDA
device it exits non-zero before printing any result. The last line is
{"ok": true, "device": {...}}; the line before it holds the kernels' JSON
and the one before that the card's name and power limit.
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


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def random_lut(n: int, seed: int):
    from lut_renderer_tpu.colorcore import Lut3D

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
    from lut_renderer_tpu_torch.ops.prepare import LutTable
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
    print(f"phase 2 kernel A: 5 interps at 4K 33^3 + 1080p 65^3/129^3 "
          f"tetrahedral, max|d|={err_a:.3g} (<= {LUT_ATOL}); "
          f"{bsz}x3840x2160 tetrahedral: kernel {a_ms:.3f} ms, "
          f"plain {a_plain:.3f} ms", flush=True)
    report["A"] = dict(err=err_a, ms=a_ms, plain_ms=a_plain)

    # ---- 3. kernel B vs its plain version ---------------------------------
    lut33 = random_lut(33, SEED)

    def fused_check(cfg, b, h, w, lut, seed, what):
        table = LutTable.from_lut3d(lut, dev)
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
    report["B"] = dict(err=worst_b, ms=b_ms, plain_ms=b_plain)
    del planes4k, rgb4k, rgb_b

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

    saved = (fused420.render_fused420_reference,
             lut3d.apply_lut_planes_reference)
    fused420.render_fused420_reference = no_plain
    lut3d.apply_lut_planes_reference = no_plain
    fused420.launches = 0
    lut3d.launches = 0
    torch.cuda.synchronize()
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
    launches = {"B": fused420.launches, "A": lut3d.launches}
    (fused420.render_fused420_reference,
     lut3d.apply_lut_planes_reference) = saved

    if launches["B"] != len(batches) or launches["A"] != len(ed_batches):
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

    # ---- 5. file to file --------------------------------------------------
    try:
        import cv2  # noqa: F401
        from lut_renderer_tpu.hostio.ffi import get_ffi

        get_ffi()
        probe = None
    except Exception as exc:  # the probe: any failure means no hostio here
        probe = f"{type(exc).__name__}: {exc}"
    if probe is not None:
        print(f"phase 5 file to file: skipped, hostio cannot load its "
              f"FFmpeg libraries ({probe[:160]})", flush=True)
    else:
        from lut_renderer_tpu.colorcore import write_cube_file
        from lut_renderer_tpu.hostio.decode import VideoDecoder
        from lut_renderer_tpu.utils.fixtures import make_gradient_clip
        from lut_renderer_tpu_torch.app import cli

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

    kernels = [
        {"name": "lut3d (kernel A)", "route": "cuda",
         "source": "lut_renderer_tpu_torch/csrc/lut3d.cu",
         "replaces": "lut_renderer_tpu/ops/lut3d.py:699",
         "launches": launches["A"], "max_abs_err": report["A"]["err"],
         "ms": report["A"]["ms"], "plain_ms": report["A"]["plain_ms"]},
        {"name": "fused420 (kernel B)", "route": "cuda",
         "source": "lut_renderer_tpu_torch/csrc/fused420.cu",
         "replaces": "lut_renderer_tpu/ops/fused420.py:280",
         "launches": launches["B"], "max_abs_err": report["B"]["err"],
         "ms": report["B"]["ms"], "plain_ms": report["B"]["plain_ms"]},
    ]
    print(json.dumps({"main_path_fps": fps, "cold_pass_fps": cold_fps,
                      "frames": n_frames,
                      "batch": bsz, "h2d_ms": h2d_ms, "d2h_ms": d2h_ms}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

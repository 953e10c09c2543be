"""Seeded inputs, the CUDA-event timer, the card's name and the stage
builds' library shared by ``chip_smoke.py`` and the kernel probes."""

from __future__ import annotations

import functools
import statistics
import subprocess

import numpy as np
import torch

from ..colorcore import Lut3D
from ..ops import _build
from ..ops.pixel import render_planes

SEED = 20260

# the stage builds of kernels A and C (planar_probe.cu) and of kernel B
# (fused420_probe.cu): the production kernels' own code stopped after a
# stage, in a library apart from the render library
PROBE_SOURCES = ("planar_probe.cu", "fused420_probe.cu")
PROBE_ENTRY_POINTS = ("lut3d_io_launch", "lut3d_weights_launch",
                      "coarse2_io_launch", "coarse2_weights_launch",
                      "coarse2_coarse_launch", "coarse2_resid_launch",
                      "fused420_io_launch", "fused420_color_launch")

# kernel B's case matrix (chip_smoke phase 3): RenderConfig overrides,
# (batch, height, width), the LUT's (size, seed offset from SEED), and the
# planes' seed offset
KERNEL_B_CASES = {
    "422p10->422p10": (dict(in_depth=10, out_depth=10, in_subsampling="422",
                            out_subsampling="422"),
                       (1, 1080, 1920), (33, 0), 10),
    "422p10->420p8 ordered": (dict(in_depth=10, in_subsampling="422",
                                   dither="ordered"),
                              (1, 1080, 1920), (33, 0), 11),
    "full-range 420 requantise": (dict(in_full_range=True),
                                  (1, 1080, 1920), (33, 0), 12),
    "random dither": (dict(dither="random"), (1, 1080, 1920), (33, 0), 13),
    "444->444 odd width": (dict(in_subsampling="444", out_subsampling="444",
                                dither="ordered"),
                           (1, 360, 641), (33, 0), 14),
    "1080p 65^3": (dict(), (1, 1080, 1920), (65, 65), 15),
    "1080p 129^3": (dict(), (1, 1080, 1920), (129, 129), 16),
}


def random_lut(n: int, seed: int) -> Lut3D:
    """Identity plus a seeded perturbation of +-0.06, clipped to [0, 1]."""
    rng = np.random.default_rng(seed)
    lut = Lut3D.identity(n)
    table = np.clip(lut.table + rng.uniform(-0.06, 0.06, lut.table.shape)
                    .astype(np.float32), 0, 1).astype(np.float32)
    return Lut3D(table=table, title=f"smoke{n}")


def _chroma_shape(h: int, w: int, in_sub: str):
    return (h // 2 if in_sub == "420" else h,
            w // 2 if in_sub in ("420", "422") else w)


def yuv_frames(seed: int, b: int, h: int, w: int, depth: int = 8,
               in_sub: str = "420"):
    """Seeded frames: smooth ramps that move per frame, plus noise."""
    rng = np.random.default_rng(seed)
    hi = (1 << depth) - 1
    dt = np.uint16 if depth > 8 else np.uint8
    hc, wc = _chroma_shape(h, w, in_sub)

    def plane(hh, ww, fx, fy, i):
        ramp = (np.linspace(0, fx, ww, dtype=np.float32)[None, :]
                + np.linspace(0, fy, hh, dtype=np.float32)[:, None])
        noise = rng.integers(0, 8, (hh, ww)).astype(np.float32)
        return np.clip((ramp + 0.03 * i) % 1.0 * hi + noise, 0, hi).astype(dt)

    ys = np.stack([plane(h, w, 0.7, 0.3, i) for i in range(b)])
    us = np.stack([plane(hc, wc, 0.2, 0.6, i + 5) for i in range(b)])
    vs = np.stack([plane(hc, wc, 0.5, 0.1, i + 9) for i in range(b)])
    return ys, us, vs


def device_frames(seed: int, b: int, h: int, w: int, depth: int, in_sub: str,
                  dev):
    """yuv_frames' kind of frames (moving ramps plus noise), made on `dev`
    from a torch generator and returned as host numpy planes: at 4K and 8K
    NumPy's generation would take longer than the runs it feeds."""
    g = torch.Generator(device=dev).manual_seed(seed)
    hi = (1 << depth) - 1
    dt = torch.int16 if depth > 8 else torch.uint8
    hc, wc = _chroma_shape(h, w, in_sub)
    shift = 0.03 * torch.arange(b, device=dev, dtype=torch.float32)

    def plane(hh, ww, fx, fy, i0):
        ramp = (torch.linspace(0, fx, ww, device=dev)[None, :]
                + torch.linspace(0, fy, hh, device=dev)[:, None])
        noise = torch.randint(0, 8, (b, hh, ww), generator=g, device=dev,
                              dtype=torch.float32)
        x = (ramp + (shift + 0.03 * i0)[:, None, None]) % 1.0 * hi + noise
        out = x.clamp_(0, hi).to(dt).cpu().numpy()
        return out.view(np.uint16) if depth > 8 else out

    return plane(h, w, 0.7, 0.3, 0), plane(hc, wc, 0.2, 0.6, 5), \
        plane(hc, wc, 0.5, 0.1, 9)


def uniform_frames(seed: int, b: int, h: int, w: int, depth: int = 8,
                   in_sub: str = "420"):
    """Seeded frames of uniform-random codes: neighbouring pixels fall in
    unrelated LUT cells (the worst case for divergence and gathers)."""
    rng = np.random.default_rng(seed)
    dt = np.uint16 if depth > 8 else np.uint8
    hc, wc = _chroma_shape(h, w, in_sub)
    return tuple(rng.integers(0, 1 << depth, (b,) + shape).astype(dt)
                 for shape in ((h, w), (hc, wc), (hc, wc)))


def tie_frames(seed: int, b: int, h: int, w: int, depth: int = 8,
               in_sub: str = "420"):
    """Seeded frames whose LUT deltas tie: grey rows (chroma at mid, so r =
    g = b) with luma on multiples of 15 << (depth - 8) (on cell boundaries
    where N - 1 divides 17 under full range) and every fourth luma row
    random; on odd chroma rows saturated chroma, which clips channels to 0
    or 1."""
    rng = np.random.default_rng(seed)
    dt = np.uint16 if depth > 8 else np.uint8
    hi, mid = (1 << depth) - 1, 1 << (depth - 1)
    hc, wc = _chroma_shape(h, w, in_sub)
    y = (rng.integers(0, 18, (b, h, w)) * (15 << (depth - 8))).astype(dt)
    y[:, 1::4] = rng.integers(0, hi + 1, y[:, 1::4].shape).astype(dt)
    u = np.full((b, hc, wc), mid, dt)
    v = u.copy()
    u[:, 1::2, 0::3] = 0
    v[:, 1::2, 1::3] = hi
    u[:, 1::2, 2::3] = hi
    return y, u, v


def plain_rgb(frames, cfg, dev):
    """The float RGB planes that the plain layout hands its LUT call
    (ops/pixel.render_planes) for integer (y, u, v) numpy `frames`, on
    `dev`: what kernels A and C take on a render path."""
    y, u, v = (torch.from_numpy(p).to(dev) for p in frames)
    seen = []

    def capture(r, g, b):
        seen.append(tuple(t.contiguous() for t in (r, g, b)))
        return r, g, b

    render_planes(y, u, v, cfg, capture)
    return seen[0]


def uniform_rgb(seed: int, shape, dev):
    """Seeded float planes uniform in [-0.05, 1.05): every LUT cell equally
    likely and neighbouring pixels in unrelated cells (the worst case for
    the gathers), with a margin that the clip takes."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.rand(shape, generator=g, device=dev) * 1.1 - 0.05
                 for _ in range(3))


@functools.cache
def probe_library():
    """The stage builds' library (PROBE_SOURCES of this package's csrc/),
    built on first call; the card only."""
    return _build.build_library(_build.CSRC, PROBE_SOURCES,
                                PROBE_ENTRY_POINTS, headers=_build.HEADERS,
                                name="liblut_probes")


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2, reps: int = 3,
            graph: bool = False) -> float:
    """Milliseconds per call of fn() on the card: CUDA events around
    `iters` back-to-back calls, the median of `reps` such runs.

    ``graph``: the `iters` calls are captured once into a CUDA graph and
    the replays are timed, so that the host's launch work (which can
    exceed a short kernel's time and leave the card idle between
    launches) stays out of the number. For kernels whose launches are
    prepared once (kernel_b.prepared_launch, kernel_ac.prepared_launch)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    run = fn
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(iters):
                fn()
        run, iters_per_run = g.replay, iters
        g.replay()
        torch.cuda.synchronize()
    else:
        iters_per_run = 1
    per_call = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters // iters_per_run):
            run()
        b.record()
        b.synchronize()
        per_call.append(a.elapsed_time(b) / iters)
    return statistics.median(per_call)

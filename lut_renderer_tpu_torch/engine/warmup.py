"""Warm start of a serving process: build the kernels and run each once.

The port's counterpart of lut_renderer_tpu/engine/warmup.py. The JAX
package precompiles a ladder of per-shape programs into a persistent
cache; CUDA kernels take runtime shapes, so the port has no per-shape
compile to warm (its 29-program ladder and compile cache are not ported).
What a first job would pay here is the kernel build (nvcc, at first use)
and each path's first launch. ``warmup_kernels`` pays both on a small
frame through the entry points jobs use (``make_render_fn``): kernel B,
kernel A, kernel C and one resample, on the serving device.

Driven by the CLI's `serve --warmup`, `serve --warmup-background` and
`doctor --warmup`.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional

import torch

from ..colorcore import Lut3D
from ..device import DeviceLike, resolve_device
from ..ops.prepare import LutTable
from ..ops.render import RenderConfig, make_render_fn

# (label, config, LUT size) of each warm run: the paths a job can take
WARM_RUNS = (
    ("kernel B, 33^3", RenderConfig(), 33),
    ("kernel A, 33^3", RenderConfig(phase_layout="plain"), 33),
    ("kernel C, 49^3 coarse2f",
     RenderConfig(phase_layout="plain", lut_precision="coarse2f"), 49),
    ("kernel A + resample 64x32 -> 32x16", RenderConfig(resize=(32, 16)), 33),
)
# the small frame every run renders: one 64x32 8-bit 4:2:0 frame
_H, _W = 32, 64


def warmup_kernels(device: DeviceLike = "cuda",
                   log: Optional[Callable[[str], None]] = None) -> List[dict]:
    """Build the kernels (on a CUDA device) and run each path once on
    `device`. One record per step: label, seconds, ok (and error). A step
    that fails is recorded and the next one runs; nothing falls back."""
    log = log or (lambda m: None)
    dev = resolve_device(device)
    steps = []
    if dev.type == "cuda":
        from ..ops import _build

        steps.append(("kernel build", _build.load_library))
    y = torch.zeros((1, _H, _W), dtype=torch.uint8, device=dev)
    uv = torch.full((1, _H // 2, _W // 2), 128, dtype=torch.uint8, device=dev)
    for label, cfg, size in WARM_RUNS:
        def run(cfg=cfg, size=size):
            table = LutTable.from_lut3d(Lut3D.identity(size), dev)
            make_render_fn(table, cfg, dev)(y, uv, uv)
        steps.append((label, run))

    records = []
    for label, step in steps:
        t0 = time.perf_counter()
        try:
            step()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            rec = {"label": label, "ok": True}
        except Exception as exc:  # recorded; the caller reports it
            rec = {"label": label, "ok": False, "error": str(exc)[:200]}
        rec["seconds"] = round(time.perf_counter() - t0, 3)
        records.append(rec)
        log(f"warmup: {label} on {dev} "
            + (f"in {rec['seconds']}s" if rec["ok"]
               else f"FAILED: {rec['error']}"))
    return records

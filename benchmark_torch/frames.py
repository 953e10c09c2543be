"""Seeded inputs: frames and LUT tables.

Copied from ``lut_renderer_tpu_torch/probes/harness.py`` (``yuv_frames``,
``device_frames``, ``random_lut``), so that the benchmark's inputs stay
fixed whatever the program's probes become. ``random_lut`` returns the
bare (N, N, N, 3) table, with no program type around it.
"""

from __future__ import annotations

import numpy as np
import torch


def chroma_shape(h: int, w: int, sub: str):
    """(height, width) of a chroma plane of an (h, w) frame."""
    return (h // 2 if sub == "420" else h,
            w // 2 if sub in ("420", "422") else w)


def random_lut(n: int, seed: int) -> np.ndarray:
    """Identity plus a seeded perturbation of +-0.06, clipped to [0, 1]:
    (N, N, N, 3) float32 indexed [r, g, b]. (probes/harness.random_lut)"""
    rng = np.random.default_rng(seed)
    ramp = np.linspace(0.0, 1.0, n, dtype=np.float32)
    r, g, b = np.meshgrid(ramp, ramp, ramp, indexing="ij")
    table = np.stack([r, g, b], axis=-1).astype(np.float32)
    return np.clip(table + rng.uniform(-0.06, 0.06, table.shape)
                   .astype(np.float32), 0, 1).astype(np.float32)


def yuv_frames(seed: int, b: int, h: int, w: int, depth: int = 8,
               in_sub: str = "420"):
    """Seeded frames on the host: smooth ramps that move per frame, plus
    noise. (probes/harness.yuv_frames)"""
    rng = np.random.default_rng(seed)
    hi = (1 << depth) - 1
    dt = np.uint16 if depth > 8 else np.uint8
    hc, wc = chroma_shape(h, w, in_sub)

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
    NumPy's generation would take longer than the runs it feeds.
    (probes/harness.device_frames)"""
    g = torch.Generator(device=dev).manual_seed(seed)
    hi = (1 << depth) - 1
    dt = torch.int16 if depth > 8 else torch.uint8
    hc, wc = chroma_shape(h, w, in_sub)
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

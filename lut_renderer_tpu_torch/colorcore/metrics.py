"""Color-difference and quality metrics: CIE76 delta-E and PSNR.

Delta-E76 against FFmpeg `lut3d` output is the framework's headline correctness
metric (BASELINE.md: max dE76 < 0.5 on both interpolation modes). RGB input is
interpreted as gamma-encoded sRGB/Rec.709 display values in [0,1].
"""

from __future__ import annotations

import numpy as np

# sRGB D65 -> XYZ
_RGB2XYZ = np.array(
    [
        [0.4124564, 0.3575761, 0.1804375],
        [0.2126729, 0.7151522, 0.0721750],
        [0.0193339, 0.1191920, 0.9503041],
    ],
    dtype=np.float64,
)
_WHITE = np.array([0.95047, 1.0, 1.08883], dtype=np.float64)  # D65


def _srgb_to_linear(c: np.ndarray) -> np.ndarray:
    c = np.clip(c, 0.0, 1.0)
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def _f_lab(t: np.ndarray) -> np.ndarray:
    delta = 6.0 / 29.0
    return np.where(t > delta**3, np.cbrt(t), t / (3 * delta**2) + 4.0 / 29.0)


def rgb_to_lab(rgb: np.ndarray) -> np.ndarray:
    """Gamma-encoded RGB (..., 3) in [0,1] -> CIELAB (..., 3)."""
    lin = _srgb_to_linear(np.asarray(rgb, dtype=np.float64))
    xyz = lin @ _RGB2XYZ.T
    fxyz = _f_lab(xyz / _WHITE)
    l = 116.0 * fxyz[..., 1] - 16.0
    a = 500.0 * (fxyz[..., 0] - fxyz[..., 1])
    b = 200.0 * (fxyz[..., 1] - fxyz[..., 2])
    return np.stack([l, a, b], axis=-1)


def delta_e76(rgb_a: np.ndarray, rgb_b: np.ndarray) -> np.ndarray:
    """Per-pixel CIE76 delta-E between two gamma-encoded RGB images in [0,1]."""
    lab_a = rgb_to_lab(rgb_a)
    lab_b = rgb_to_lab(rgb_b)
    return np.sqrt(np.sum((lab_a - lab_b) ** 2, axis=-1))


def max_delta_e76(rgb_a: np.ndarray, rgb_b: np.ndarray) -> float:
    return float(np.max(delta_e76(rgb_a, rgb_b)))


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 1.0) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    mse = float(np.mean((a - b) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(peak * peak / mse)

"""Procedural app icon — the headless analog of the reference's icon module.

The reference paints an in-memory Qt icon at 7 sizes with no asset files
(src/lut_renderer/icon.py:16-29): dark rounded background, a stylized 3D
LUT-cube grid (3x3 front face + offset indigo back face + corner
connectors), and a small "LUT" label.  This module reproduces the same
motif as PNG files via Pillow/numpy — no Qt — so packaging
(`scripts/build_wheel.sh`) and any future GUI shell have the identical
asset, generated on demand (`lut-tpu icon --out DIR`).

Design parity (same proportions as icon.py:39-107): pad = size/16, corner
radius = 0.18*w, grid margin = 0.18*w, back-face offset = 0.35*cell,
stroke = size/64, colors #0b1220->#111827 gradient background, white front
grid (alpha 210), indigo #6366f1 back grid (alpha 220).
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Sequence

import numpy as np

ICON_SIZES = (16, 24, 32, 48, 64, 128, 256)

_BG_TOP = (0x0B, 0x12, 0x20)
_BG_BOTTOM = (0x11, 0x18, 0x27)
_FRONT = (255, 255, 255, 210)
_BACK = (99, 102, 241, 220)
_LABEL = (255, 255, 255, 230)


def render_icon(size: int) -> np.ndarray:
    """Render one icon frame as an (size, size, 4) uint8 RGBA array."""
    from PIL import Image, ImageDraw

    if size < 8:
        raise ValueError(f"icon size too small: {size}")
    # Draw at 4x and downsample for clean edges at small sizes (the
    # reference gets this from Qt's antialiasing render hint).
    ss = 4
    s = size * ss
    img = Image.new("RGBA", (s, s), (0, 0, 0, 0))
    # Strokes/label go on a separate layer and alpha-composite over the
    # background (ImageDraw writes raw RGBA — painting alpha-210 strokes
    # directly would punch holes in the opaque background).
    overlay = Image.new("RGBA", (s, s), (0, 0, 0, 0))
    draw = ImageDraw.Draw(overlay)

    pad = max(1, size // 16) * ss
    left, top = pad, pad
    right, bottom = s - pad, s - pad
    w = right - left
    radius = w * 0.18

    # Rounded-rect mask for the gradient background.
    mask = Image.new("L", (s, s), 0)
    ImageDraw.Draw(mask).rounded_rectangle(
        (left, top, right, bottom), radius=radius, fill=255)
    yy, xx = np.mgrid[0:s, 0:s].astype(np.float32)
    t = np.clip((xx + yy - (left + top)) / (2.0 * max(w, 1)), 0.0, 1.0)
    grad = np.empty((s, s, 4), np.uint8)
    for c in range(3):
        grad[..., c] = (_BG_TOP[c] + (_BG_BOTTOM[c] - _BG_TOP[c]) * t
                        ).astype(np.uint8)
    grad[..., 3] = 255
    img.paste(Image.fromarray(grad, "RGBA"), (0, 0),
              mask)

    # Cube grid: 3x3 front face + offset back face + corner connectors.
    gm = w * 0.18
    gl, gt = left + gm, top + gm * 0.9
    gw, gh = w - gm * 2, (bottom - top) - gm * 2.2
    stroke = max(1.0, size / 64.0) * ss
    cols = rows = 3
    cw, ch = gw / cols, gh / rows
    off = min(cw, ch) * 0.35

    def face(x0: float, y0: float, color) -> None:
        for c in range(cols + 1):
            x = x0 + c * cw
            draw.line((x, y0, x, y0 + gh), fill=color, width=round(stroke))
        for r in range(rows + 1):
            y = y0 + r * ch
            draw.line((x0, y, x0 + gw, y), fill=color, width=round(stroke))

    face(gl, gt, _FRONT)
    bx, by = gl + off, gt - off
    face(bx, by, _BACK)
    for (x0, y0, x1, y1) in (
        (gl, gt, bx, by),
        (gl + gw, gt, bx + gw, by),
        (gl, gt + gh, bx, by + gh),
        (gl + gw, gt + gh, bx + gw, by + gh),
    ):
        draw.line((x0, y0, x1, y1), fill=_BACK, width=round(stroke))

    _draw_label(draw, s, pad, size)

    img = Image.alpha_composite(img, overlay)
    img = img.resize((size, size), Image.LANCZOS)
    return np.asarray(img, np.uint8)


def _draw_label(draw, s: int, pad: int, size: int) -> None:
    """Bold "LUT" near the bottom, sized ~size/7.5 pt like the reference.

    Drawn as procedural strokes (not a font file) so output is identical
    on any host; the reference relies on the platform default QFont."""
    # Glyph height ~ 1.4x the Qt point size in pixels at 96 dpi.
    gh = max(6.0, size / 7.5) * 1.33 * 4  # supersampled px
    gw = gh * 0.62
    sp = gw * 0.35
    stroke = max(2.0, gh / 6.0)
    total = 3 * gw + 2 * sp
    x = (s - total) / 2.0
    y1 = s - pad - gh * 0.5
    y0 = y1 - gh
    c = _LABEL
    wd = round(stroke)
    # L
    draw.line((x, y0, x, y1), fill=c, width=wd)
    draw.line((x, y1, x + gw, y1), fill=c, width=wd)
    x += gw + sp
    # U
    draw.line((x, y0, x, y1 - gw / 2), fill=c, width=wd)
    draw.line((x + gw, y0, x + gw, y1 - gw / 2), fill=c, width=wd)
    draw.arc((x, y1 - gw, x + gw, y1), 0, 180, fill=c, width=wd)
    x += gw + sp
    # T
    draw.line((x, y0, x + gw, y0), fill=c, width=wd)
    draw.line((x + gw / 2, y0, x + gw / 2, y1), fill=c, width=wd)


def write_icon_pngs(dest_dir: Path | str,
                    sizes: Sequence[int] = ICON_SIZES) -> List[Path]:
    """Write lut-tpu_{size}.png for each size; returns the paths."""
    from PIL import Image

    dest = Path(dest_dir)
    dest.mkdir(parents=True, exist_ok=True)
    out = []
    for size in sizes:
        arr = render_icon(size)
        p = dest / f"lut-tpu_{size}.png"
        Image.fromarray(arr, "RGBA").save(p)
        out.append(p)
    return out

"""Per-frame render: planar YUV in -> planar YUV out, on an explicit device.

Counterpart of lut_renderer_tpu/ops/render.py. ``render_yuv_frame`` keeps
the JAX package's layout dispatch: "fused" runs kernel B (ops.fused420);
"plain" runs the pixel ops of ops.pixel around kernel A (ops.lut3d), on a
CUDA device as two kernels (ops/pixel.render_plain); and
"rowphase", which exists in the JAX package only to dodge XLA/Mosaic
layout costs and is bit-identical to plain by contract, is an alias of
plain. "auto" takes fused where it applies.

The LUT tier: ``lut_precision`` names one of the JAX package's numeric
tiers. A ``coarse2*`` tier (coarse2, coarse2f, coarse2x and their ``_tri``
forms) on a LUT with the decomposition (odd N >= 49) renders from a
Coarse2Table through kernel C or kernel B's coarse2 instantiation, as the
JAX package runs ``_run_coarse2_fused`` for it. Every other name, ``auto``
included, and a coarse2 tier on a LUT without the decomposition, render
from the exact table (kernels A and B): the JAX package's own fall-through
(its lut3d.py:932) for the latter, and its non-coarse tiers all
approximate the exact function.

A resize (``cfg.resize``, the policy's ``-s WxH``) takes the plain layout,
as in the JAX package: kernel A (or C) at the input size, then the
swscale-matched bicubic of ops.resample (the banded resample kernel) on
the RGB planes, then RGB->YUV.

PyTorch runs eagerly, so ``make_render_fn`` compiles nothing: it caches a
prepared callable per (config, LUT size, domain and tier, device) that
holds the per-config constants and the resize bands on the device, and
uploads the LUT once.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional, Tuple, Union

import torch

from ..device import DeviceLike, resolve_device
from .fused420 import bayer_tensor, fused420_applicable, render_fused420
from .lut3d import apply_lut_planes, canonical_interp
from .pixel import render_plain
from .prepare import COARSE2_TIERS, Coarse2Table, LutTable, has_coarse2
from .resample import bands_on, resample_plane

Table = Union[LutTable, Coarse2Table]


@dataclass(frozen=True)
class RenderConfig:
    """Static pixel-pipeline configuration for one render stage: the JAX
    package's RenderConfig field for field, defaults included.

    ``lut_strategy`` stays accepted for parity with the JAX API; both
    values run the same kernels. ``lut_precision`` picks the table
    (``lut_tier``)."""

    in_depth: int = 8
    out_depth: int = 8
    in_subsampling: str = "420"   # "420" | "422" | "444"
    out_subsampling: str = "420"
    in_full_range: bool = False
    # range the pipeline normalises to before the LUT
    work_full_range: bool = False
    out_full_range: bool = False
    matrix_in: str = "bt709"
    matrix_out: str = "bt709"
    interp: str = "tetrahedral"
    dither: str = "none"          # "none" | "ordered" | "random" |
    #                               "error_diffusion_host"
    chroma_up: str = "nearest"    # "nearest" | "bilinear"
    apply_lut: bool = True
    lut_strategy: str = "mxu"
    lut_precision: str = "auto"
    # requantise after range normalisation, as the reference's 8-bit
    # intermediate `format=yuv420p` step does
    requantize_intermediate: bool = True
    # output (w, h) of the policy's `-s WxH`: the plain layout, resampled
    # after the LUT (ops.resample)
    resize: Optional[Tuple[int, int]] = None
    # "auto" | "fused" | "plain" | "rowphase" (alias of plain)
    phase_layout: str = "auto"


_PHASE_LAYOUTS = ("auto", "plain", "rowphase", "fused")


def _use_fused(y, u, cfg: RenderConfig, lut) -> bool:
    """Layout choice; a forced "fused" that cannot apply raises."""
    if cfg.phase_layout not in _PHASE_LAYOUTS:
        raise ValueError(f"unknown phase_layout {cfg.phase_layout!r}")
    if cfg.phase_layout not in ("auto", "fused"):
        return False
    ok = fused420_applicable(y, u, cfg, lut)
    if not ok and cfg.phase_layout == "fused":
        raise ValueError(
            "phase_layout='fused' was forced but the fused YUV->YUV kernel "
            "does not apply to this config (it needs a LUT, nearest chroma "
            "siting, no resize, a non-error-diffusion dither, even "
            "dimensions, and matching chroma plane geometry); "
            f"cfg={cfg}, y={tuple(y.shape)}, u={tuple(u.shape)}")
    return ok


def lut_tier(precision: str, size: int) -> str:
    """The tier that runs for `precision` on an N^3 LUT: a coarse2 tier
    where the LUT has the decomposition, else "exact"."""
    return precision if precision in COARSE2_TIERS and has_coarse2(size) \
        else "exact"


def render_yuv_frame(y, u, v, lut: Optional[Table], cfg: RenderConfig,
                     bayer=None, resize_weights=None):
    """One (batched) frame through the pipeline. Inputs are integer
    code-value planes (uint8/uint16) at cfg.in_depth with
    cfg.in_subsampling chroma, on the device the work runs on.
    resize_weights: the (vertical, horizontal) Band pair of cfg.resize for
    this input size on that device (make_render_fn caches it); None builds
    it here."""
    return _render(y, u, v, lut, cfg, _use_fused(y, u, cfg, lut), bayer,
                   resize_weights)


def _render(y, u, v, lut: Optional[Table], cfg: RenderConfig, fused: bool,
            bayer, resize_weights):
    """render_yuv_frame in the layout already chosen: kernel B where
    `fused`, else the plain layout."""
    if fused:
        return render_fused420(y, u, v, lut, cfg, bayer=bayer)
    lut_fn = resize_fn = None
    if cfg.apply_lut and lut is not None:
        def lut_fn(r, g, b):
            return apply_lut_planes(r, g, b, lut, cfg.interp)
    if cfg.resize is not None:
        wv, wh = (resize_weights if resize_weights is not None
                  else bands_on(y.shape[-2:], cfg.resize, y.device))

        def resize_fn(r, g, b):
            return tuple(resample_plane(p, wv, wh) for p in (r, g, b))
    return render_plain(y, u, v, cfg, lut_fn, resize_fn, bayer)


def lut_operands_for(lut, cfg: RenderConfig,
                     device: DeviceLike) -> Optional[Table]:
    """The LUT on `device` as the kernels read it, or None when no LUT
    applies: a Coarse2Table when cfg.lut_precision names a coarse2 tier
    and the LUT has the decomposition, else a LutTable. Takes a LutTable,
    a Coarse2Table of the config's tier, or any object with a numpy
    ``table`` and ``domain_min``/``domain_max`` (a parsed Lut3D, the JAX
    package's PreparedLut). The upload and the coarse2 build happen here,
    on the device, once per render function."""
    if lut is None or not cfg.apply_lut:
        return None
    if isinstance(lut, Coarse2Table):
        if lut.tier != cfg.lut_precision:
            raise ValueError(f"a {lut.tier} table cannot render "
                             f"lut_precision={cfg.lut_precision!r}")
        return lut.to(device)
    table = (lut.to(device) if isinstance(lut, LutTable)
             else LutTable.from_prepared(lut, device))
    tier = lut_tier(cfg.lut_precision, table.size)
    if tier == "exact":
        return table
    return Coarse2Table.from_lut_table(table, tier)


class _Renderer:
    """The prepared callable for one (cfg, LUT size/domain/tier, device):
    the device's Bayer tensor, the config and, for a resize, the Band
    pairs on the device by input (H, W), with the LUT table passed per call
    so that LUTs of one size share it."""

    # Band pairs kept, by input size
    WEIGHTS_MAX = 4

    def __init__(self, cfg: RenderConfig, device: torch.device):
        self.cfg = cfg
        self.device = device
        self.bayer = bayer_tensor(device) if cfg.dither == "ordered" else None
        self._weights: dict = {}
        # runners of a daemon share this renderer (_RENDER_FN_CACHE)
        self._weights_lock = threading.Lock()

    def resize_weights(self, hw: Tuple[int, int]):
        """The Band pair for input size `hw`, built once; FIFO-bounded."""
        with self._weights_lock:
            pair = self._weights.get(hw)
            if pair is None:
                pair = bands_on(hw, self.cfg.resize, self.device)
                while len(self._weights) >= self.WEIGHTS_MAX:
                    self._weights.pop(next(iter(self._weights)))
                self._weights[hw] = pair
            return pair

    def __call__(self, y, u, v, lut):
        """(outputs, the layout: "fused" or "plain")."""
        rsw = None
        if self.cfg.resize is not None:
            rsw = self.resize_weights((int(y.shape[-2]), int(y.shape[-1])))
        fused = _use_fused(y, u, self.cfg, lut)
        return (_render(y, u, v, lut, self.cfg, fused, self.bayer, rsw),
                "fused" if fused else "plain")


class RenderFn:
    """The render function ``fn(y, u, v) -> (yq, uq, vq)`` of
    ``make_render_fn``. After each call ``layout`` ("fused" or "plain", as
    ``_use_fused`` chose for that batch) and ``interp`` (the interpolation
    that ran, None where no LUT applies) say what it ran; the executor's
    ``executor.render`` span records them. One per job: the attributes
    are its last call's."""

    __slots__ = ("_renderer", "_table", "layout", "interp")

    def __init__(self, renderer: _Renderer, table: Optional[Table]):
        self._renderer, self._table = renderer, table
        self.layout: Optional[str] = None
        self.interp = (None if table is None
                       else canonical_interp(renderer.cfg.interp))

    def __call__(self, y, u, v):
        out, self.layout = self._renderer(y, u, v, self._table)
        return out


_RENDER_FN_CACHE: dict = {}
_RENDER_FN_CACHE_MAX = 32
# concurrent TaskRunners reach this cache; the FIFO eviction is not atomic
_RENDER_FN_CACHE_LOCK = threading.Lock()


def make_render_fn(lut, cfg: RenderConfig,
                   device: DeviceLike = "cuda") -> RenderFn:
    """A render function ``fn(y, u, v) -> (yq, uq, vq)`` for tensors on
    `device` (a ``RenderFn``). Batched (B, H, W) inputs take the same path
    as single frames."""
    dev = resolve_device(device)
    table = lut_operands_for(lut, cfg, dev)
    key = (cfg, None if table is None else table.static_key, dev)
    with _RENDER_FN_CACHE_LOCK:
        renderer = _RENDER_FN_CACHE.get(key)
        if renderer is None:
            renderer = _Renderer(cfg, dev)
            while len(_RENDER_FN_CACHE) >= _RENDER_FN_CACHE_MAX:
                _RENDER_FN_CACHE.pop(next(iter(_RENDER_FN_CACHE)))
            _RENDER_FN_CACHE[key] = renderer
    return RenderFn(renderer, table)

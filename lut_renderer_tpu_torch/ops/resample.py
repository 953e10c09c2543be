"""Resolution rescale (`-s WxH`): swscale's default bicubic as two dense
f32 matmuls per plane.

Counterpart of lut_renderer_tpu/ops/resample.py. The weight model
(``swscale_bicubic_weights``, ``_keys``, ``_trunc_div``,
``resample_weights``) is that module's NumPy code, copied unchanged so the
matrices are bit-equal: FFmpeg's SWS_BICUBIC (Keys B=0, C=0.6) with its
16.16 fixed-point filter positions, the downscale widening and the border
taps folded to the edge (tests/test_resample.py holds it to libswscale).

``resample_plane`` computes ``Wv @ x @ Whᵀ`` with ``torch.matmul``, as the
JAX package computes its two einsums outside any Pallas kernel. Two rules
keep its output bit-stable:

* Full IEEE f32 whatever the process's TF32 setting: each product runs
  under ``ieee_f32_matmul``, a lock-guarded switch of PyTorch's cuBLAS
  precision to "ieee", restored after the call. A lock and not a
  per-call argument, because ``torch.matmul`` takes none; the lock keeps
  two resamples from interleaving their save and restore, and the switch
  is held only while the products are enqueued.
* Frame by frame: each (H, W) frame of the leading dimensions is its own
  pair of 2-D products, so a frame's result does not depend on how many
  frames share its batch (the cards' split, parallel/sharding.py, is
  bit-equal to the whole batch).
"""

from __future__ import annotations

import functools
import threading
from contextlib import contextmanager

import numpy as np
import torch

# swscale's default bicubic spline parameters (libswscale SWS_BICUBIC with
# SWS_PARAM_DEFAULT): Keys (B, C) = (0, 0.6).
_B = 0.0
_C = 0.6
_SIZE_FACTOR = 4  # bicubic support (2 px each side)


def _keys(x: float) -> float:
    """Keys BC-spline at |x| (un-normalized by the /6 that cancels in the
    per-row normalization, kept for clarity)."""
    if x < 1.0:
        return ((12 - 9 * _B - 6 * _C) * x * x * x
                + (-18 + 12 * _B + 6 * _C) * x * x
                + (6 - 2 * _B)) / 6.0
    if x < 2.0:
        return ((-_B - 6 * _C) * x * x * x
                + (6 * _B + 30 * _C) * x * x
                + (-12 * _B - 48 * _C) * x
                + (8 * _B + 24 * _C)) / 6.0
    return 0.0


def _trunc_div(n: int, d: int) -> int:
    """C int64 division: truncate toward zero (Python // floors)."""
    q = abs(n) // d
    return q if n >= 0 else -q


@functools.lru_cache(maxsize=64)
def swscale_bicubic_weights(src: int, dst: int) -> np.ndarray:
    """(dst, src) f32 row-stochastic resampling matrix matching FFmpeg's
    default `-s` scaler (SWS_BICUBIC) on this axis.

    Integer phase math mirrors libswscale's initFilter: xInc in 16.16 with
    half-dst rounding; output i's source center (2i+1)*xInc - 2^16 in 2^17
    units; window start trunc-toward-zero; downscale distances scaled by
    dst/src in fixed point; border taps folded to the edge.
    """
    if src <= 0 or dst <= 0:
        raise ValueError(f"bad resample sizes {src}->{dst}")
    xinc = (src * 65536 + (dst >> 1)) // dst
    upscale = xinc <= 65536
    if upscale:
        fsize = 1 + _SIZE_FACTOR
    else:
        fsize = 1 + (_SIZE_FACTOR * src + dst - 1) // dst
    fsize = max(1, min(fsize, src - 2)) if src > 2 else 1

    W = np.zeros((dst, src), np.float64)
    for i in range(dst):
        xdst = (2 * i + 1) * xinc - 65536          # center, 2^17 units
        xx0 = _trunc_div(xdst - (fsize - 2) * 65536, 131072)
        row = W[i]
        for j in range(fsize):
            d = abs((xx0 + j) * 131072 - xdst) << 13   # 2^30 units
            if not upscale:
                d = d * dst // src                     # arg in output px
            row[min(max(xx0 + j, 0), src - 1)] += _keys(d / 1073741824.0)
        s = row.sum()
        if s != 0.0:
            row /= s
        else:  # degenerate (fsize==1 landed on a zero): nearest
            row[min(max(xx0, 0), src - 1)] = 1.0
    return np.ascontiguousarray(W, np.float32)


def resample_weights(in_hw, out_hw):
    """(Wv, Wh) numpy f32 pair for an (H, W) -> (out_h, out_w) resample."""
    (in_h, in_w), (out_h, out_w) = in_hw, out_hw
    return (swscale_bicubic_weights(in_h, out_h),
            swscale_bicubic_weights(in_w, out_w))


_MATMUL_PRECISION_LOCK = threading.Lock()


@contextmanager
def ieee_f32_matmul():
    """PyTorch's cuBLAS f32 matmuls in full IEEE precision (no TF32) inside
    the block, the caller's setting restored after it. Lock-guarded: the
    switch is process-wide, so two blocks must not interleave."""
    mm = torch.backends.cuda.matmul
    with _MATMUL_PRECISION_LOCK:
        saved = mm.fp32_precision
        mm.fp32_precision = "ieee"
        try:
            yield
        finally:
            mm.fp32_precision = saved


def resample_plane(x: torch.Tensor, wv: torch.Tensor,
                   wh: torch.Tensor) -> torch.Tensor:
    """Apply the separable resample to the trailing (H, W) axes of `x` (any
    leading batch dims): ``Wv @ x @ Whᵀ`` in f32, the vertical product
    first, frame by frame, in full IEEE precision."""
    xf = x.to(torch.float32)
    h, w = xf.shape[-2:]
    frames = xf.reshape(-1, h, w)
    out = torch.empty((frames.shape[0], wv.shape[0], wh.shape[0]),
                      dtype=torch.float32, device=xf.device)
    wh_t = wh.t()
    with ieee_f32_matmul():
        for i, frame in enumerate(frames):
            torch.matmul(torch.matmul(wv, frame), wh_t, out=out[i])
    return out.reshape(*xf.shape[:-2], *out.shape[-2:])


def weights_on(in_hw, resize, device) -> tuple:
    """The (Wv, Wh) pair for input (H, W) -> ``resize`` = (out_w, out_h),
    as f32 tensors on `device`."""
    rw, rh = resize
    return tuple(torch.from_numpy(m).to(device)
                 for m in resample_weights(in_hw, (rh, rw)))

"""Resolution rescale (`-s WxH`): swscale's default bicubic, one banded
pass a plane.

Counterpart of lut_renderer_tpu/ops/resample.py. The weight model
(``swscale_bicubic_weights``, ``_keys``, ``_trunc_div``,
``resample_weights``) is that module's NumPy code, copied unchanged so the
matrices are bit-equal: FFmpeg's SWS_BICUBIC (Keys B=0, C=0.6) with its
16.16 fixed-point filter positions, the downscale widening and the border
taps folded to the edge (tests/test_resample.py holds it to libswscale).

The JAX package computes ``Wv @ x @ Whᵀ`` as two dense einsums. Both
matrices are banded: a 2:1 downscale has 8 non-zero weights a row of
2160 or 3840. So here each matrix is held as a ``Band`` (a start column
and a fixed number of taps a row, built on the host from the dense f32
matrix) and ``resample_plane`` applies the two bands:

* on a CUDA tensor, the banded resample kernel (csrc/resample.cu), one
  launch a plane for every frame of the stack; it replaces no TPU kernel
  (the JAX package's einsums run outside any Pallas kernel) and takes
  the place of the dense cuBLAS products, which multiplied by zero almost
  everywhere;
* on a CPU tensor, ``resample_plane_reference``, the same taps in the
  same order in plain PyTorch.

Both compute the vertical pass first, rounded to f32, then the
horizontal pass, each output a sum over its slots in ascending order with
every multiply and add rounded on its own. So the kernel equals the plain
version bit for bit, the result does not depend on the TF32 setting, and
a frame resamples the same alone or in a batch (the cards' split,
parallel/sharding.py, is bit-equal to the whole batch).
``resample_plane_dense``, the dense products in full IEEE f32 under
``ieee_f32_matmul``, stays as the yardstick the tests and chip_smoke.py
hold the band to.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Tuple, Union

import numpy as np
import torch

from . import _build

# launches of the banded resample kernel by resample_plane (reset by
# callers that check which path ran)
launches = 0

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


# ---------------------------------------------------------------------------
# band form
# ---------------------------------------------------------------------------

@dataclass(frozen=True, eq=False)
class Band:
    """One axis of the resample: output ``i`` is the sum over the slots
    ``k < K`` of ``taps[i, k] * input[start[i] + k]``, ``K`` the widest
    run of non-zero weights over the rows. A row whose run is shorter
    holds 0 in its other slots; a row whose run would pass the last input
    starts earlier instead, so that every slot reads inside the axis.
    Hashed by identity: the kernel's launch geometry is cached a pair."""

    start: torch.Tensor        # (dst,) int32
    taps: torch.Tensor         # (dst, K) float32
    src: int
    host_start: np.ndarray     # start on the host, for the launch geometry

    @classmethod
    def from_dense(cls, w: np.ndarray, device="cpu") -> "Band":
        """The band of a (dst, src) f32 matrix, exact: every non-zero
        weight of `w` lies in it. Raises unless the starts rise with the
        rows, as every resample matrix's do."""
        w = np.asarray(w, np.float32)
        dst, src = w.shape
        nz = w != 0
        first = nz.argmax(axis=1)
        last = src - 1 - nz[:, ::-1].argmax(axis=1)
        k = int((last - first + 1).max())
        start = np.minimum(first, src - k)
        if np.any(np.diff(start) < 0):
            raise ValueError("a band's starts must not decrease from row to "
                             "row (a tile's window runs from its first "
                             "start to its last)")
        taps = w[np.arange(dst)[:, None], start[:, None] + np.arange(k)]
        return cls(torch.tensor(start, dtype=torch.int32, device=device),
                   torch.tensor(taps, dtype=torch.float32, device=device),
                   src, start.astype(np.int64))

    @property
    def dst(self) -> int:
        return self.taps.shape[0]

    @property
    def k(self) -> int:
        return self.taps.shape[1]

    def to(self, device) -> "Band":
        return Band(self.start.to(device), self.taps.to(device), self.src,
                    self.host_start)


def _as_band(w, device) -> Band:
    """A Band as it is; a dense matrix banded on the host (a copy from the
    device: the render path passes the bands make_render_fn caches)."""
    if isinstance(w, Band):
        return w
    if isinstance(w, torch.Tensor):
        w = w.detach().cpu().numpy()
    return Band.from_dense(w, device)


def bands_on(in_hw, resize, device) -> Tuple[Band, Band]:
    """The (vertical, horizontal) Band pair for input (H, W) -> ``resize``
    = (out_w, out_h) on `device`, built from the dense f32 matrices of
    ``resample_weights``."""
    rw, rh = resize
    return tuple(Band.from_dense(m, device)
                 for m in resample_weights(in_hw, (rh, rw)))


# ---------------------------------------------------------------------------
# plain PyTorch version (the kernel's arithmetic, tap by tap)
# ---------------------------------------------------------------------------

def _band_pass(x: torch.Tensor, band: Band, dim: int) -> torch.Tensor:
    start = band.start.long()
    acc = 0.0
    for k in range(band.k):
        tap = band.taps[:, k] if dim == -1 else band.taps[:, k, None]
        acc = acc + tap * x.index_select(dim, start + k)
    return acc


def resample_plane_reference(x: torch.Tensor, bv: Band,
                             bh: Band) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device: the vertical
    band over the rows of each (H, W) frame of `x`, then the horizontal
    band over its columns, a slot at a time (one multiply and one add,
    each rounded)."""
    xf = x.to(torch.float32)
    return _band_pass(_band_pass(xf, bv, -2), bh, -1)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

THREADS = 256               # a block (csrc/resample.cu kThreads)
SMEM_BYTES = 48 * 1024      # a block's shared memory at most: no opt-in
MAX_GRID_YZ = 65535         # row tiles (grid y) and frames (grid z)
# output tiles a block, (rows, columns), largest first (the wider of two
# alike: longer rows of stores): the first whose whole input window fits
# SMEM_BYTES is taken
TILES = ((16, 128), (32, 64), (16, 64), (8, 64), (8, 32), (4, 32), (4, 16),
         (2, 16), (2, 8), (1, 8), (1, 4), (1, 2), (1, 1))


class _ResampleParams(ctypes.Structure):
    """Mirror of ResampleParams in csrc/resample.cu."""

    _fields_ = [
        ("x", ctypes.c_void_p), ("out", ctypes.c_void_p),
        ("v_start", ctypes.c_void_p), ("v_taps", ctypes.c_void_p),
        ("h_start", ctypes.c_void_p), ("h_taps", ctypes.c_void_p),
        ("frames", ctypes.c_longlong),
        ("h", ctypes.c_int), ("w", ctypes.c_int),
        ("oh", ctypes.c_int), ("ow", ctypes.c_int),
        ("kv", ctypes.c_int), ("kh", ctypes.c_int),
        ("tile_h", ctypes.c_int), ("tile_w", ctypes.c_int),
        ("win_h", ctypes.c_int), ("win_w", ctypes.c_int),
        ("chunk_h", ctypes.c_int), ("vec", ctypes.c_int),
    ]


@dataclass(frozen=True)
class Geometry:
    """A launch's shape: the output tile a block, the largest input window
    of a tile (rows; columns, rounded up to a multiple of 4: the row
    pitch) and the window rows staged at once (``chunk_h`` < ``win_h`` only
    where no tile's whole window fits)."""

    tile_h: int
    tile_w: int
    win_h: int
    win_w: int
    chunk_h: int


def window(band: Band, tile: int, align: int) -> int:
    """The most inputs a tile of `tile` outputs of `band` reads, from its
    first start rounded down to `align` to its last slot, rounded up to
    `align`."""
    s = band.host_start
    first = np.arange(0, band.dst, tile)
    last = np.minimum(first + tile, band.dst) - 1
    lo = s[first] - s[first] % align
    span = s[last] + band.k - lo
    return int((-(-span // align) * align).max())


def smem_bytes(tile_h: int, tile_w: int, win_w: int, chunk_h: int, kv: int,
               kh: int) -> int:
    """A block's shared memory (csrc/resample.cu smem_bytes): the staged
    rows, the vertical sums, the tile's taps and starts."""
    return 4 * ((chunk_h + tile_h) * win_w + tile_h * kv + tile_w * kh
                + tile_h + tile_w)


@functools.lru_cache(maxsize=32)
def geometry(bv: Band, bh: Band, vec: bool) -> Geometry:
    """The launch geometry for a band pair: the largest tile of TILES whose
    whole window fits SMEM_BYTES, else a 1x1 tile that stages its window
    in chunks of rows. Raises where not one row fits."""
    align = 4 if vec else 1

    def win_w_of(tw):  # the row pitch: a multiple of 4 on either path
        return -(-window(bh, tw, align) // 4) * 4

    for th, tw in TILES:
        win_h, win_w = window(bv, th, 1), win_w_of(tw)
        if smem_bytes(th, tw, win_w, win_h, bv.k, bh.k) <= SMEM_BYTES:
            return Geometry(th, tw, win_h, win_w, win_h)
    win_h, win_w = window(bv, 1, 1), win_w_of(1)
    fixed = smem_bytes(1, 1, win_w, 0, bv.k, bh.k)
    chunk = (SMEM_BYTES - fixed) // (4 * win_w)
    if chunk < 1:
        raise ValueError(f"the resample's band of {bh.k} taps is too wide "
                         f"for a block's {SMEM_BYTES} bytes of shared memory")
    return Geometry(1, 1, win_h, win_w, min(chunk, win_h))


def launch_args(x: torch.Tensor, bv: Band, bh: Band):
    """Check the operands of the kernel and allocate its output:
    (params, out, keep). `x` is a contiguous float32 (frames, H, W)
    stack; ``keep`` holds every tensor the params point to."""
    frames, h, w = x.shape
    dev = x.device
    for band, n, axis in ((bv, h, "rows"), (bh, w, "columns")):
        if band.src != n:
            raise ValueError(f"a band over {band.src} {axis} cannot take "
                             f"{n}")
        if band.start.device != dev or band.taps.device != dev:
            raise ValueError(f"the bands must lie on {dev}, as the planes "
                             f"do; got {band.start.device}")
    vec = w % 4 == 0 and x.data_ptr() % 16 == 0
    g = geometry(bv, bh, vec)
    if frames > MAX_GRID_YZ or -(-bv.dst // g.tile_h) > MAX_GRID_YZ:
        raise ValueError(f"the resample kernel takes at most {MAX_GRID_YZ} "
                         f"frames and row tiles a launch; got {frames} "
                         f"frames of {bv.dst} rows; split the batch")
    out = torch.empty((frames, bv.dst, bh.dst), dtype=torch.float32,
                      device=dev)
    p = _ResampleParams(
        x=x.data_ptr(), out=out.data_ptr(), v_start=bv.start.data_ptr(),
        v_taps=bv.taps.data_ptr(), h_start=bh.start.data_ptr(),
        h_taps=bh.taps.data_ptr(), frames=frames, h=h, w=w, oh=bv.dst,
        ow=bh.dst, kv=bv.k, kh=bh.k, tile_h=g.tile_h, tile_w=g.tile_w,
        win_h=g.win_h, win_w=g.win_w, chunk_h=g.chunk_h, vec=int(vec))
    return p, out, (x, bv, bh, out)


def resample_plane(x: torch.Tensor, wv: Union[Band, torch.Tensor],
                   wh: Union[Band, torch.Tensor]) -> torch.Tensor:
    """Apply the separable resample to the trailing (H, W) axes of `x` (any
    leading batch dims). `wv`, `wh`: the vertical and horizontal Bands
    (``bands_on``), or their dense matrices, banded here.

    A CUDA tensor launches the kernel, once for the whole stack (raising
    if it cannot build or take the launch); a CPU tensor runs the plain
    version."""
    global launches
    bv, bh = _as_band(wv, x.device), _as_band(wh, x.device)
    h, w = x.shape[-2:]
    if x.device.type == "cuda":
        frames = x.to(torch.float32).reshape(-1, h, w).contiguous()
        p, out, _keep = launch_args(frames, bv, bh)
        if frames.shape[0]:
            _build.launch("resample_launch", p, x.device)
            launches += 1
        return out.reshape(*x.shape[:-2], *out.shape[-2:])
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    if (bv.src, bh.src) != (h, w):
        raise ValueError(f"bands over {(bv.src, bh.src)} cannot take frames "
                         f"of {(h, w)}")
    return resample_plane_reference(x, bv, bh)


# ---------------------------------------------------------------------------
# the dense yardstick
# ---------------------------------------------------------------------------

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


def resample_plane_dense(x: torch.Tensor, wv: torch.Tensor,
                         wh: torch.Tensor) -> torch.Tensor:
    """``Wv @ x @ Whᵀ`` with dense matrices, the vertical product first,
    frame by frame, in full IEEE f32: the JAX package's two einsums, for
    the tests and chip_smoke.py's library time. No render path runs it."""
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
    """The dense (Wv, Wh) pair for input (H, W) -> ``resize`` =
    (out_w, out_h), as f32 tensors on `device`."""
    rw, rh = resize
    return tuple(torch.from_numpy(m).to(device)
                 for m in resample_weights(in_hw, (rh, rw)))

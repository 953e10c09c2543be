"""Loader for the optional native helpers (native/libluttpu_native.so).

Builds on demand with g++ (toolchain is present in the target environment)
and degrades to pure-Python silently when unavailable — the .so accelerates,
it is never required. Components:

  * ltn_cube_parse: fast .cube parsing straight into [r][g][b] layout
    (~30x faster than the text path for 65^3 LUTs);
  * ltn_dither_ed / ltn_dither_ed_fx: exact Floyd-Steinberg error diffusion
    (serpentine) — the serial algorithm the TPU's ordered dither substitutes
    for; used as the dither quality oracle and as an opt-in host finishing
    pass. _fx is the fixed-point production path (3.1x the float version).
"""

from __future__ import annotations

import ctypes
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
_SO_PATH = _NATIVE_DIR / "build" / "libluttpu_native.so"

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_LOCK = threading.Lock()


def _build() -> bool:
    try:
        result = subprocess.run(
            ["make", "-s"], cwd=str(_NATIVE_DIR),
            capture_output=True, timeout=120,
        )
        return result.returncode == 0 and _SO_PATH.exists()
    except Exception:
        return False


def get_native() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        if not _SO_PATH.exists() and not _build():
            return None
        try:
            lib = ctypes.CDLL(str(_SO_PATH))
            lib.ltn_cube_parse.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_long,
                ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_float),
            ]
            lib.ltn_cube_parse.restype = ctypes.c_int
            lib.ltn_dither_ed.argtypes = [
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_uint16),
                ctypes.c_int,
                ctypes.c_int,
                ctypes.c_float,
            ]
            lib.ltn_dither_ed.restype = ctypes.c_int
            # Fixed-point fast path (round 4): ~3x the float recurrence.
            # May be absent from a stale prebuilt .so — probed, optional.
            try:
                lib.ltn_dither_ed_fx.argtypes = lib.ltn_dither_ed.argtypes
                lib.ltn_dither_ed_fx.restype = ctypes.c_int
            except AttributeError:
                pass
            _LIB = lib
        except OSError:
            _LIB = None
        return _LIB


def native_available() -> bool:
    return get_native() is not None


def parse_cube_native(path) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Parse a .cube via the native parser.

    Returns (table (N,N,N,3) f32, domain_min (3,), domain_max (3,)) or None
    when the native library is unavailable. Raises colorcore's CubeParseError
    on malformed files (error-code mapped) so callers see one error type.
    """
    lib = get_native()
    if lib is None:
        return None
    from .colorcore.cube import MAX_LUT_SIZE, CubeParseError

    max_entries = 3 * MAX_LUT_SIZE**3
    buf = np.empty(max_entries, np.float32)
    n = ctypes.c_int(0)
    domain = np.zeros(6, np.float32)
    rc = lib.ltn_cube_parse(
        str(path).encode(),
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        max_entries,
        ctypes.byref(n),
        domain.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if rc == -1:
        raise FileNotFoundError(str(path))
    if rc < 0:
        messages = {
            -2: "missing LUT_3D_SIZE",
            -3: "unsupported LUT_3D_SIZE",
            -4: "wrong number of data values",
            -5: "LUT too large",
            -6: "non-finite values in LUT data",
            -7: "1D LUTs are not supported (need LUT_3D_SIZE)",
        }
        raise CubeParseError(f"{path}: {messages.get(rc, f'parse error {rc}')}")
    nn = n.value
    table = buf[: 3 * nn**3].reshape(nn, nn, nn, 3).copy()
    return table, domain[:3].copy(), domain[3:].copy()


def error_diffusion_quantize(
    x: np.ndarray, depth: int, exact_float: bool = False
) -> Optional[np.ndarray]:
    """Exact Floyd-Steinberg quantization of float code values (H, W) at
    `depth` bits; None when the native library is unavailable.

    The production path is the fixed-point recurrence (ltn_dither_ed_fx,
    1/4096-code-value input resolution, per-pixel error conserved exactly;
    3.1x the float version's throughput on this host — measured 4.05 vs
    12.5 ns/px, experiments/r7_dither_fx.py). `exact_float=True` selects
    the original float recurrence (the arithmetic the round-3 FINDINGS
    numbers were taken with); outputs differ from fx only by +-1-code
    toggles at ~14% of pixels with identical mean and visual noise shape.
    """
    lib = get_native()
    if lib is None:
        return None
    fn = lib.ltn_dither_ed
    if not exact_float:
        fn = getattr(lib, "ltn_dither_ed_fx", fn)
    x = np.ascontiguousarray(x, np.float32)
    h, w = x.shape
    out = np.empty((h, w), np.uint16)
    rc = fn(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        h, w, float((1 << depth) - 1),
    )
    if rc != 0:
        return None
    return out.astype(np.uint8) if depth <= 8 else out

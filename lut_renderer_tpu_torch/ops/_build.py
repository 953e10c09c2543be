"""Build and load the hand-written CUDA kernels of csrc/.

The sources compile with nvcc into one shared library with a plain C
interface, loaded through ctypes: one nvcc per source, all started at once,
then one link. The build happens at first use, on the machine that has the
card, into ``lut_renderer_tpu_torch/build/`` under a name keyed by a hash
of the sources and flags, so an edited source rebuilds and an unchanged one
loads at once. Nothing here runs at import time.

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``-fmad=false``. The last keeps
every multiply and add separately rounded, as the NumPy/PyTorch versions
compute them, so the integer planes of the fused kernel match the plain
path. ``--use_fast_math`` is not used: colorcore.matrices divides, and the
kernels need IEEE division to agree with it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
SOURCES = ("lut3d.cu", "coarse2.cu", "fused420.cu")
HEADERS = ("lut_interp.cuh",)
ENTRY_POINTS = ("lut3d_launch", "coarse2_launch", "fused420_launch",
                "fused420_coarse2_launch")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xcompiler", "-fPIC",
)

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
# seconds the last build (or load of a cached build) took, for reports
build_seconds: Optional[float] = None


def nvcc_path() -> str:
    """nvcc on PATH, else under $CUDA_HOME (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _run(cmds) -> None:
    """Run the commands at once; raise with the output of the first that
    fails."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    outs = [(cmd, proc.communicate()[0], proc.returncode)
            for cmd, proc in procs]
    for cmd, out, rc in outs:
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{out}")


def _compile(target: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{target.name}.{os.getpid()}"
    objs = [BUILD_DIR / f"{Path(s).stem}.{tag}.o" for s in SOURCES]
    tmp = BUILD_DIR / f"{tag}.tmp"
    nvcc = nvcc_path()
    try:
        _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC / s)]
              for s, o in zip(SOURCES, objs)])
        _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
               *(str(o) for o in objs)]])
        os.replace(tmp, target)
    finally:
        tmp.unlink(missing_ok=True)
        for o in objs:
            o.unlink(missing_ok=True)


def load_library() -> ctypes.CDLL:
    """The kernel library, built on first call. Raises if it cannot be
    built or loaded; there is no fallback."""
    global _LIB, build_seconds
    with _LOCK:
        if _LIB is not None:
            return _LIB
        t0 = time.perf_counter()
        target = BUILD_DIR / f"liblut_kernels_{_digest()}.so"
        if not target.exists():
            _compile(target)
        lib = ctypes.CDLL(str(target))
        for name in ENTRY_POINTS:
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        build_seconds = time.perf_counter() - t0
        _LIB = lib
        return lib


def launch(fn_name: str, params: ctypes.Structure, device: torch.device):
    """Launch `fn_name` with `params` on the current stream of `device`,
    raising on any launch error the C entry point reports."""
    lib = load_library()
    # makes the device's context current on this thread, which the
    # library's own CUDA runtime launches into
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn_name)(ctypes.byref(params),
                                    ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {err} at launch")

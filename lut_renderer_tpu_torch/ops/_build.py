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
# the render library: the kernels a render path launches, and nothing else
# (the stage probes build their own, probes/harness.probe_library)
SOURCES = ("lut3d.cu", "coarse2.cu", "fused420.cu", "fused420_coarse2.cu",
           "resample.cu")
HEADERS = ("lut_interp.cuh", "planar_lut.cuh", "fused420.cuh")
ENTRY_POINTS = ("lut3d_launch", "coarse2_launch", "fused420_launch",
                "fused420_coarse2_launch", "resample_launch")
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


def _digest(csrc: Path, files, flags) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + tuple(flags)).encode())
    for name in files:
        h.update(name.encode())
        h.update((csrc / name).read_bytes())
    return h.hexdigest()[:16]


def run_all(cmds) -> None:
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


def _compile(target: Path, csrc: Path, sources, flags) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{target.name}.{os.getpid()}"
    objs = [BUILD_DIR / f"{Path(s).stem}.{tag}.o" for s in sources]
    tmp = BUILD_DIR / f"{tag}.tmp"
    nvcc = nvcc_path()
    try:
        run_all([[nvcc, *NVCC_FLAGS, *flags, "-c", "-o", str(o),
                  str(csrc / s)] for s, o in zip(sources, objs)])
        run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
               *(str(o) for o in objs)]])
        os.replace(tmp, target)
    finally:
        tmp.unlink(missing_ok=True)
        for o in objs:
            o.unlink(missing_ok=True)


def open_library(path: Path, entry_points) -> ctypes.CDLL:
    """Load a built library and declare its entry points, each
    ``int fn(const Params*, cudaStream_t)``."""
    lib = ctypes.CDLL(str(path))
    for name in entry_points:
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def build_library(csrc: Path, sources, entry_points, flags=(),
                  headers=None, name: str = "liblut_kernels") -> ctypes.CDLL:
    """Build `sources` of the directory `csrc` with NVCC_FLAGS and
    `flags` (unless a build of the same files and flags is there) and
    load it. ``headers``: the headers the sources include, for the key
    (default: every .cuh of `csrc`). For this package's kernels, and for
    the probes' builds of variants and of other revisions' sources."""
    if headers is None:
        headers = sorted(p.name for p in csrc.glob("*.cuh"))
    files = tuple(sources) + tuple(headers)
    target = BUILD_DIR / f"{name}_{_digest(csrc, files, flags)}.so"
    if not target.exists():
        _compile(target, csrc, sources, tuple(flags))
    return open_library(target, entry_points)


def load_library() -> ctypes.CDLL:
    """The kernel library, built on first call. Raises if it cannot be
    built or loaded; there is no fallback."""
    global _LIB, build_seconds
    with _LOCK:
        if _LIB is not None:
            return _LIB
        t0 = time.perf_counter()
        lib = build_library(CSRC, SOURCES, ENTRY_POINTS, headers=HEADERS)
        build_seconds = time.perf_counter() - t0
        _LIB = lib
        return lib


def launch(fn_name: str, params: ctypes.Structure, device: torch.device,
           lib: Optional[ctypes.CDLL] = None):
    """Launch `fn_name` of `lib` (the kernel library when None) with
    `params` on the current stream of `device`, raising on any launch
    error the C entry point reports."""
    lib = lib or load_library()
    # makes the device's context current on this thread, which the
    # library's own CUDA runtime launches into
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn_name)(ctypes.byref(params),
                                    ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {err} at launch")

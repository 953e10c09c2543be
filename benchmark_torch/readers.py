"""Helpers of the metric readers (``metrics/<name>.py``): which device
events belong to which layer, and the shapes a launch covers."""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from . import roofline
from .reference import bicubic_weights
from .trace import copy_kind


def percentile(values: List[float], q: float) -> Optional[float]:
    """The q-th percentile (numpy's linear rule), None for no values."""
    return float(np.percentile(values, q)) if values else None


def is_kernel_b(name: str) -> bool:
    """Kernel B with the exact table (csrc/fused420.cuh)."""
    return "fused420_kernel" in name and "Coarse2" not in name


def is_kernel_a(name: str) -> bool:
    """Kernel A: the planar kernel on the exact table (csrc/planar_lut.cuh)."""
    return "planar_kernel" in name and "Lut3dParams" in name


def is_kernel_c(name: str) -> bool:
    return "planar_kernel" in name and "Coarse2Params" in name


def is_gemm(name: str) -> bool:
    """A cuBLAS matrix product (the resample's, in the cells that resize)."""
    low = name.lower()
    return any(k in low for k in ("gemm", "xmma", "cutlass", "splitk"))


def is_kernel(name: str) -> bool:
    return copy_kind(name) is None


def frames_per_launch(run) -> int:
    """Frames a render launch covers: the batch, or its chunk on a card."""
    return run.batch // len(run.cards)


def per_batch_ms(run, ms: float) -> Optional[float]:
    """Milliseconds of the traced window per batch the window rendered."""
    return ms / len(run.batches) if run.batches else None


def roofline_pct(run, pick, bound_ms: float) -> Optional[float]:
    """Share of the least time, in percent, over the traced launches that
    `pick` accepts, each bounded by `bound_ms`; None without a launch."""
    if run.trace is None:
        return None
    ms, count = run.trace.device_ms(pick)
    return 100.0 * count * bound_ms / ms if count else None


def resample_bound_ms(run) -> float:
    """The least time of one batch's resample (roofline.resample_bound)."""
    from .harness import resize_of

    ow, oh = resize_of(run.cell)
    h, w = run.shape
    return roofline.resample_bound(bicubic_weights(h, oh),
                                   bicubic_weights(w, ow), run.batch)[0]

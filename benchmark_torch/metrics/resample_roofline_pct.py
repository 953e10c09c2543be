"""resample_roofline_pct (ops.resample): the resample's least time at its
banded taps (readers.resample_bound_ms) for every batch of the traced
window, over the traced time of the matrix products, in percent."""

from benchmark_torch.readers import is_gemm, resample_bound_ms


def read(run):
    if run.trace is None or not run.cell.traffic.get("params", {}).get(
            "resolution"):
        return None
    ms, count = run.trace.device_ms(is_gemm)
    if not count:
        return None
    return 100.0 * len(run.batches) * resample_bound_ms(run) / ms

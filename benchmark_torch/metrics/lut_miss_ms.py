"""lut_miss_ms (tasks.runner): the program's runner.lut_load span on a
miss of the LUT cache (a parse, the pad and the upload), mean over the
window's misses (host clock)."""

from benchmark_torch.spans import mean_ms, window


def read(run):
    return mean_ms([r for r in window(run, "runner.lut_load") or ()
                    if r.attrs.get("hit") is not True])

"""lut_hit_ms (tasks.runner): the program's runner.lut_load span on a hit
of the LUT cache, mean over the window's hits (host clock)."""

from benchmark_torch.spans import mean_ms, window


def read(run):
    return mean_ms([r for r in window(run, "runner.lut_load") or ()
                    if r.attrs.get("hit") is True])

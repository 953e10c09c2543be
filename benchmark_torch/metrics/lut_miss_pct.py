"""lut_miss_pct (tasks.runner): the window's loads through the LUT cache
that missed, over all of them, from the program's runner.lut_load spans,
in percent."""

from benchmark_torch.spans import window


def read(run):
    loads = window(run, "runner.lut_load")
    if not loads:
        return None
    return 100.0 * sum(r.attrs.get("hit") is not True for r in loads) \
        / len(loads)

"""idle_in_lut_load_pct (tasks.runner): the device's idle time (no
kernel, copy or set on a card, averaged over the cards) inside the
program's runner.lut_load spans on the device loop's thread (the loads
through the LUT cache: the parses on misses), as a share of the traced
window, in percent."""

from benchmark_torch.spans import idle_in_pct


def read(run):
    return idle_in_pct(run, "runner.lut_load")

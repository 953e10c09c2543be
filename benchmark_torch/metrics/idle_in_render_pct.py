"""idle_in_render_pct (ops.render): the device's idle time (no kernel,
copy or set on a card, averaged over the cards) inside the program's
executor.render spans on the device loop's thread (the render function's
calls, and the host's waits inside them), as a share of the traced
window, in percent."""

from benchmark_torch.spans import idle_in_pct


def read(run):
    return idle_in_pct(run, "executor.render")

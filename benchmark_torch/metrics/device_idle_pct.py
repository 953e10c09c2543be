"""device_idle_pct (device): the share of the traced window in which no
kernel, copy or set runs on the cell's cards, averaged over them."""


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s(run.cards) / tr.window_s)

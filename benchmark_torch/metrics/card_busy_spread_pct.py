"""card_busy_spread_pct (parallel.sharding): the busiest card's busy share
of the traced window minus the least busy card's, in percentage points
(``trace.busy_s([card])``): how unevenly the split loads its cards. The
first card carries every batch's copies in and out besides its chunk.
None without a trace or with one card."""


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0 or len(run.cards) < 2:
        return None
    shares = [100.0 * tr.busy_s([card]) / tr.window_s for card in run.cards]
    return max(shares) - min(shares)

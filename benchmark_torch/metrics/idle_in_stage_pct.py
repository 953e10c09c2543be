"""idle_in_stage_pct (engine.executor): the device's idle time (no
kernel, copy or set on a card, averaged over the cards) inside the
program's executor.stage spans on the device loop's thread (each batch's
pageable -> pinned copy and its copy in enqueued), as a share of the
traced window, in percent."""

from benchmark_torch.spans import idle_in_pct


def read(run):
    return idle_in_pct(run, "executor.stage")

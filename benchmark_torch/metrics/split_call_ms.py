"""split_call_ms (parallel.sharding): the program's sharding.call span,
a call of the split render function on the host (the chunks put to their
cards, each card's render and copy home enqueued, the streams' waits and
the concat on the first card), mean over the window's batches (host
clock). A program without the span reads None."""

from benchmark_torch.spans import mean_ms, window


def read(run):
    return mean_ms(window(run, "sharding.call"))

"""stage_ms (engine.executor): the program's executor.stage span, each
batch's pageable -> pinned copy and the enqueue of its copy in, mean over
the window's batches (host clock)."""

from benchmark_torch.spans import mean_ms, window


def read(run):
    return mean_ms(window(run, "executor.stage"))

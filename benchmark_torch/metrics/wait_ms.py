"""wait_ms (engine.executor): the program's executor.wait span, the host
waiting for the previous batch's copy out, mean over the window's batches
(host clock)."""

from benchmark_torch.spans import mean_ms, window


def read(run):
    return mean_ms(window(run, "executor.wait"))

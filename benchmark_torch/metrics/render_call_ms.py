"""render_call_ms (ops.render): the program's executor.render span, the
render function's call on the host (its launches, and the host's waits
inside it), mean over the window's batches (host clock)."""

from benchmark_torch.spans import mean_ms, window


def read(run):
    return mean_ms(window(run, "executor.render"))

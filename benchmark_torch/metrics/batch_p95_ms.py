"""batch_p95_ms: over every batch taken in the window, the time from
render_batches taking it from its iterator to yielding its output; the
95th percentile."""

from benchmark_torch.readers import percentile


def read(run):
    return percentile([(b.yielded - b.taken) * 1e3 for b in run.batches
                       if b.taken < run.t_close and b.yielded is not None], 95)

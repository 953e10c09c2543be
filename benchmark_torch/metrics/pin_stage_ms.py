"""pin_stage_ms (engine.executor, host staging): host time of
aten::pin_memory, the pageable -> pinned copy of each input plane, per
batch of the traced window."""

from benchmark_torch.readers import per_batch_ms


def read(run):
    if run.trace is None:
        return None
    return per_batch_ms(run, run.trace.host_ms({"aten::pin_memory"}))

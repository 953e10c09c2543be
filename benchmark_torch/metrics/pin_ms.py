"""pin_ms (engine.executor, host staging): the program's executor.pin
span, each batch's pageable -> pinned copy and the enqueue of its copy
in, on the thread that stages one batch ahead of the device loop, mean
over the window's batches (host clock). The copy that pin_stage_ms reads
in the trace, kept in view where it runs off the window's thread; a
program that stages on the loop's thread has no such span and reads
None."""

from benchmark_torch.spans import mean_ms, window


def read(run):
    return mean_ms(window(run, "executor.pin"))

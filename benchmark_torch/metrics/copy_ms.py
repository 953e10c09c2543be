"""copy_ms (engine.executor copies): device time of the host <-> device
copies (Memcpy HtoD and DtoH), per batch of the traced window."""

from benchmark_torch.readers import per_batch_ms
from benchmark_torch.trace import copy_kind


def read(run):
    if run.trace is None:
        return None
    ms, count = run.trace.device_ms(
        lambda n: copy_kind(n) in ("HtoD", "DtoH"))
    return per_batch_ms(run, ms) if count else None

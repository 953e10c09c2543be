"""peer_copy_ms (parallel.sharding): device time of the copies between
cards (Memcpy PtoP, and DtoD where CUPTI names a peer copy so), per batch
of the traced window."""

from benchmark_torch.readers import per_batch_ms
from benchmark_torch.trace import copy_kind


def read(run):
    if run.trace is None or len(run.cards) < 2:
        return None
    ms, count = run.trace.device_ms(lambda n: copy_kind(n) in ("PtoP", "DtoD"))
    return per_batch_ms(run, ms) if count else None

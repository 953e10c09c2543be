"""pin_ms.split4 (engine.executor): pin_ms in the split cell, where each
batch's pageable -> pinned copy is four 8K 10-bit frames (398 MB) and the
first card takes the whole batch in."""

from benchmark_torch.spec import metric_reader

read = metric_reader("pin_ms")

"""job_start_p90_ms.fps (tasks.runner): job_start_p90_ms, read per layer
in a cell whose job starts spread too widely from run to run to bound end
to end; there a job's parse and first batch count in its fps."""

from benchmark_torch.spec import metric_reader

read = metric_reader("job_start_p90_ms")

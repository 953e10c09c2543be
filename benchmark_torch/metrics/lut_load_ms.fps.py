"""lut_load_ms.fps (tasks.runner): lut_load_ms in a cell that bounds fps
and not job_start_p90_ms; its parses on cache misses hold up the window's
frames."""

from benchmark_torch.spec import metric_reader

read = metric_reader("lut_load_ms")

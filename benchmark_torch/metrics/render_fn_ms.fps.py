"""render_fn_ms.fps (ops.render): render_fn_ms in a cell that bounds fps
and not job_start_p90_ms."""

from benchmark_torch.spec import metric_reader

read = metric_reader("render_fn_ms")

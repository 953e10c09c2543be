"""kernel_b_roofline_pct.split4 (ops.fused420): kernel_b_roofline_pct in
the split cell: kernel B's launches on every card, each over its card's
chunk of the batch (``frames_per_launch``: one 8K 10-bit frame)."""

from benchmark_torch.spec import metric_reader

read = metric_reader("kernel_b_roofline_pct")

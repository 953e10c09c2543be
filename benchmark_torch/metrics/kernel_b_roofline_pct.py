"""kernel_b_roofline_pct (ops.fused420): kernel B's least time
(roofline.kernel_b_bound at the frames a launch covers) over its traced
time, in percent."""

from benchmark_torch import roofline
from benchmark_torch.readers import frames_per_launch, is_kernel_b, \
    roofline_pct


def read(run):
    h, w = run.shape
    ms, _ = roofline.kernel_b_bound(frames_per_launch(run), h, w,
                                    run.cell.config["pipeline"], run.lut_size)
    return roofline_pct(run, is_kernel_b, ms)

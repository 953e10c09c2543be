"""kernel_a_roofline_pct (ops.lut3d): kernel A's least time
(roofline.kernel_a_bound on a batch's planar RGB) over its traced time,
in percent."""

from benchmark_torch import roofline
from benchmark_torch.readers import frames_per_launch, is_kernel_a, \
    roofline_pct


def read(run):
    h, w = run.shape
    ms, _ = roofline.kernel_a_bound(frames_per_launch(run), h, w,
                                    run.lut_size)
    return roofline_pct(run, is_kernel_a, ms)

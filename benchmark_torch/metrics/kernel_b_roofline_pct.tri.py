"""kernel_b_roofline_pct.tri (ops.fused420): kernel B's trilinear
instantiation, its least time (trilinear.kernel_b_trilinear_bound at the
frames a launch covers) over the traced time of the launches that
trilinear.is_kernel_b_trilinear accepts, in percent."""

from benchmark_torch.readers import frames_per_launch, roofline_pct
from benchmark_torch.trilinear import is_kernel_b_trilinear, \
    kernel_b_trilinear_bound


def read(run):
    h, w = run.shape
    ms, _ = kernel_b_trilinear_bound(frames_per_launch(run), h, w,
                                     run.cell.config["pipeline"],
                                     run.lut_size)
    return roofline_pct(run, is_kernel_b_trilinear, ms)

"""pixel_ops_ms (ops.pixel): device time of the render's kernels that are
not kernels A, B or C, the resample's products or copies (the plain
layout's torch ops), per batch of the traced window."""

from benchmark_torch.readers import is_gemm, is_kernel, is_kernel_a, \
    is_kernel_b, is_kernel_c, per_batch_ms


def read(run):
    if run.trace is None:
        return None
    ms, count = run.trace.device_ms(
        lambda n: is_kernel(n) and not (is_kernel_a(n) or is_kernel_b(n)
                                        or is_kernel_c(n) or is_gemm(n)))
    return per_batch_ms(run, ms) if count else None

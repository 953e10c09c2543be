"""ops: the per-frame pixel path in PyTorch, with the CUDA kernels
(csrc/) behind ops.lut3d (kernels A and C), ops.fused420 (kernel B) and
ops.resample (the banded resample)."""

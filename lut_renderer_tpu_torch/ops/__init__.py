"""ops: the per-frame pixel path in PyTorch, with the CUDA kernels
(csrc/) behind ops.lut3d (kernel A) and ops.fused420 (kernel B)."""

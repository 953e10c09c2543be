"""lut_renderer_tpu_torch: the PyTorch + CUDA port of lut_renderer_tpu.

The render path runs on an NVIDIA Hopper card through two hand-written
CUDA kernels (csrc/): kernel A applies a 3D LUT to planar RGB, kernel B
renders a whole YUV frame to YUV in one pass. Every kernel wrapper keeps a
plain PyTorch version beside it, which runs on CPU tensors.

The layout mirrors the JAX package, whose backend-free layers (colorcore,
hostio, models, plan, app helpers) the port imports rather than copies:

  device    explicit device choice; "cuda" without a card raises
  ops       pixel ops, LutTable, kernels A and B, render dispatch
  engine    decode -> device render -> encode stage executor
  tasks     task runner and queue over the port's executor
  app       CLI: render, doctor

This package imports torch and never jax.
"""

__version__ = "0.1.0"

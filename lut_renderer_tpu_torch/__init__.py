"""lut_renderer_tpu_torch: the PyTorch + CUDA port of lut_renderer_tpu.

The render path runs on an NVIDIA Hopper card through hand-written CUDA
kernels (csrc/): kernel A applies a 3D LUT to planar RGB, kernel C applies
a big LUT stored as a coarse table plus an int8 residual, kernel B
renders a whole YUV frame to YUV in one pass with either table, and the
banded resample kernel resizes the RGB planes of a resize. Every
kernel wrapper keeps a plain PyTorch version beside it, which runs on CPU
tensors.

The layout mirrors the JAX package. The port keeps its own copies of the
JAX package's backend-free layers, at the same paths, verbatim apart from
imports (tests/test_torch_hostside.py holds them to the originals):

  colorcore .cube parsing, colour matrices, dither, reference interp
  models    ProcessingParams, Task, VideoInfo
  plan      the render policy and the stage pipeline
  hostio    probe, decode, encode and audio over FFmpeg's shared libraries
  utils     synthetic fixture clips
  native_ext  the optional C++ helpers of native/ (cube parse, error
            diffusion)
  device    explicit device choice; "cuda" without a card raises
  ops       pixel ops, the LUT tables, kernels A, B and C, the resample,
            render dispatch
  parallel  the frame batch split across cards
  engine    decode -> device render -> encode stage executor; warm start
  tasks     task runner and queue over the port's executor
  app       CLI (the JAX CLI's 13 subcommands), serve daemon, web UI,
            TUI, and the app helpers

This package imports torch, and nothing of jax or of the JAX package.
"""

__version__ = "0.1.0"

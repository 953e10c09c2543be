// Kernel C: planar float32 RGB -> the coarse + residual evaluation of a big
// 3D LUT (odd N >= 49) at a coarse2* tier, planar RGB out.
//
// Replaces ops/lut3d.py::_run_coarse2_fused of the JAX package (its
// pallas_call over _fused_kernel_coarse2, lut3d.py:771 / :842). There the
// interpolation of L = U(C) + R runs as two one-hot MXU contractions: the
// fine int8 residual, and the coarse table under the fine taps remapped
// onto the (N+1)/2 grid. Here, for each pixel:
//
//   residual  the residual interp's corners of the int8 table times the
//             scale of the corner's r index and channel (in shared
//             memory), in the order of interp_cell;
//   coarse    the interp's 8 fine-corner weights folded through the
//             per-axis 2x2 remap onto one 8-corner coarse cell, then its
//             8 f32 corners summed in a fixed order. The top-edge coarse
//             line M is clamped to M - 1 (lut_interp.cuh, coarse_term).
//
// Bound on Hopper: scattered table loads, the coarse cell's 8 float4
// corners and 1-8 int8 residual corners a pixel, beside 24 B/px of
// device-memory traffic (3 f32 planes in, 3 out). The tables, 13 MB at
// 129^3, sit in the 50 MB L2. The kernel is
// planar_lut.cuh's skeleton; this file picks one instantiation per
// (interp, residual interp) pair: the render's own, or trilinear under a
// _tri tier.
#include "planar_lut.cuh"

namespace {

template <int INTERP, int RESID>
int run(const Coarse2Params* p, void* stream) {
  return launch<Coarse2Params, INTERP, RESID, kFull>(p, stream);
}

}  // namespace

extern "C" __attribute__((visibility("default"))) int coarse2_launch(
    const Coarse2Params* p, void* stream) {
  const bool tri = p->resid_interp == lutk::kTrilinear;
  switch (p->interp) {
    case lutk::kNearest:
      return tri ? run<lutk::kNearest, lutk::kTrilinear>(p, stream)
                 : run<lutk::kNearest, lutk::kNearest>(p, stream);
    case lutk::kTrilinear:
      return run<lutk::kTrilinear, lutk::kTrilinear>(p, stream);
    case lutk::kPyramid:
      return tri ? run<lutk::kPyramid, lutk::kTrilinear>(p, stream)
                 : run<lutk::kPyramid, lutk::kPyramid>(p, stream);
    case lutk::kPrism:
      return tri ? run<lutk::kPrism, lutk::kTrilinear>(p, stream)
                 : run<lutk::kPrism, lutk::kPrism>(p, stream);
    default:  // tetrahedral, and every unknown code
      return tri ? run<lutk::kTetrahedral, lutk::kTrilinear>(p, stream)
                 : run<lutk::kTetrahedral, lutk::kTetrahedral>(p, stream);
  }
}

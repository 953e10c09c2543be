// Kernel A: planar float32 RGB -> 3D-LUT-interpolated planar RGB, the
// exact table.
//
// Replaces ops/lut3d.py::_run_fused of the JAX package, both of its
// pallas_call launches (the int8 tiers, _fused_kernel_int8, and the bf16
// tiers, _fused_kernel_bf16). Those are one-hot MXU matmuls only because TPU
// gathers run at scalar speed. Here each pixel fetches its cell's corners
// directly from the (N, N, N, 4) f32 table, so the result is exact in f32
// (no quantised table tier) and the work per pixel does not depend on N.
//
// Bound on Hopper: L2 gathers, 1 (nearest) to 8 (trilinear) 16-byte corner
// loads a pixel, beside 24 B/px of device-memory traffic (3 planes in, 3
// out). The table is 575 KB at 33^3 and 34 MB at 129^3, so it stays
// L2-resident (50 MB) at every supported size. The kernel is
// planar_lut.cuh's skeleton; this file picks one instantiation per interp.
#include "planar_lut.cuh"

namespace {

template <int INTERP>
int run(const Lut3dParams* p, void* stream) {
  return launch<Lut3dParams, INTERP, INTERP, kFull>(p, stream);
}

}  // namespace

extern "C" __attribute__((visibility("default"))) int lut3d_launch(
    const Lut3dParams* p, void* stream) {
  switch (p->interp) {
    case lutk::kNearest:
      return run<lutk::kNearest>(p, stream);
    case lutk::kTrilinear:
      return run<lutk::kTrilinear>(p, stream);
    case lutk::kPyramid:
      return run<lutk::kPyramid>(p, stream);
    case lutk::kPrism:
      return run<lutk::kPrism>(p, stream);
    default:  // tetrahedral, and every unknown code
      return run<lutk::kTetrahedral>(p, stream);
  }
}

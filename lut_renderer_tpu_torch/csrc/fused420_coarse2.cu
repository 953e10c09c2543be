// Kernel B on the coarse + residual decomposition of a big LUT (a coarse2*
// tier; fused420.cuh, lut_interp.cuh's Coarse2Args). Built beside
// fused420.cu, so that the two table kinds compile in parallel.
#include "fused420.cuh"

extern "C" __attribute__((visibility("default"))) int fused420_coarse2_launch(
    const Fused420Params* p, void* stream) {
  return launch<lutk::Coarse2Args>(p, stream);
}

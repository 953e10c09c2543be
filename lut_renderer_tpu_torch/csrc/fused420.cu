// Kernel B on the exact f32 table (fused420.cuh). The coarse2
// instantiation is fused420_coarse2.cu, built beside this file.
#include "fused420.cuh"

extern "C" __attribute__((visibility("default"))) int fused420_launch(
    const Fused420Params* p, void* stream) {
  return launch<lutk::LutArgs>(p, stream);
}

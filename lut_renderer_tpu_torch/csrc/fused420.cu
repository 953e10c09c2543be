// Kernel B on the exact f32 table, and the stage probe's io and color
// builds of it (fused420.cuh). The coarse2 instantiation is
// fused420_coarse2.cu, built beside this file.
#include "fused420.cuh"

namespace {

// io and color read no table: one instantiation each per geometry
template <int STAGE>
int launch_stage(const Fused420Params* p, void* stream) {
  if (p->units <= 0) return 0;
  return launch_geometry<lutk::LutArgs, lutk::kTetrahedral, STAGE>(
      p, (cudaStream_t)stream);
}

}  // namespace

extern "C" __attribute__((visibility("default"))) int fused420_launch(
    const Fused420Params* p, void* stream) {
  return launch<lutk::LutArgs>(p, stream);
}

extern "C" __attribute__((visibility("default"))) int fused420_io_launch(
    const Fused420Params* p, void* stream) {
  return launch_stage<kIo>(p, stream);
}

extern "C" __attribute__((visibility("default"))) int fused420_color_launch(
    const Fused420Params* p, void* stream) {
  return launch_stage<kColor>(p, stream);
}

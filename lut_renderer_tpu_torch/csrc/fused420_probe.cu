// The stage probe's io and color builds of kernel B (fused420.cuh) on the
// exact table. Never on a render path: the probes build this file into a
// library of their own (probes/harness.probe_library), beside
// planar_probe.cu. It is a translation unit apart from planar_probe.cu
// because fused420.cuh and planar_lut.cuh each declare a Stage enum.
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

extern "C" __attribute__((visibility("default"))) int fused420_io_launch(
    const Fused420Params* p, void* stream) {
  return launch_stage<kIo>(p, stream);
}

extern "C" __attribute__((visibility("default"))) int fused420_color_launch(
    const Fused420Params* p, void* stream) {
  return launch_stage<kColor>(p, stream);
}

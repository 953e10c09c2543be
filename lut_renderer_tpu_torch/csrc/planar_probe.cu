// The stage probe's builds of kernels A and C (planar_lut.cuh), all
// tetrahedral: io loads and stores the planes, weights adds the domain
// map, the cells and the sums over stand-in corners, coarse and resid run
// one of kernel C's terms with its loads. Never on a render path: the
// probes build this file into a library of their own
// (probes/harness.probe_library), beside fused420_probe.cu.
#include "planar_lut.cuh"

#define PLANAR_STAGE_ENTRY(name, Params, STAGE)                          \
  extern "C" __attribute__((visibility("default"))) int name(            \
      const Params* p, void* stream) {                                   \
    return launch<Params, lutk::kTetrahedral, lutk::kTetrahedral, STAGE>( \
        p, stream);                                                      \
  }

PLANAR_STAGE_ENTRY(lut3d_io_launch, Lut3dParams, kIo)
PLANAR_STAGE_ENTRY(lut3d_weights_launch, Lut3dParams, kWeights)
PLANAR_STAGE_ENTRY(coarse2_io_launch, Coarse2Params, kIo)
PLANAR_STAGE_ENTRY(coarse2_weights_launch, Coarse2Params, kWeights)
PLANAR_STAGE_ENTRY(coarse2_coarse_launch, Coarse2Params, kCoarse)
PLANAR_STAGE_ENTRY(coarse2_resid_launch, Coarse2Params, kResid)

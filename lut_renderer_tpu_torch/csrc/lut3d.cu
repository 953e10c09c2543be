// Kernel A: planar float32 RGB -> 3D-LUT-interpolated planar RGB.
//
// Replaces ops/lut3d.py::_run_fused of the JAX package, both of its
// pallas_call launches (the int8 tiers, _fused_kernel_int8, and the bf16
// tiers, _fused_kernel_bf16). Those are one-hot MXU matmuls only because TPU
// gathers run at scalar speed. Here each thread fetches its cell's corners
// directly from the (N, N, N, 4) f32 table, so the result is exact in f32
// (no quantised table tier) and the work per pixel does not depend on N.
//
// Bound on Hopper: L2 gathers, 4 (tetrahedral, prism) to 8 (trilinear)
// 16-byte corner loads per pixel, plus 24 B/px of device-memory traffic
// (3 planes in, 3 out). The table is 575 KB at 33^3 and 34 MB at 129^3, so
// it stays L2-resident (50 MB) at every supported size; loads go through
// __ldg so that the read-only path serves repeated corners of neighbouring
// pixels.
#include <cuda_runtime.h>

#include "lut_interp.cuh"

// Outside the anonymous namespace: a parameter type with internal linkage
// would give the extern "C" entry point internal linkage too.
struct Lut3dParams {
  const float* r;
  const float* g;
  const float* b;
  float* ro;
  float* go;
  float* bo;
  const float4* table;
  long long npix;
  int n;
  int interp;
  float dmin[3];
  float dmax[3];
};

namespace {

__global__ void lut3d_kernel(Lut3dParams p) {
  lutk::LutArgs L;
  L.table = p.table;
  L.n = p.n;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    L.dmin[i] = p.dmin[i];
    L.dmax[i] = p.dmax[i];
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < p.npix; i += stride) {
    float4 o = lutk::lut_apply(L, p.interp, __ldg(p.r + i), __ldg(p.g + i),
                               __ldg(p.b + i));
    p.ro[i] = o.x;
    p.go[i] = o.y;
    p.bo[i] = o.z;
  }
}

}  // namespace

extern "C" __attribute__((visibility("default"))) int lut3d_launch(
    const Lut3dParams* p, void* stream) {
  if (p->npix <= 0) return 0;
  const int block = 256;
  long long blocks = (p->npix + block - 1) / block;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;  // grid-stride beyond this
  lut3d_kernel<<<(unsigned)blocks, block, 0, (cudaStream_t)stream>>>(*p);
  return (int)cudaGetLastError();
}

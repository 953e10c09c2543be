// Kernel C: planar float32 RGB -> the coarse + residual evaluation of a big
// 3D LUT (odd N >= 49) at a coarse2* tier, planar RGB out.
//
// Replaces ops/lut3d.py::_run_coarse2_fused of the JAX package (its
// pallas_call over _fused_kernel_coarse2, lut3d.py:771 / :842). There the
// interpolation of L = U(C) + R runs as two one-hot MXU contractions: the
// fine int8 residual, and the coarse table under the fine taps remapped
// onto the (N+1)/2 grid. Here one thread per pixel, as in kernel A:
//
//   residual  the interp's corners of the (N, N, N, 4) int8 table (one
//             4-byte char4 load each) times the scale of the corner's
//             r index and channel (one float4 load for each of the cell's
//             two r lines), in the order of interp_cell;
//   coarse    the interp's 8 fine-corner weights folded through the
//             per-axis 2x2 remap onto one 8-corner coarse cell (the coarse
//             cell index p / 2 is the same for every pass of an interp),
//             then 8 float4 loads from the (M, M, M, 4) f32 table summed
//             in a fixed order. The top-edge coarse line M is clamped to
//             M - 1 (lut_interp.cuh, coarse_term).
//
// Bound on Hopper: L2 gathers, 8 coarse + 4-8 residual corner loads per
// pixel, plus 24 B/px of device-memory traffic (3 f32 planes in, 3 out).
// The tables are smaller than kernel A's f32 table at the same N: 1.7 MB
// (0.57 MB coarse + 1.10 MB residual) against 4.4 MB at 65^3, 5.5 MB
// against 14.6 MB at 97^3, 13.0 MB against 34.4 MB at 129^3, so they sit in
// the 50 MB L2 with room to spare; the cost is more loads per pixel.
#include <cuda_runtime.h>

#include "lut_interp.cuh"

// Outside the anonymous namespace: a parameter type with internal linkage
// would give the extern "C" entry point internal linkage too.
struct Coarse2Params {
  const float* r;
  const float* g;
  const float* b;
  float* ro;
  float* go;
  float* bo;
  const float4* coarse;  // (m, m, m, 4) f32
  const char4* resid;    // (n, n, n, 4) int8
  const float4* rscale;  // (n, 4) f32
  long long npix;
  int n;
  int m;
  int interp;
  int resid_interp;
  float dmin[3];
  float dmax[3];
};

namespace {

__global__ void coarse2_kernel(Coarse2Params p) {
  lutk::Coarse2Args C;
  C.coarse = p.coarse;
  C.resid = p.resid;
  C.rscale = p.rscale;
  C.n = p.n;
  C.m = p.m;
  C.resid_interp = p.resid_interp;
  lutk::set_domain(C, p.dmin, p.dmax);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < p.npix; i += stride) {
    float4 o = lutk::lut_apply(C, p.interp, __ldg(p.r + i), __ldg(p.g + i),
                               __ldg(p.b + i));
    p.ro[i] = o.x;
    p.go[i] = o.y;
    p.bo[i] = o.z;
  }
}

}  // namespace

extern "C" __attribute__((visibility("default"))) int coarse2_launch(
    const Coarse2Params* p, void* stream) {
  if (p->npix <= 0) return 0;
  const int block = 256;
  long long blocks = (p->npix + block - 1) / block;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;  // grid-stride beyond this
  coarse2_kernel<<<(unsigned)blocks, block, 0, (cudaStream_t)stream>>>(*p);
  return (int)cudaGetLastError();
}

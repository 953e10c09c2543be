// Kernel B: the whole frame YUV -> YUV in one pass, integer planes in and
// quantised integer planes out.
//
// Replaces ops/fused420.py::render_fused420 of the JAX package (its
// pallas_call over _make_kernel). Per luma pixel, as there: integer -> f32,
// range normalisation with the reference's 8-bit intermediate requantise,
// YUV -> RGB, the 3D LUT (lut_interp.cuh), RGB -> YUV, dither and quantise.
//
// The LUT step is a template on the table kind, as the JAX kernel's
// _acc_from_rgb branches on the tier: lutk::LutArgs (the exact f32 table,
// entry point fused420_launch) or lutk::Coarse2Args (the coarse + residual
// decomposition of a big LUT at a coarse2* tier, kernel C's device
// function, entry point fused420_coarse2_launch). Both instantiations come
// from this one source.
// Unlike the TPU kernel, which hands four f32 chroma phase planes to XLA for
// the downsample, one thread here owns one OUTPUT chroma site: a 2x2 luma
// quad for 4:2:0 out, a 1x2 pair for 4:2:2, one pixel for 4:4:4. It box-
// downsamples its own chroma in registers with the reference's add grouping
// (pixel.chroma_downsample_420/422) and writes the final planes, so nothing
// but the integer planes touches device memory.
//
// Bound on Hopper: the table gathers (4-8 16-byte L2 loads per luma pixel
// for the exact table; 8 coarse + 4-8 char4 residual loads for coarse2),
// then the f32 arithmetic (IEEE divisions of colorcore.matrices included);
// device-memory traffic is only 3 B/px for 8-bit 4:2:0 in and out. Matrix
// and range constants arrive as f32, computed in double on the host exactly
// as colorcore.matrices does before its f32 arithmetic.
//
// Dither offsets are indexed by the absolute row and column of each output
// plane: the 16x16 Bayer tile, or the murmur3-finalizer position hash of
// colorcore.dither.hash_noise_offsets (plane seeds 1/2/3 for y/u/v), in
// native uint32 arithmetic.
#include <cuda_runtime.h>
#include <stdint.h>

#include "lut_interp.cuh"

// Outside the anonymous namespace: a parameter type with internal linkage
// would give the extern "C" entry point internal linkage too.
struct Fused420Params {
  const void* y;  // (B, H, W) uint8 or uint16
  const void* u;  // (B, H >> in_sy, W >> in_sx)
  const void* v;
  void* yo;  // (B, H, W) uint8 or uint16
  void* uo;  // (B, H >> out_sy, W >> out_sx)
  void* vo;
  const float4* table;  // (n, n, n, 4) f32, exact table
  const float* bayer;   // (16, 16) f32 offsets, for ordered dither
  const float4* coarse;  // (m, m, m, 4) f32, coarse2 table
  const char4* resid;    // (n, n, n, 4) int8, coarse2 residual
  const float4* rscale;  // (n, 4) f32, residual scale of (r, channel)
  int batch;
  int height;
  int width;
  int in16;   // input planes are uint16
  int out16;  // output planes are uint16
  int in_sx;  // input chroma subsampling shifts (420: 1,1; 422: 1,0)
  int in_sy;
  int out_sx;
  int out_sy;
  int n;
  int m;  // coarse2 grid, (n + 1) / 2
  int interp;
  int resid_interp;  // coarse2 residual interp (trilinear for _tri)
  int normalize;  // in_full_range != work_full_range
  int requant;    // requantise after the normalisation
  int dither;
  float dmin[3];
  float dmax[3];
  // range normalisation: y' = (y - ysub) * ymul + yadd,
  //                      c' = (c - cmid) * cmul + cmid
  float norm_ysub;
  float norm_ymul;
  float norm_yadd;
  float norm_cmid;
  float norm_cmul;
  float maxv_in;
  float maxv_out;
  // YUV -> RGB at the input matrix/depth/work range
  float in_yoff;
  float in_yscale;
  float in_cmid;
  float in_cscale;
  float in_crv;
  float in_cbu;
  float in_gv;  // kr * crv / kg
  float in_gu;  // kb * cbu / kg
  // RGB -> YUV at the output matrix/depth/range
  float out_kr;
  float out_kg;
  float out_kb;
  float out_crv;
  float out_cbu;
  float out_yoff;
  float out_yscale;
  float out_cmid;
  float out_cscale;
};

namespace {

enum Dither : int { kNone = 0, kOrdered = 1, kRandom = 2 };

__device__ __forceinline__ float load_px(const void* p, long long i,
                                         int is16) {
  return is16 ? (float)__ldg((const unsigned short*)p + i)
              : (float)__ldg((const unsigned char*)p + i);
}

__device__ __forceinline__ void store_px(void* p, long long i, int is16,
                                         float q) {
  if (is16) {
    ((unsigned short*)p)[i] = (unsigned short)(int)q;
  } else {
    ((unsigned char*)p)[i] = (unsigned char)(int)q;
  }
}

// colorcore.dither.hash_noise_offsets at (row, col) of one plane
__device__ __forceinline__ float hash_offset(uint32_t row, uint32_t col,
                                             uint32_t seed) {
  uint32_t x = (row * 0x9E3779B1u) ^ (col * 0x85EBCA77u) ^ (seed * 0xC2B2AE3Du);
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return (float)(x >> 8) * 5.9604644775390625e-08f - 0.5f;  // 2^-24
}

// ops/pixel.quantize_plane for one sample at (row, col) of its plane
__device__ __forceinline__ float quantize(const Fused420Params& p, float x,
                                          int row, int col, uint32_t seed) {
  if (p.dither == kOrdered) {
    x = x + __ldg(p.bayer + (row & 15) * 16 + (col & 15));
  } else if (p.dither == kRandom) {
    x = x + hash_offset((uint32_t)row, (uint32_t)col, seed);
  }
  return fminf(fmaxf(floorf(x + 0.5f), 0.0f), p.maxv_out);
}

__device__ __forceinline__ void table_args(const Fused420Params& p,
                                           lutk::LutArgs& L) {
  L.table = p.table;
  L.n = p.n;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    L.dmin[i] = p.dmin[i];
    L.dmax[i] = p.dmax[i];
  }
}

__device__ __forceinline__ void table_args(const Fused420Params& p,
                                           lutk::Coarse2Args& C) {
  C.coarse = p.coarse;
  C.resid = p.resid;
  C.rscale = p.rscale;
  C.n = p.n;
  C.m = p.m;
  C.resid_interp = p.resid_interp;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    C.dmin[i] = p.dmin[i];
    C.dmax[i] = p.dmax[i];
  }
}

template <int OSY, int OSX, class TableArgs>
__global__ void fused420_kernel(Fused420Params p) {
  TableArgs L;
  table_args(p, L);
  const int H = p.height, W = p.width;
  const int hc_in = H >> p.in_sy, wc_in = W >> p.in_sx;
  const int hc_out = H >> OSY, wc_out = W >> OSX;
  const long long sites = (long long)p.batch * hc_out * wc_out;
  const long long stride = (long long)gridDim.x * blockDim.x;

  for (long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       s < sites; s += stride) {
    const int j = (int)(s % wc_out);
    const long long t = s / wc_out;
    const int i = (int)(t % hc_out);
    const long long bb = t / hc_out;
    const long long ybase = bb * H * W;
    const long long cbase_in = bb * hc_in * wc_in;

    float uo[1 << OSY][1 << OSX], vo[1 << OSY][1 << OSX];
#pragma unroll
    for (int dy = 0; dy < (1 << OSY); ++dy) {
#pragma unroll
      for (int dx = 0; dx < (1 << OSX); ++dx) {
        const int row = (i << OSY) + dy, col = (j << OSX) + dx;
        const long long ci =
            cbase_in + (long long)(row >> p.in_sy) * wc_in + (col >> p.in_sx);
        float yf = load_px(p.y, ybase + (long long)row * W + col, p.in16);
        float uf = load_px(p.u, ci, p.in16);
        float vf = load_px(p.v, ci, p.in16);

        if (p.normalize) {  // ops/pixel.range_normalize
          yf = (yf - p.norm_ysub) * p.norm_ymul + p.norm_yadd;
          uf = (uf - p.norm_cmid) * p.norm_cmul + p.norm_cmid;
          vf = (vf - p.norm_cmid) * p.norm_cmul + p.norm_cmid;
          if (p.requant) {
            yf = fminf(fmaxf(floorf(yf + 0.5f), 0.0f), p.maxv_in);
            uf = fminf(fmaxf(floorf(uf + 0.5f), 0.0f), p.maxv_in);
            vf = fminf(fmaxf(floorf(vf + 0.5f), 0.0f), p.maxv_in);
          }
        }

        // colorcore.matrices.yuv_to_rgb_planes
        const float yn = (yf - p.in_yoff) / p.in_yscale;
        const float un = (uf - p.in_cmid) / p.in_cscale;
        const float vn = (vf - p.in_cmid) / p.in_cscale;
        const float r = lutk::clip01(yn + p.in_crv * vn);
        const float b = lutk::clip01(yn + p.in_cbu * un);
        const float g = lutk::clip01(yn - p.in_gv * vn - p.in_gu * un);

        const float4 o = lutk::lut_apply(L, p.interp, r, g, b);

        // colorcore.matrices.rgb_to_yuv_planes
        const float yo_n = p.out_kr * o.x + p.out_kg * o.y + p.out_kb * o.z;
        const float vo_n = (o.x - yo_n) / p.out_crv;
        const float uo_n = (o.z - yo_n) / p.out_cbu;
        const float yv = yo_n * p.out_yscale + p.out_yoff;
        uo[dy][dx] = uo_n * p.out_cscale + p.out_cmid;
        vo[dy][dx] = vo_n * p.out_cscale + p.out_cmid;

        store_px(p.yo, ybase + (long long)row * W + col, p.out16,
                 quantize(p, yv, row, col, 1u));
      }
    }

    float uc, vc;
    if constexpr (OSY == 1 && OSX == 1) {
      // pixel.chroma_downsample_420: lane pairs, then rows
      uc = ((uo[0][0] + uo[0][1]) + (uo[1][0] + uo[1][1])) * 0.25f;
      vc = ((vo[0][0] + vo[0][1]) + (vo[1][0] + vo[1][1])) * 0.25f;
    } else if constexpr (OSX == 1) {  // pixel.chroma_downsample_422
      uc = (uo[0][0] + uo[0][1]) * 0.5f;
      vc = (vo[0][0] + vo[0][1]) * 0.5f;
    } else {
      uc = uo[0][0];
      vc = vo[0][0];
    }
    const long long co = bb * hc_out * wc_out + (long long)i * wc_out + j;
    store_px(p.uo, co, p.out16, quantize(p, uc, i, j, 2u));
    store_px(p.vo, co, p.out16, quantize(p, vc, i, j, 3u));
  }
}

template <class TableArgs>
int launch(const Fused420Params* p, void* stream) {
  const long long sites = (long long)p->batch * (p->height >> p->out_sy) *
                          (p->width >> p->out_sx);
  if (sites <= 0) return 0;
  const int block = 256;
  long long blocks = (sites + block - 1) / block;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;  // grid-stride beyond this
  cudaStream_t st = (cudaStream_t)stream;
  if (p->out_sy && p->out_sx) {
    fused420_kernel<1, 1, TableArgs><<<(unsigned)blocks, block, 0, st>>>(*p);
  } else if (p->out_sx) {
    fused420_kernel<0, 1, TableArgs><<<(unsigned)blocks, block, 0, st>>>(*p);
  } else if (!p->out_sy) {
    fused420_kernel<0, 0, TableArgs><<<(unsigned)blocks, block, 0, st>>>(*p);
  } else {
    return (int)cudaErrorInvalidValue;  // 4:4:0 output is not a geometry
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" __attribute__((visibility("default"))) int fused420_launch(
    const Fused420Params* p, void* stream) {
  return launch<lutk::LutArgs>(p, stream);
}

extern "C" __attribute__((visibility("default"))) int fused420_coarse2_launch(
    const Fused420Params* p, void* stream) {
  return launch<lutk::Coarse2Args>(p, stream);
}

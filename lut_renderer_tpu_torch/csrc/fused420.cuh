// Kernel B: the whole frame YUV -> YUV in one pass, integer planes in and
// quantised integer planes out.
//
// Replaces ops/fused420.py::render_fused420 of the JAX package (its
// pallas_call over _make_kernel). Per luma pixel, as there: integer -> f32,
// range normalisation with the reference's 8-bit intermediate requantise,
// YUV -> RGB, the 3D LUT (lut_interp.cuh), RGB -> YUV, dither and quantise.
// Unlike the TPU kernel, which hands four f32 chroma phase planes to XLA for
// the downsample, the chroma is box-downsampled in registers with the
// reference's add grouping (pixel.chroma_downsample_420/422), so nothing
// but the integer planes touches device memory.
//
// The kernel is a template on the output geometry (OSY, OSX), the table
// kind, the interpolation and the stage. Two translation units instantiate
// its production stage, so that nvcc builds them side by side: fused420.cu
// the exact f32 table (lutk::LutArgs, entry fused420_launch),
// fused420_coarse2.cu the coarse + residual decomposition of a big LUT at
// a coarse2* tier (lutk::Coarse2Args, entry fused420_coarse2_launch). The
// stage probe's io and color builds are fused420_probe.cu, in the probes'
// own library (entries fused420_io_launch, fused420_color_launch).
//
// What bounds it on Hopper: not bytes (3 B/px for 8-bit 4:2:0 in and out)
// but the instruction stream and the table gathers. The design:
//   * work units of 8 luma columns x (1 << OSY) rows (2 columns on the
//     scalar path), the output chroma sites under them owned by one
//     thread; a persistent grid of blocks walks the units with 32-bit
//     indices (one 64-bit base per plane of a frame). Planes load and store
//     as 4- to 16-byte vectors, codes kept as 16-bit lanes of 32-bit
//     words; widths that are not a multiple of 8, and planes that are not
//     16-byte aligned, take the scalar path (ops/fused420.launch_geometry
//     decides). The unit's column pairs run in a loop that is not
//     unrolled, which keeps the code, the registers and the build small;
//   * the per-code part of the input (range normalisation, requantise and
//     the three divisions of YUV -> RGB) is a table of each code value in
//     shared memory, computed by each block with the very same f32
//     operations; a code past the table (an out-of-range 16-bit sample)
//     takes the same formula inline;
//   * the interpolation is a template parameter and the tetrahedral case is
//     selected, not branched (lut_interp.cuh); the [0, 1] domain skips the
//     domain division; floors and int8 dequantisation avoid the conversion
//     pipe;
//   * the two divisions of RGB -> YUV by matrix constants are a product and
//     two FMA corrections from the rounded reciprocal (Divisor), bit-equal
//     to the IEEE division without its reciprocal instruction and its
//     slow-path branch; a pair's dither offsets are taken before its pixels
//     (PairDither), so that no branch splits their arithmetic;
//   * coarse2: the residual scale sits in shared memory and is read once for
//     each of a cell's two r lines.
// Every f32 operation and its order are those of the plain version; the
// library is built with -fmad=false.
//
// Dither offsets are indexed by the absolute row and column of each output
// plane: the 16x16 Bayer tile (in shared memory), or the murmur3-finalizer
// position hash of colorcore.dither.hash_noise_offsets (plane seeds 1/2/3
// for y/u/v), in native uint32 arithmetic.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "lut_interp.cuh"

// Outside the anonymous namespace: a parameter type with internal linkage
// would give the extern "C" entry points internal linkage too.
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
  // the launch geometry (ops/fused420.launch_geometry)
  int units;          // work units, B * (H >> out_sy) * units_per_row
  int units_per_row;  // ceil(W / unit columns)
  int vec;  // vector I/O and units of kVecCols columns, else 2 columns
};

// Internal linkage: each translation unit that includes this header
// instantiates the kernels it launches.
namespace {

constexpr int kVecCols = 8;  // luma columns of a unit on the vector path
constexpr int kThreads = 256;
constexpr int kMaxCodes = 1024;  // per-code tables cover 8- and 10-bit codes
constexpr int kMaxN = 129;       // colorcore.cube.MAX_LUT_SIZE

enum Dither : int { kNone = 0, kOrdered = 1, kRandom = 2 };
enum Stage : int { kIo = 0, kColor = 1, kFull = 2 };

// kVecCols codes of one row as 16-bit lanes: lane c in word c / 2
struct Lanes {
  uint32_t w[4];
};

__device__ __forceinline__ int load1(const void* p, int i, int is16) {
  return is16 ? __ldg((const unsigned short*)p + i)
              : __ldg((const unsigned char*)p + i);
}

// 8 codes at p + i, i a multiple of 8
__device__ __forceinline__ Lanes load8(const void* p, int i, int is16) {
  Lanes r;
  if (is16) {
    const uint4 v = __ldg((const uint4*)((const unsigned short*)p + i));
    r.w[0] = v.x;
    r.w[1] = v.y;
    r.w[2] = v.z;
    r.w[3] = v.w;
  } else {
    const uint2 v = __ldg((const uint2*)((const unsigned char*)p + i));
    r.w[0] = __byte_perm(v.x, 0, 0x4140);
    r.w[1] = __byte_perm(v.x, 0, 0x4342);
    r.w[2] = __byte_perm(v.y, 0, 0x4140);
    r.w[3] = __byte_perm(v.y, 0, 0x4342);
  }
  return r;
}

// 4 codes at p + i, i a multiple of 4, each in two lanes (2x horizontal
// chroma subsampling)
__device__ __forceinline__ Lanes load4x2(const void* p, int i, int is16) {
  Lanes r;
  if (is16) {
    const uint2 v = __ldg((const uint2*)((const unsigned short*)p + i));
    r.w[0] = __byte_perm(v.x, 0, 0x1010);
    r.w[1] = __byte_perm(v.x, 0, 0x3232);
    r.w[2] = __byte_perm(v.y, 0, 0x1010);
    r.w[3] = __byte_perm(v.y, 0, 0x3232);
  } else {
    const unsigned int v =
        __ldg((const unsigned int*)((const unsigned char*)p + i));
    r.w[0] = __byte_perm(v, 0, 0x4040);
    r.w[1] = __byte_perm(v, 0, 0x4141);
    r.w[2] = __byte_perm(v, 0, 0x4242);
    r.w[3] = __byte_perm(v, 0, 0x4343);
  }
  return r;
}

// the scalar path: the codes of columns c0 and c0 + 1 (read at column >>
// sx of the row) in lanes 0 and 1, 0 past `width`
__device__ __forceinline__ Lanes load_pair(const void* p, int row, int c0,
                                           int sx, int width, int is16) {
  Lanes r = {{(uint32_t)load1(p, row + (c0 >> sx), is16), 0u, 0u, 0u}};
  if (c0 + 1 < width) {
    r.w[0] |= (uint32_t)load1(p, row + ((c0 + 1) >> sx), is16) << 16;
  }
  return r;
}

__device__ __forceinline__ void store1(void* p, int i, int is16, int q) {
  if (is16) {
    ((unsigned short*)p)[i] = (unsigned short)q;
  } else {
    ((unsigned char*)p)[i] = (unsigned char)q;
  }
}

// N lanes (words w[0 .. N/2)) to p + i, i a multiple of N
template <int N>
__device__ __forceinline__ void store_vec(void* p, int i, int is16,
                                          const uint32_t* w) {
  if (is16) {
    if constexpr (N == 8) {
      *(uint4*)((unsigned short*)p + i) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
      *(uint2*)((unsigned short*)p + i) = make_uint2(w[0], w[1]);
    }
  } else if constexpr (N == 8) {
    *(uint2*)((unsigned char*)p + i) = make_uint2(
        __byte_perm(w[0], w[1], 0x6420), __byte_perm(w[2], w[3], 0x6420));
  } else {
    *(unsigned int*)((unsigned char*)p + i) = __byte_perm(w[0], w[1], 0x6420);
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

// min(max(floor(x + 0.5), 0), maxv) for an integer maxv: the clip first,
// which is the same for integer bounds, so that the floor takes a
// non-negative argument
__device__ __forceinline__ lutk::Floor round_clip(float x, float maxv) {
  return lutk::floor_nonneg(fminf(fmaxf(x + 0.5f, 0.0f), maxv));
}

__device__ __forceinline__ float bayer_at(const float* bayer, int row,
                                         int col) {
  return bayer[(row & 15) * 16 + (col & 15)];
}

// The dither offset of ops/pixel.quantize_plane at (row, col) of a plane;
// 0 without dither, and x + 0 quantises as x does.
__device__ __forceinline__ float dither_at(const Fused420Params& p,
                                           const float* bayer, int row,
                                           int col, uint32_t seed) {
  if (p.dither == kOrdered) return bayer_at(bayer, row, col);
  if (p.dither == kRandom) {
    return hash_offset((uint32_t)row, (uint32_t)col, seed);
  }
  return 0.0f;
}

// The same offsets for one pair of columns under one branch: y at the
// pair's rows dy and columns dx, u and v at its output chroma sites s.
// Taken before the pair's pixels where those run as one straight block,
// so that no branch splits their arithmetic.
struct PairDither {
  float y00, y01, y10, y11, u0, u1, v0, v1;
  __device__ __forceinline__ float y(int dy, int dx) const {
    return dy ? (dx ? y11 : y10) : (dx ? y01 : y00);
  }
};

template <int OSY, int OSX>
__device__ __forceinline__ PairDither pair_dither(const Fused420Params& p,
                                                  const float* bayer, int row,
                                                  int col, int crow,
                                                  int ccol) {
  PairDither o = {};
  if (p.dither == kOrdered) {
    auto at = [bayer](int r, int c) { return bayer_at(bayer, r, c); };
    o.y00 = at(row, col);
    o.y01 = at(row, col + 1);
    if constexpr (OSY == 1) {
      o.y10 = at(row + 1, col);
      o.y11 = at(row + 1, col + 1);
    }
    o.u0 = o.v0 = at(crow, ccol);
    if constexpr (OSX == 0) o.u1 = o.v1 = at(crow, ccol + 1);
  } else if (p.dither == kRandom) {
    auto at = [](int r, int c, uint32_t seed) {
      return hash_offset((uint32_t)r, (uint32_t)c, seed);
    };
    o.y00 = at(row, col, 1u);
    o.y01 = at(row, col + 1, 1u);
    if constexpr (OSY == 1) {
      o.y10 = at(row + 1, col, 1u);
      o.y11 = at(row + 1, col + 1, 1u);
    }
    o.u0 = at(crow, ccol, 2u);
    o.v0 = at(crow, ccol, 3u);
    if constexpr (OSX == 0) {
      o.u1 = at(crow, ccol + 1, 2u);
      o.v1 = at(crow, ccol + 1, 3u);
    }
  }
  return o;
}

// a / c rounded to nearest, for a divisor c of the output matrix: from
// y = 1/c rounded to nearest, q = a y and two corrections by the residual
// a - c q, which one FMA gives exactly. After the first q is within an ulp
// of a/c, and then one more correction rounds it correctly (Markstein's
// theorem), so the quotient equals the IEEE division's bit for bit while
// |a| stays clear of the subnormal range (|a| <= 2 here). No reciprocal
// instruction and no slow-path branch, which the IEEE division carries.
struct Divisor {
  float c;
  float y;
  __device__ __forceinline__ float div(float a) const {
    float q = a * y;
    q = fmaf(fmaf(-c, q, a), y, q);
    return fmaf(fmaf(-c, q, a), y, q);
  }
};

// ops/pixel.range_normalize with the requantise, then the per-code step of
// colorcore.matrices.yuv_to_rgb_planes, for one luma or chroma code value
__device__ __forceinline__ float luma_norm(const Fused420Params& p, float y) {
  if (p.normalize) {
    y = (y - p.norm_ysub) * p.norm_ymul + p.norm_yadd;
    if (p.requant) y = round_clip(y, p.maxv_in).f;
  }
  return (y - p.in_yoff) / p.in_yscale;
}

__device__ __forceinline__ float chroma_norm(const Fused420Params& p,
                                             float c) {
  if (p.normalize) {
    c = (c - p.norm_cmid) * p.norm_cmul + p.norm_cmid;
    if (p.requant) c = round_clip(c, p.maxv_in).f;
  }
  return (c - p.in_cmid) / p.in_cscale;
}

__device__ __forceinline__ void table_args(const Fused420Params& p,
                                           lutk::LutArgs& L) {
  L.table = p.table;
  L.n = p.n;
  lutk::set_domain(L, p.dmin, p.dmax);
}

__device__ __forceinline__ void table_args(const Fused420Params& p,
                                           lutk::Coarse2Args& C) {
  C.coarse = p.coarse;
  C.resid = p.resid;
  C.rscale = p.rscale;
  C.n = p.n;
  C.m = p.m;
  C.resid_interp = p.resid_interp;
  lutk::set_domain(C, p.dmin, p.dmax);
}

// The block's shared tables.
struct Shared {
  float yn[kMaxCodes];  // per luma code
  float cn[kMaxCodes];  // per chroma code: u and v take the same operations
  float bayer[256];
};

// One pixel from its codes: the quantised y code, and u, v (float code
// values, before the downsample) through `uo`, `vo`.
template <class TableArgs, int INTERP, int STAGE>
__device__ __forceinline__ int pixel(const Fused420Params& p,
                                     const TableArgs& L, const Shared& sh,
                                     const Divisor& crv, const Divisor& cbu,
                                     int ncodes, int yc, int uc, int vc,
                                     float dither, float& uo, float& vo) {
  if constexpr (STAGE == kIo) {
    uo = (float)uc;
    vo = (float)vc;
    return round_clip((float)yc, p.maxv_out).i;
  } else {
    float yn, un, vn;
    if (__builtin_expect(max(yc, max(uc, vc)) < ncodes, 1)) {
      yn = sh.yn[yc];
      un = sh.cn[uc];
      vn = sh.cn[vc];
    } else {  // a 16-bit code past the tables
      yn = luma_norm(p, (float)yc);
      un = chroma_norm(p, (float)uc);
      vn = chroma_norm(p, (float)vc);
    }
    // colorcore.matrices.yuv_to_rgb_planes
    const float r = lutk::clip01(yn + p.in_crv * vn);
    const float b = lutk::clip01(yn + p.in_cbu * un);
    const float g = lutk::clip01(yn - p.in_gv * vn - p.in_gu * un);
    float4 o;
    if constexpr (STAGE == kColor) {
      o = make_float4(r, g, b, 0.0f);
    } else {
      o = lutk::lut_apply<INTERP>(L, r, g, b);
    }
    // colorcore.matrices.rgb_to_yuv_planes
    const float yo_n = p.out_kr * o.x + p.out_kg * o.y + p.out_kb * o.z;
    const float vo_n = crv.div(o.x - yo_n);
    const float uo_n = cbu.div(o.z - yo_n);
    uo = uo_n * p.out_cscale + p.out_cmid;
    vo = vo_n * p.out_cscale + p.out_cmid;
    return round_clip(yo_n * p.out_yscale + p.out_yoff + dither, p.maxv_out).i;
  }
}

template <int OSY, int OSX, class TableArgs, int INTERP, int STAGE>
__global__ void __launch_bounds__(kThreads)
    fused420_kernel(Fused420Params p) {
  constexpr bool kCoarse2 = std::is_same<TableArgs, lutk::Coarse2Args>::value;
  constexpr int kRows = 1 << OSY;      // luma rows of a unit
  constexpr int kPairSites = 2 >> OSX;  // output chroma sites of a pair
  // pixels of a pair in flight at once: all of them for the exact table;
  // one per row for coarse2, whose 12 gathers a pixel need the registers
  // (the faster choice of each on the card)
  constexpr int kUnrollPx = kCoarse2 ? kRows : 2 * kRows;
  // a pair's dither offsets at once where its pixels run as one block
  constexpr bool kPairDither = STAGE != kIo && kUnrollPx == 2 * kRows;
  __shared__ Shared sh;
  __shared__ float4 s_rscale[kCoarse2 ? kMaxN : 1];

  TableArgs L;
  table_args(p, L);
  const int ncodes = min((int)p.maxv_in + 1, kMaxCodes);
  if constexpr (STAGE != kIo) {
    for (int k = threadIdx.x; k < ncodes; k += kThreads) {
      sh.yn[k] = luma_norm(p, (float)k);
      sh.cn[k] = chroma_norm(p, (float)k);
    }
    if (p.dither == kOrdered) {
      for (int k = threadIdx.x; k < 256; k += kThreads) {
        sh.bayer[k] = __ldg(p.bayer + k);
      }
    }
    if constexpr (kCoarse2 && STAGE == kFull) {
      for (int k = threadIdx.x; k < p.n; k += kThreads) {
        s_rscale[k] = __ldg(p.rscale + k);
      }
      L.rscale = s_rscale;
    }
    __syncthreads();
  }

  const int H = p.height, W = p.width;
  const int hc_out = H >> OSY, wc_out = W >> OSX;
  const int wc_in = W >> p.in_sx;
  const size_t plane = (size_t)H * W;
  const size_t cplane_in = (size_t)(H >> p.in_sy) * wc_in;
  const size_t cplane_out = (size_t)hc_out * wc_out;
  const int cols = p.vec ? kVecCols : 2;  // luma columns of a unit
  const Divisor crv{p.out_crv, 1.0f / p.out_crv};
  const Divisor cbu{p.out_cbu, 1.0f / p.out_cbu};

  for (int unit = blockIdx.x * kThreads + threadIdx.x; unit < p.units;
       unit += gridDim.x * kThreads) {
    const int t = unit / p.units_per_row;
    const int c0 = (unit - t * p.units_per_row) * cols;
    const int bb = t / hc_out;
    const int i = t - bb * hc_out;  // output chroma row
    // the frame's planes: one 64-bit base each, 32-bit offsets inside
    const char* yb = (const char*)p.y + ((bb * plane) << p.in16);
    const char* ub = (const char*)p.u + ((bb * cplane_in) << p.in16);
    const char* vb = (const char*)p.v + ((bb * cplane_in) << p.in16);
    char* yob = (char*)p.yo + ((bb * plane) << p.out16);
    char* uob = (char*)p.uo + ((bb * cplane_out) << p.out16);
    char* vob = (char*)p.vo + ((bb * cplane_out) << p.out16);

    // the unit's codes; the pair loop takes word 0 and shifts the rest down
    Lanes yw[kRows], uw[kRows], vw[kRows];
#pragma unroll
    for (int dy = 0; dy < kRows; ++dy) {
      const int row = (i << OSY) + dy;
      const int crow = (row >> p.in_sy) * wc_in;
      if (p.vec) {
        yw[dy] = load8(yb, row * W + c0, p.in16);
      } else {
        yw[dy] = load_pair(yb, row * W, c0, 0, W, p.in16);
      }
      if (dy > 0 && p.in_sy) {  // the same chroma row as dy - 1
        uw[dy] = uw[dy - 1];
        vw[dy] = vw[dy - 1];
      } else if (!p.vec) {
        uw[dy] = load_pair(ub, crow, c0, p.in_sx, W, p.in16);
        vw[dy] = load_pair(vb, crow, c0, p.in_sx, W, p.in16);
      } else if (p.in_sx) {
        uw[dy] = load4x2(ub, crow + (c0 >> 1), p.in16);
        vw[dy] = load4x2(vb, crow + (c0 >> 1), p.in16);
      } else {
        uw[dy] = load8(ub, crow + c0, p.in16);
        vw[dy] = load8(vb, crow + c0, p.in16);
      }
    }

    // the vector path's outputs, a word per pair shifted in from the top
    uint32_t yq[kRows][4] = {}, uq[4] = {}, vq[4] = {};
#pragma unroll 1
    for (int k = 0; k < (cols >> 1); ++k) {
      const int col = c0 + 2 * k;  // the pair's even column
      // the pair's pixels, row by row; ypair: the y codes of each row,
      // cu/cv: the chroma of the pair's sites (one unless 4:4:4 out)
      uint32_t ypair[2] = {0u, 0u};
      float cu[2], cv[2], pu = 0.0f, pv = 0.0f;
      const int sc = col >> OSX;  // the pair's first output chroma column
      PairDither dith = {};
      if constexpr (kPairDither) {
        dith = pair_dither<OSY, OSX>(p, sh.bayer, i << OSY, col, i, sc);
      }
#pragma unroll(kUnrollPx)
      for (int px = 0; px < (2 << OSY); ++px) {
        const int dy = px >> 1, dx = px & 1, sh16 = 16 * dx;
        const int last = kRows - 1;
        float uo, vo;
        const int q = pixel<TableArgs, INTERP, STAGE>(
            p, L, sh, crv, cbu, ncodes,
            ((dy ? yw[last] : yw[0]).w[0] >> sh16) & 0xffff,
            ((dy ? uw[last] : uw[0]).w[0] >> sh16) & 0xffff,
            ((dy ? vw[last] : vw[0]).w[0] >> sh16) & 0xffff,
            kPairDither ? dith.y(dy, dx)
                        : dither_at(p, sh.bayer, (i << OSY) + dy, col + dx, 1u),
            uo, vo);
        if (dy) {
          ypair[1] |= (uint32_t)q << sh16;
        } else {
          ypair[0] |= (uint32_t)q << sh16;
        }
        if constexpr (STAGE == kIo || OSX == 0) {
          // 4:4:4 out, or the site's first sample
          if (dy == 0 && dx == 0) {
            cu[0] = uo;
            cv[0] = vo;
          } else if (dy == 0) {
            cu[1] = uo;
            cv[1] = vo;
          }
        } else if (dx == 0) {
          pu = uo;
          pv = vo;
        } else {
          // pixel.chroma_downsample_420: lane pairs, then rows;
          // pixel.chroma_downsample_422: lane pairs
          const float su = pu + uo, sv = pv + vo;
          if constexpr (OSY == 0) {
            cu[0] = su * 0.5f;
            cv[0] = sv * 0.5f;
          } else if (dy == 0) {
            cu[0] = su;
            cv[0] = sv;
          } else {
            cu[0] = (cu[0] + su) * 0.25f;
            cv[0] = (cv[0] + sv) * 0.25f;
          }
        }
      }
      uint32_t upair = 0u, vpair = 0u;
#pragma unroll
      for (int s = 0; s < kPairSites; ++s) {
        int qu, qv;
        if constexpr (STAGE == kIo) {
          qu = round_clip(cu[s], p.maxv_out).i;
          qv = round_clip(cv[s], p.maxv_out).i;
        } else {
          const float du = kPairDither ? (s ? dith.u1 : dith.u0)
                                       : dither_at(p, sh.bayer, i, sc + s, 2u);
          const float dv = kPairDither ? (s ? dith.v1 : dith.v0)
                                       : dither_at(p, sh.bayer, i, sc + s, 3u);
          qu = round_clip(cu[s] + du, p.maxv_out).i;
          qv = round_clip(cv[s] + dv, p.maxv_out).i;
        }
        upair |= (uint32_t)qu << (16 * s);
        vpair |= (uint32_t)qv << (16 * s);
      }

      if (!p.vec) {  // the scalar path stores the pair as it goes
#pragma unroll
        for (int dy = 0; dy < kRows; ++dy) {
          const int o = ((i << OSY) + dy) * W + col;
          store1(yob, o, p.out16, ypair[dy] & 0xffff);
          if (col + 1 < W) store1(yob, o + 1, p.out16, ypair[dy] >> 16);
        }
#pragma unroll
        for (int s = 0; s < kPairSites; ++s) {
          if (sc + s < wc_out) {
            store1(uob, i * wc_out + sc + s, p.out16,
                   (upair >> (16 * s)) & 0xffff);
            store1(vob, i * wc_out + sc + s, p.out16,
                   (vpair >> (16 * s)) & 0xffff);
          }
        }
        continue;
      }
#pragma unroll
      for (int dy = 0; dy < kRows; ++dy) {
#pragma unroll
        for (int w = 0; w < 3; ++w) {
          yw[dy].w[w] = yw[dy].w[w + 1];
          uw[dy].w[w] = uw[dy].w[w + 1];
          vw[dy].w[w] = vw[dy].w[w + 1];
          yq[dy][w] = yq[dy][w + 1];
        }
        yq[dy][3] = ypair[dy];
      }
      if constexpr (OSX == 0) {  // a word (two sites) per pair
#pragma unroll
        for (int w = 0; w < 3; ++w) {
          uq[w] = uq[w + 1];
          vq[w] = vq[w + 1];
        }
        uq[3] = upair;
        vq[3] = vpair;
      } else {  // a lane (one site) per pair
        uq[0] = __funnelshift_r(uq[0], uq[1], 16);
        uq[1] = __funnelshift_r(uq[1], upair, 16);
        vq[0] = __funnelshift_r(vq[0], vq[1], 16);
        vq[1] = __funnelshift_r(vq[1], vpair, 16);
      }
    }
    if (p.vec) {
#pragma unroll
      for (int dy = 0; dy < kRows; ++dy) {
        store_vec<kVecCols>(yob, ((i << OSY) + dy) * W + c0, p.out16, yq[dy]);
      }
      store_vec<(kVecCols >> OSX)>(uob, i * wc_out + (c0 >> OSX), p.out16, uq);
      store_vec<(kVecCols >> OSX)>(vob, i * wc_out + (c0 >> OSX), p.out16, vq);
    }
  }
}

template <int OSY, int OSX, class TableArgs, int INTERP, int STAGE>
int launch_kernel(const Fused420Params* p, cudaStream_t st) {
  constexpr bool kCoarse2 = std::is_same<TableArgs, lutk::Coarse2Args>::value;
  if (kCoarse2 && STAGE == kFull && p->n > kMaxN) {
    return (int)cudaErrorInvalidValue;
  }
  auto kernel = fused420_kernel<OSY, OSX, TableArgs, INTERP, STAGE>;
  // a persistent grid: as many blocks as the SMs hold at once, each walking
  // units, so that the per-block tables are built once per resident block.
  // The count is found at the kernel's first launch on a device and kept.
  constexpr int kDevices = 64;
  static int resident_blocks[kDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int resident = dev < kDevices ? resident_blocks[dev] : 0;
  if (resident == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kThreads, 0);
    }
    if (err != cudaSuccess) return (int)err;
    resident = sms * (per_sm > 0 ? per_sm : 1);
    if (dev < kDevices) resident_blocks[dev] = resident;
  }
  long long blocks = ((long long)p->units + kThreads - 1) / kThreads;
  if (blocks > resident) blocks = resident;
  kernel<<<(unsigned)blocks, kThreads, 0, st>>>(*p);
  return (int)cudaGetLastError();
}

template <class TableArgs, int INTERP, int STAGE>
int launch_geometry(const Fused420Params* p, cudaStream_t st) {
  if (p->out_sy && p->out_sx) {
    return launch_kernel<1, 1, TableArgs, INTERP, STAGE>(p, st);
  }
  if (p->out_sx) return launch_kernel<0, 1, TableArgs, INTERP, STAGE>(p, st);
  if (!p->out_sy) return launch_kernel<0, 0, TableArgs, INTERP, STAGE>(p, st);
  return (int)cudaErrorInvalidValue;  // 4:4:0 output is not a geometry
}

// the production kernel of one table kind, its interp chosen at launch
template <class TableArgs>
int launch(const Fused420Params* p, void* stream) {
  if (p->units <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (p->interp) {
    case lutk::kNearest:
      return launch_geometry<TableArgs, lutk::kNearest, kFull>(p, st);
    case lutk::kTrilinear:
      return launch_geometry<TableArgs, lutk::kTrilinear, kFull>(p, st);
    case lutk::kPyramid:
      return launch_geometry<TableArgs, lutk::kPyramid, kFull>(p, st);
    case lutk::kPrism:
      return launch_geometry<TableArgs, lutk::kPrism, kFull>(p, st);
    default:
      return launch_geometry<TableArgs, lutk::kTetrahedral, kFull>(p, st);
  }
}

}  // namespace

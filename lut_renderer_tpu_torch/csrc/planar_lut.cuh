// Kernels A and C: planar float32 RGB -> 3D-LUT-interpolated planar RGB,
// one launch skeleton for the two table kinds.
//
// Kernel A (lut3d.cu) reads the exact (N, N, N, 4) f32 table, kernel C
// (coarse2.cu) the coarse + residual decomposition of a big LUT
// (ops/prepare.Coarse2Table). Each of those files is a list of
// instantiations of the kernel below; the stage probe's builds are
// planar_probe.cu.
//
// What bounds both on Hopper: the plane traffic (24 bytes a pixel) where
// neighbouring pixels share cells, and the table's scattered loads where
// they do not: a warp's load over 32 unrelated lines takes some 32 cycles
// of its SM's L1, whatever its size (PERF.md). The design:
//   * four pixels a thread: four consecutive ones, each plane read and
//     written as one float4, where all six planes are 16-byte aligned (the
//     wrapper decides, `vec`); otherwise sample by sample, a warp's 128
//     pixels as four runs of 32 so that each load and store of the warp is
//     coalesced (the consecutive pixels' samples, 16 bytes apart, took
//     twice the time; PERF.md). The last unit of an aligned pixel count
//     that is not a multiple of 4 goes sample by sample too;
//   * every table load of a pixel issued before any is used: its cell names
//     the corners its interp reads (corner codes), the loads follow, then
//     the sum; the corner choice and the sums are selects, not branches;
//   * the interpolation, and kernel C's residual interpolation, are
//     template parameters the host picks: no per-pixel switch;
//   * 32-bit indices (the wrapper refuses 2^31 pixels or more);
//   * kernel C: the residual scale in shared memory, loaded once a block,
//     and a persistent grid of as many blocks as the SMs hold, walking the
//     units; kernel A, which has no such prologue, a block per 256 units
//     and at most 64 registers (four blocks an SM).
// Bit-equality: every f32 operation of interp_cell and coarse_term
// (lut_interp.cuh) in its order, the coarse corners summed 000 ... 111,
// built with -fmad=false, so the output equals the one-pixel-a-thread
// kernels' bit for bit (probes/kernel_ac.py --baseline compares them).
#pragma once

#include <cuda_runtime.h>
#include <limits.h>

#include <type_traits>

#include "lut_interp.cuh"

// Outside the anonymous namespace: a parameter type with internal linkage
// would give the extern "C" entry points internal linkage too. Each
// struct extends its one-pixel-a-thread predecessor's at the end, so a
// library of that revision reads the same params.
struct Lut3dParams {
  const float* r;
  const float* g;
  const float* b;
  float* ro;
  float* go;
  float* bo;
  const float4* table;  // (n, n, n, 4) f32
  long long npix;       // < 2^31
  int n;
  int interp;
  float dmin[3];
  float dmax[3];
  int vec;  // all six planes 16-byte aligned
};

struct Coarse2Params {
  const float* r;
  const float* g;
  const float* b;
  float* ro;
  float* go;
  float* bo;
  const float4* coarse;  // (m, m, m, 4) f32
  const char4* resid;    // (n, n, n, 4) int8
  const float4* rscale;  // (n, 4) f32: residual scale of (r index, channel)
  long long npix;        // < 2^31
  int n;
  int m;
  int interp;
  int resid_interp;  // the render's interp, or trilinear under a _tri tier
  float dmin[3];
  float dmax[3];
  int vec;  // all six planes 16-byte aligned
};

// Internal linkage: each translation unit that includes this header
// instantiates the kernels it launches.
namespace {

using namespace lutk;

constexpr int kPx = 4;        // pixels a thread
constexpr int kThreads = 256;  // threads a block
constexpr int kMaxN = 129;     // colorcore.cube.MAX_LUT_SIZE

// each kernel's launch shape: a persistent grid or a block per kThreads
// units, and __launch_bounds__'s blocks an SM
template <class Params>
struct Tuning;
template <>
struct Tuning<Lut3dParams> {
  static constexpr bool kPersistent = false;
  static constexpr int kMinBlocks = 4;
};
template <>
struct Tuning<Coarse2Params> {
  static constexpr bool kPersistent = true;
  static constexpr int kMinBlocks = 1;
};

// the stage probe's builds (probes/kernel_ac.STAGES): io loads and stores
// the planes; weights adds the domain map, the cells and the sums over
// stand-in corners (no table load); coarse and resid (kernel C) each run
// one term with its loads; full is the production kernel
enum Stage : int { kIo = 0, kWeights = 1, kCoarse = 2, kResid = 3, kFull = 4 };

struct Domain {
  float dmin[3];
  float dmax[3];
  int n;
  int unit;
};

template <class Params>
__device__ __forceinline__ Domain domain_of(const Params& p) {
  Domain d;
  d.n = p.n;
  set_domain(d, p.dmin, p.dmax);
  return d;
}

template <int INTERP>
constexpr int kCorners = INTERP == kNearest     ? 1
                         : INTERP == kTrilinear ? 8
                         : INTERP == kPyramid   ? 5
                         : INTERP == kPrism     ? 6
                                                : 4;

// One pixel's grid cell under an interp: interp_cell's indices (the next
// index clamped to the grid; NEAR for nearest), deltas and case split, and
// the corners the interp reads, as codes i << 2 | j << 1 | k for corner
// (r_i, g_j, b_k), in the order its sum takes them.
struct Cell {
  int r0, g0, b0, r1, g1, b1;
  float dr, dg, db;
  float x, y, z;  // tetrahedral: the deltas sorted, x >= y >= z
  bool c1, c3;    // pyramid: FFmpeg's case 1, case 3; prism: c1 = upper
  int code[8];
};

template <int INTERP>
__device__ __forceinline__ Cell cell_of(float sr, float sg, float sb,
                                        int top) {
  Cell c = {};
  if constexpr (INTERP == kNearest) {
    c.r0 = c.r1 = min(max(floor_nonneg(sr + 0.5f).i, 0), top);
    c.g0 = c.g1 = min(max(floor_nonneg(sg + 0.5f).i, 0), top);
    c.b0 = c.b1 = min(max(floor_nonneg(sb + 0.5f).i, 0), top);
    return c;
  } else {
    const Floor fr = floor_nonneg(sr), fg = floor_nonneg(sg),
                fb = floor_nonneg(sb);
    c.r0 = fr.i;
    c.g0 = fg.i;
    c.b0 = fb.i;
    c.r1 = min(c.r0 + 1, top);
    c.g1 = min(c.g0 + 1, top);
    c.b1 = min(c.b0 + 1, top);
    c.dr = sr - fr.f;
    c.dg = sg - fg.f;
    c.db = sb - fb.f;
    if constexpr (INTERP == kTrilinear) {
#pragma unroll
      for (int k = 0; k < 8; ++k) c.code[k] = k;
    } else if constexpr (INTERP == kPyramid) {
      // c000, c111, then p, q, s: case 1 (dg > dr and db > dr) 001, 010,
      // 011; case 2 (dr > dg and db > dg) 100, 001, 101; case 3 100, 010,
      // 110
      c.c1 = c.dg > c.dr && c.db > c.dr;
      const bool c2 = !c.c1 && c.dr > c.dg && c.db > c.dg;
      c.c3 = !c.c1 && !c2;
      c.code[0] = 0;
      c.code[1] = 7;
      c.code[2] = c.c1 ? 1 : 4;
      c.code[3] = c2 ? 1 : 2;
      c.code[4] = c.c1 ? 3 : (c2 ? 5 : 6);
    } else if constexpr (INTERP == kPrism) {
      // per g plane: v00, v01 (upper) or v10, v11
      c.c1 = c.db > c.dr;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        c.code[3 * q] = q << 1;
        c.code[3 * q + 1] = c.c1 ? (q << 1 | 1) : (4 | q << 1);
        c.code[3 * q + 2] = 4 | q << 1 | 1;
      }
    } else {  // tetrahedral (also every unknown name): 000, A, B, 111
      const Tetra t = tetra_case(c.dr, c.dg, c.db);
      c.x = t.x;
      c.y = t.y;
      c.z = t.z;
      c.code[0] = 0;
      c.code[1] = (int)t.ar << 2 | (int)t.ag << 1 | (int)t.ab;
      c.code[2] = (int)t.br << 2 | (int)t.bg << 1 | (int)t.bb;
      c.code[3] = 7;
    }
    return c;
  }
}

// interp_cell's sum over the corner values v (in code order), with its
// operations and their order; the cases are selects.
template <int INTERP>
__device__ __forceinline__ float4 combine(const Cell& c, const float4* v) {
  if constexpr (INTERP == kNearest) {
    return v[0];
  } else if constexpr (INTERP == kTrilinear) {
    const float4 c00 = v[0] * (1.0f - c.db) + v[1] * c.db;
    const float4 c01 = v[2] * (1.0f - c.db) + v[3] * c.db;
    const float4 c10 = v[4] * (1.0f - c.db) + v[5] * c.db;
    const float4 c11 = v[6] * (1.0f - c.db) + v[7] * c.db;
    const float4 c0 = c00 * (1.0f - c.dg) + c01 * c.dg;
    const float4 c1 = c10 * (1.0f - c.dg) + c11 * c.dg;
    return c0 * (1.0f - c.dr) + c1 * c.dr;
  } else if constexpr (INTERP == kPyramid) {
    // the three cases' sums are one form: c000 + tr dr + tg dg + tb db +
    // (s - p - q + c000) m1 m2, each term taken from the pixel's case
    const bool c2 = !c.c1 && !c.c3;
    const float4 d1 = v[1] - v[4], pm = v[2] - v[0], qm = v[3] - v[0];
    const float4 tr = c.c1 ? d1 : pm;
    const float4 tg = c2 ? d1 : qm;
    const float4 tb = c.c1 ? pm : (c2 ? qm : d1);
    const float m1 = c.c1 ? c.dg : c.dr, m2 = c.c3 ? c.dg : c.db;
    return v[0] + tr * c.dr + tg * c.dg + tb * c.db +
           (v[4] - v[2] - v[3] + v[0]) * m1 * m2;
  } else if constexpr (INTERP == kPrism) {
    const float w0 = c.c1 ? 1.0f - c.db : 1.0f - c.dr;
    const float w1 = c.c1 ? c.db - c.dr : c.dr - c.db;
    const float w2 = c.c1 ? c.dr : c.db;
    const float4 f0 = w0 * v[0] + w1 * v[1] + w2 * v[2];
    const float4 f1 = w0 * v[3] + w1 * v[4] + w2 * v[5];
    return f0 * (1.0f - c.dg) + f1 * c.dg;
  } else {
    return (1.0f - c.x) * v[0] + (c.x - c.y) * v[1] + (c.y - c.z) * v[2] +
           c.z * v[3];
  }
}

// the weights stage's stand-in for a table value: the corner's offset in
// its cell
__device__ __forceinline__ float4 code_value(int code) {
  return make_float4((float)(code >> 2 & 1), (float)(code >> 1 & 1),
                     (float)(code & 1), 0.0f);
}

__device__ __forceinline__ int corner_index(const Cell& c, int code, int n) {
  const int r = code & 4 ? c.r1 : c.r0, g = code & 2 ? c.g1 : c.g0,
            b = code & 1 ? c.b1 : c.b0;
  return (r * n + g) * n + b;
}

// the scaled coordinates of one pixel
__device__ __forceinline__ void scaled(const Domain& d, float r, float g,
                                       float b, float (&s)[3]) {
  const float in[3] = {r, g, b};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    s[a] = scaled_coord(in[a], d.dmin[a], d.dmax[a], d.n, d.unit);
  }
}

// ---------------------------------------------------------------------------
// kernel A: the exact table
// ---------------------------------------------------------------------------

template <int INTERP, int STAGE>
__device__ __forceinline__ float4 exact_pixel(const Lut3dParams& p,
                                              const Domain& d, float r,
                                              float g, float b) {
  constexpr int K = kCorners<INTERP>;
  float s[3];
  scaled(d, r, g, b, s);
  const Cell c = cell_of<INTERP>(s[0], s[1], s[2], d.n - 1);
  // every corner load, then the sum
  float4 v[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    v[j] = STAGE == kFull ? __ldg(p.table + corner_index(c, c.code[j], d.n))
                          : code_value(c.code[j]);
  }
  return combine<INTERP>(c, v);
}

// ---------------------------------------------------------------------------
// kernel C: coarse + residual
// ---------------------------------------------------------------------------

// The coarse corners of one pixel: the b pair of each (r, g) line of its
// coarse cell, line l = i << 1 | j.
struct CoarseRaw {
  float4 lo[4];
  float4 hi[4];
};

// coarse_term's coarse cell: the fine prev index p of each axis sits in
// coarse cell p / 2; the next coarse line is clamped to M - 1 (the top
// edge, where p / 2 + 1 is M)
__device__ __forceinline__ CoarseRaw coarse_load(const Coarse2Params& p,
                                                 const float (&s)[3]) {
  const int top = p.m - 1;
  const int pr = floor_nonneg(s[0]).i >> 1, pg = floor_nonneg(s[1]).i >> 1,
            cb = floor_nonneg(s[2]).i >> 1;
  const int cr[2] = {pr, min(pr + 1, top)};
  const int cg[2] = {pg, min(pg + 1, top)};
  CoarseRaw raw;
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    const int at = (cr[l >> 1] * p.m + cg[l & 1]) * p.m + cb;
    raw.lo[l] = __ldg(p.coarse + at);
    raw.hi[l] = __ldg(p.coarse + at + (cb < top));
  }
  return raw;
}

__device__ __forceinline__ CoarseRaw coarse_stand_in() {
  CoarseRaw raw;
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    raw.lo[l] = code_value(l << 1);
    raw.hi[l] = code_value(l << 1 | 1);
  }
  return raw;
}

// coarse_term: the interp's 8 fine-corner weights folded through the
// per-axis 2x2 remap, then the 8 coarse corners summed 000, 001, ..., 111
template <int INTERP>
__device__ __forceinline__ float4 coarse_sum(int n, const float (&s)[3],
                                             const CoarseRaw& raw) {
  float w[2][2][2];
  cell_weights<INTERP>(s[0], s[1], s[2], n - 1, w);
  const int pr = floor_nonneg(s[0]).i, pg = floor_nonneg(s[1]).i,
            pb = floor_nonneg(s[2]).i;
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b) remap_taps(w[0][a][b], w[1][a][b], (pr & 1) == 0);
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b) remap_taps(w[a][0][b], w[a][1][b], (pg & 1) == 0);
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b)
      remap_taps(w[a][b][0], w[a][b][1], (pb & 1) == 0);
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    acc = acc + w[l >> 1][l & 1][0] * raw.lo[l];
    acc = acc + w[l >> 1][l & 1][1] * raw.hi[l];
  }
  return acc;
}

// The residual corners of one pixel, as loaded: one char4 word a corner.
template <int RESID>
struct ResidRaw {
  unsigned int word[kCorners<RESID>];
};

template <int RESID>
__device__ __forceinline__ ResidRaw<RESID> resid_load(const Coarse2Params& p,
                                                      const Cell& c) {
  ResidRaw<RESID> raw;
#pragma unroll
  for (int j = 0; j < kCorners<RESID>; ++j) {
    raw.word[j] = __ldg(
        (const unsigned int*)(p.resid + corner_index(c, c.code[j], p.n)));
  }
  return raw;
}

// interp_cell over the residual: each corner's int8 times the scale of its
// r index and channel (ResidCorners)
template <int RESID, bool LOADED>
__device__ __forceinline__ float4 resid_sum(const Cell& c,
                                            const ResidRaw<RESID>& raw,
                                            const float4* rscale) {
  constexpr int K = kCorners<RESID>;
  float4 v[K];
  if constexpr (LOADED) {
    const float4 s_lo = rscale[c.r0], s_hi = rscale[c.r1];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const unsigned int w = raw.word[j] ^ 0x80808080u;
      const float4 s = c.code[j] & 4 ? s_hi : s_lo;
      v[j] = make_float4(int8_to_float(w, 0) * s.x, int8_to_float(w, 1) * s.y,
                         int8_to_float(w, 2) * s.z, 0.0f);
    }
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j) v[j] = code_value(c.code[j]);
  }
  return combine<RESID>(c, v);
}

template <int INTERP, int RESID, int STAGE>
__device__ __forceinline__ float4 coarse2_pixel(const Coarse2Params& p,
                                                const Domain& d,
                                                const float4* rscale,
                                                float r, float g, float b) {
  constexpr bool kCoarseLoads = STAGE == kCoarse || STAGE == kFull;
  constexpr bool kResidLoads = STAGE == kResid || STAGE == kFull;
  float s[3];
  scaled(d, r, g, b, s);
  const Cell c = cell_of<RESID>(s[0], s[1], s[2], d.n - 1);
  // every table load, then the sums
  const CoarseRaw craw = kCoarseLoads ? coarse_load(p, s) : coarse_stand_in();
  ResidRaw<RESID> rraw;
  if constexpr (kResidLoads) rraw = resid_load<RESID>(p, c);
  if constexpr (STAGE == kResid) {
    return resid_sum<RESID, true>(c, rraw, rscale);
  } else {
    const float4 coarse = coarse_sum<INTERP>(d.n, s, craw);
    if constexpr (STAGE == kCoarse) {
      return coarse;
    } else {
      return coarse + resid_sum<RESID, kResidLoads>(c, rraw, rscale);
    }
  }
}

// ---------------------------------------------------------------------------
// the kernel and its launch
// ---------------------------------------------------------------------------

// The units of a launch, a thread's 4 pixels: 4 consecutive ones on
// aligned planes (vec); otherwise pixel k of lane l of a warp's 128 is
// 32 k + l.
__host__ __device__ __forceinline__ long long units_of(long long npix,
                                                       bool vec) {
  return vec ? (npix + kPx - 1) / kPx
             : 32 * ((npix + 32 * kPx - 1) / (32 * kPx));
}

template <class Params, int INTERP, int RESID, int STAGE>
__global__ void __launch_bounds__(kThreads, Tuning<Params>::kMinBlocks)
    planar_kernel(const Params p) {
  constexpr bool kCoarse2 = std::is_same<Params, Coarse2Params>::value;
  __shared__ float4 s_rscale[kCoarse2 ? kMaxN : 1];
  if constexpr (kCoarse2 && (STAGE == kResid || STAGE == kFull)) {
    for (int k = threadIdx.x; k < p.n; k += kThreads) {
      s_rscale[k] = __ldg(p.rscale + k);
    }
    __syncthreads();
  }
  const Domain d = domain_of(p);
  const unsigned npix = (unsigned)p.npix;
  const bool vec = p.vec;
  const int units = (int)units_of(p.npix, vec);
  const float* planes[3] = {p.r, p.g, p.b};
  float* outs[3] = {p.ro, p.go, p.bo};
  for (int u = blockIdx.x * kThreads + threadIdx.x; u < units;
       u += gridDim.x * kThreads) {
    // the unit's pixels, unsigned: at most 2^31 - 1 + 127
    unsigned at[kPx];
#pragma unroll
    for (int k = 0; k < kPx; ++k) {
      at[k] = vec ? (unsigned)u * kPx + k
                  : (unsigned)(u >> 5) * (32 * kPx) + 32 * k + (u & 31);
    }
    const bool whole = vec && at[kPx - 1] < npix;
    float in[3][kPx];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      if (whole) {
        const float4 v = __ldg((const float4*)planes[a] + u);
        in[a][0] = v.x;
        in[a][1] = v.y;
        in[a][2] = v.z;
        in[a][3] = v.w;
      } else {
#pragma unroll
        for (int k = 0; k < kPx; ++k) {
          in[a][k] = at[k] < npix ? __ldg(planes[a] + at[k]) : 0.0f;
        }
      }
    }
    float4 o[kPx];
#pragma unroll
    for (int k = 0; k < kPx; ++k) {
      if constexpr (STAGE == kIo) {
        o[k] = make_float4(in[0][k], in[1][k], in[2][k], 0.0f);
      } else if constexpr (kCoarse2) {
        o[k] = coarse2_pixel<INTERP, RESID, STAGE>(p, d, s_rscale, in[0][k],
                                                   in[1][k], in[2][k]);
      } else {
        o[k] = exact_pixel<INTERP, STAGE>(p, d, in[0][k], in[1][k],
                                          in[2][k]);
      }
    }
    if (whole) {
      ((float4*)p.ro)[u] = make_float4(o[0].x, o[1].x, o[2].x, o[3].x);
      ((float4*)p.go)[u] = make_float4(o[0].y, o[1].y, o[2].y, o[3].y);
      ((float4*)p.bo)[u] = make_float4(o[0].z, o[1].z, o[2].z, o[3].z);
    } else {
#pragma unroll
      for (int k = 0; k < kPx; ++k) {
        if (at[k] < npix) {
          outs[0][at[k]] = o[k].x;
          outs[1][at[k]] = o[k].y;
          outs[2][at[k]] = o[k].z;
        }
      }
    }
  }
}

template <class Params, int INTERP, int RESID, int STAGE>
int launch(const Params* p, void* stream) {
  constexpr bool kCoarse2 = std::is_same<Params, Coarse2Params>::value;
  if (p->npix <= 0) return 0;
  if (p->npix > INT_MAX || (kCoarse2 && p->n > kMaxN)) {
    return (int)cudaErrorInvalidValue;
  }
  auto kernel = planar_kernel<Params, INTERP, RESID, STAGE>;
  long long blocks = (units_of(p->npix, p->vec) + kThreads - 1) / kThreads;
  if constexpr (Tuning<Params>::kPersistent) {
    // as many blocks as the SMs hold at once, each walking units; the
    // count is found at the kernel's first launch on a device and kept
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
    if (blocks > resident) blocks = resident;
  }
  kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(*p);
  return (int)cudaGetLastError();
}

}  // namespace

// The plain layout's pixel ops: the unpack before the LUT step and the pack
// after it (and after the resample), one launch each.
//
// Replaces no TPU kernel: the JAX package leaves these elementwise steps
// (lut_renderer_tpu/ops/pixel.py, called from ops/render.py's plain layout)
// to XLA around its LUT kernel. The port ran them as about 60 PyTorch
// launches a batch, five of them divisions whose divisor was uploaded from
// the host at each call (ops/pixel.fdiv), so the render call waited for the
// card five times a batch. Here every constant comes in the params struct.
//
//   pixel_unpack_kernel: integer Y/U/V planes (uint8 or uint16, 8-16 bit,
//     4:2:0 / 4:2:2 / 4:4:4) -> planar f32 R, G, B at the luma size: the
//     cast, ops/pixel.range_normalize with the requantise, the chroma
//     upsample (replication, or 4:2:0 "bilinear" with edge padding) and
//     yuv_planes_to_rgb with its clip.
//   pixel_pack_kernel: planar f32 R, G, B -> the output planes:
//     rgb_to_yuv_planes, the 4:2:0 / 4:2:2 box downsample (or none), then
//     for integer planes the dither (none, the 16x16 Bayer tile read from
//     the device, or the murmur3 position hash with each plane's seed) and
//     quantize_plane's round half up and clip; for an error-diffusion job
//     the float code values as they are, which the host quantises.
//
// What bounds them on Hopper: device memory. The unpack writes 12 bytes a
// luma pixel (three f32 planes) for 1.5 to 6 read; the pack reads 12 and
// writes 1.5 to 6 (6 to 12 as floats). The design: a thread owns one
// chroma site (of the input for the unpack, of the output for the pack) and
// the luma pixels under it, so a site's chroma is loaded and normalised
// once and its downsample stays in registers; neighbouring threads own
// neighbouring sites, so a warp's loads and stores cover contiguous runs
// of each row; the unpack stores a site's column pair as one float2.
//
// Arithmetic, as ops/pixel.render_planes op for op: every constant is the
// f32 rounding of the value Python computes in double, every division is an
// IEEE division (__fdiv_rn), never a product by a reciprocal, and the
// library is built with -fmad=false, so every product and sum rounds on its
// own. So the planes equal the torch chain's bit for bit, ties included.
// Indices are 32-bit: ops/pixel.py refuses 2^31 pixels a launch.
#include <cuda_runtime.h>
#include <stdint.h>

// The unpack's launch: mirrored by ops/pixel.py _UnpackParams.
struct PixelUnpackParams {
  const void* y;  // (frames, height, width) uint8 or uint16
  const void* u;  // (frames, height >> sy, width >> sx)
  const void* v;
  float* r;  // (frames, height, width)
  float* g;
  float* b;
  int units;  // chroma sites: frames * (height >> sy) * (width >> sx)
  int height;
  int width;
  int in16;  // the planes are uint16
  int sx;    // chroma subsampling shifts (420: 1, 1; 422: 1, 0)
  int sy;
  int bilinear;   // the centre-sited 4:2:0 upsample, else replication
  int normalize;  // in_full_range != work_full_range
  int requant;    // requantise after the normalisation
  // range normalisation: y' = (y - ysub) * ymul + yadd,
  //                      c' = (c - cmid) * cmul + cmid
  float norm_ysub;
  float norm_ymul;
  float norm_yadd;
  float norm_cmid;
  float norm_cmul;
  float maxv_in;
  // YUV -> RGB at the input matrix and depth, in the work range
  float yoff;
  float yscale;
  float cmid;
  float cscale;
  float crv;
  float cbu;
  float gv;  // kr * crv / kg
  float gu;  // kb * cbu / kg
};

// The pack's launch: mirrored by ops/pixel.py _PackParams.
struct PixelPackParams {
  const float* r;  // (frames, height, width)
  const float* g;
  const float* b;
  void* y;  // (frames, height, width) uint8, uint16 or float32
  void* u;  // (frames, height >> sy, width >> sx)
  void* v;
  const float* bayer;  // (16, 16) ordered-dither offsets
  int units;  // chroma sites: frames * (height >> sy) * (width >> sx)
  int height;
  int width;
  int format;  // 0 uint8, 1 uint16, 2 float32 code values unquantised
  int sx;      // output chroma subsampling shifts
  int sy;
  int dither;  // 0 none, 1 ordered, 2 random
  // RGB -> YUV at the output matrix, depth and range
  float kr;
  float kg;
  float kb;
  float crv;
  float cbu;
  float yoff;
  float yscale;
  float cmid;
  float cscale;
  float maxv;  // (1 << out_depth) - 1
};

namespace {

constexpr int kThreads = 256;

enum Dither : int { kNone = 0, kOrdered = 1, kRandom = 2 };
enum Format : int { kU8 = 0, kU16 = 1, kF32 = 2 };

__device__ __forceinline__ float load_code(const void* p, int i, int is16) {
  return is16 ? (float)__ldg((const unsigned short*)p + i)
              : (float)__ldg((const unsigned char*)p + i);
}

__device__ __forceinline__ void store_code(void* p, int i, int is16, int q) {
  if (is16) {
    ((unsigned short*)p)[i] = (unsigned short)q;
  } else {
    ((unsigned char*)p)[i] = (unsigned char)q;
  }
}

// torch.clip(torch.floor(x + 0.5), 0, maxv)
__device__ __forceinline__ float round_clip(float x, float maxv) {
  return fminf(fmaxf(floorf(x + 0.5f), 0.0f), maxv);
}

__device__ __forceinline__ float clip01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

// ops/pixel.range_normalize with the requantise, for a luma code
__device__ __forceinline__ float norm_luma(const PixelUnpackParams& p,
                                          float y) {
  if (p.normalize) {
    y = (y - p.norm_ysub) * p.norm_ymul + p.norm_yadd;
    if (p.requant) y = round_clip(y, p.maxv_in);
  }
  return y;
}

// the same for a chroma code
__device__ __forceinline__ float norm_chroma(const PixelUnpackParams& p,
                                            float c) {
  if (p.normalize) {
    c = (c - p.norm_cmid) * p.norm_cmul + p.norm_cmid;
    if (p.requant) c = round_clip(c, p.maxv_in);
  }
  return c;
}

// ops/pixel.chroma_upsample_420(mode="bilinear") at luma (row, col) of the
// chroma plane `c`, whose frame starts at site `base` (wc sites a row): the
// replicated plane's value there, halved, plus an eighth of its four
// edge-padded neighbours summed above, below, left, right
__device__ __forceinline__ float bilinear_at(const PixelUnpackParams& p,
                                            const void* c, int base, int row,
                                            int col, int wc) {
  auto up = [&](int rr, int cc) {
    return norm_chroma(
        p, load_code(c, base + (rr >> 1) * wc + (cc >> 1), p.in16));
  };
  const float n = up(max(row - 1, 0), col);
  const float s = up(min(row + 1, p.height - 1), col);
  const float w = up(row, max(col - 1, 0));
  const float e = up(row, min(col + 1, p.width - 1));
  return up(row, col) * 0.5f + 0.125f * (((n + s) + w) + e);
}

template <int SX, int SY, bool BILINEAR>
__global__ void __launch_bounds__(kThreads)
    pixel_unpack_kernel(const PixelUnpackParams p) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= p.units) return;
  const int wc = p.width >> SX;
  const int sites = (p.height >> SY) * wc;  // a frame's
  const int f = t / sites;
  const int s = t - f * sites;
  const int ci = s / wc;
  const int cj = s - ci * wc;
  const int frame = f * p.height * p.width;
  const int base = f * sites;  // the frame's first chroma site
  // the site's chroma terms of yuv_planes_to_rgb, which replication shares
  float un = 0.0f, vn = 0.0f;
  if constexpr (!BILINEAR) {
    un = __fdiv_rn(norm_chroma(p, load_code(p.u, base + s, p.in16)) - p.cmid,
                   p.cscale);
    vn = __fdiv_rn(norm_chroma(p, load_code(p.v, base + s, p.in16)) - p.cmid,
                   p.cscale);
  }
#pragma unroll
  for (int dy = 0; dy < (1 << SY); ++dy) {
    const int row = (ci << SY) + dy;
    float r[1 << SX], g[1 << SX], b[1 << SX];
#pragma unroll
    for (int dx = 0; dx < (1 << SX); ++dx) {
      const int col = (cj << SX) + dx;
      if constexpr (BILINEAR) {
        un = __fdiv_rn(bilinear_at(p, p.u, base, row, col, wc) - p.cmid,
                       p.cscale);
        vn = __fdiv_rn(bilinear_at(p, p.v, base, row, col, wc) - p.cmid,
                       p.cscale);
      }
      const float yv = norm_luma(p, load_code(p.y, frame + row * p.width +
                                                        col, p.in16));
      const float yn = __fdiv_rn(yv - p.yoff, p.yscale);
      r[dx] = clip01(yn + p.crv * vn);
      b[dx] = clip01(yn + p.cbu * un);
      g[dx] = clip01(yn - p.gv * vn - p.gu * un);
    }
    const int i = frame + row * p.width + (cj << SX);
    if constexpr (SX == 1) {  // an even index of fresh planes: 8-byte aligned
      *(float2*)(p.r + i) = make_float2(r[0], r[1]);
      *(float2*)(p.g + i) = make_float2(g[0], g[1]);
      *(float2*)(p.b + i) = make_float2(b[0], b[1]);
    } else {
      p.r[i] = r[0];
      p.g[i] = g[0];
      p.b[i] = b[0];
    }
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

// code value x at (row, col) of a plane with seed `seed`, stored at i: as
// it is in float32, else through ops/pixel.quantize_plane
__device__ __forceinline__ void store_out(const PixelPackParams& p, void* out,
                                          int i, float x, int row, int col,
                                          uint32_t seed) {
  if (p.format == kF32) {
    ((float*)out)[i] = x;
    return;
  }
  if (p.dither != kNone) {
    x = x + (p.dither == kOrdered
                 ? __ldg(p.bayer + (row & 15) * 16 + (col & 15))
                 : hash_offset((uint32_t)row, (uint32_t)col, seed));
  }
  store_code(out, i, p.format == kU16, (int)round_clip(x, p.maxv));
}

template <int SX, int SY>
__global__ void __launch_bounds__(kThreads)
    pixel_pack_kernel(const PixelPackParams p) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= p.units) return;
  const int wc = p.width >> SX;
  const int sites = (p.height >> SY) * wc;  // a frame's
  const int f = t / sites;
  const int s = t - f * sites;
  const int ci = s / wc;
  const int cj = s - ci * wc;
  const int frame = f * p.height * p.width;
  // the site's chroma code values before the downsample, row by row
  float cu[1 << SY][1 << SX], cv[1 << SY][1 << SX];
#pragma unroll
  for (int dy = 0; dy < (1 << SY); ++dy) {
#pragma unroll
    for (int dx = 0; dx < (1 << SX); ++dx) {
      const int row = (ci << SY) + dy;
      const int col = (cj << SX) + dx;
      const int i = frame + row * p.width + col;
      const float r = __ldg(p.r + i);
      const float g = __ldg(p.g + i);
      const float b = __ldg(p.b + i);
      // colorcore.matrices.rgb_to_yuv_planes
      const float yn = p.kr * r + p.kg * g + p.kb * b;
      const float vn = __fdiv_rn(r - yn, p.crv);
      const float un = __fdiv_rn(b - yn, p.cbu);
      store_out(p, p.y, i, yn * p.yscale + p.yoff, row, col, 1u);
      cu[dy][dx] = un * p.cscale + p.cmid;
      cv[dy][dx] = vn * p.cscale + p.cmid;
    }
  }
  // ops/pixel.chroma_downsample_420 (column pairs, then rows) and _422
  float u = cu[0][0], v = cv[0][0];
  if constexpr (SX == 1 && SY == 1) {
    u = ((cu[0][0] + cu[0][1]) + (cu[1][0] + cu[1][1])) * 0.25f;
    v = ((cv[0][0] + cv[0][1]) + (cv[1][0] + cv[1][1])) * 0.25f;
  } else if constexpr (SX == 1) {
    u = (cu[0][0] + cu[0][1]) * 0.5f;
    v = (cv[0][0] + cv[0][1]) * 0.5f;
  }
  const int c = f * sites + s;
  store_out(p, p.u, c, u, ci, cj, 2u);
  store_out(p, p.v, c, v, ci, cj, 3u);
}

template <class Params>
int launch(void (*kernel)(Params), const Params* p, void* stream) {
  const unsigned blocks = (unsigned)((p->units + kThreads - 1) / kThreads);
  kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(*p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" __attribute__((visibility("default"))) int pixel_unpack_launch(
    const PixelUnpackParams* p, void* stream) {
  if (p->units <= 0) return 0;
  if (p->sx == 1 && p->sy == 1) {
    return p->bilinear ? launch(pixel_unpack_kernel<1, 1, true>, p, stream)
                       : launch(pixel_unpack_kernel<1, 1, false>, p, stream);
  }
  if (p->bilinear) return (int)cudaErrorInvalidValue;
  if (p->sx == 1 && p->sy == 0) {
    return launch(pixel_unpack_kernel<1, 0, false>, p, stream);
  }
  if (p->sx == 0 && p->sy == 0) {
    return launch(pixel_unpack_kernel<0, 0, false>, p, stream);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" __attribute__((visibility("default"))) int pixel_pack_launch(
    const PixelPackParams* p, void* stream) {
  if (p->units <= 0) return 0;
  if ((p->dither == kOrdered && p->bayer == nullptr) ||
      (p->format == kF32 && p->dither != kNone)) {
    return (int)cudaErrorInvalidValue;
  }
  if (p->sx == 1 && p->sy == 1) {
    return launch(pixel_pack_kernel<1, 1>, p, stream);
  }
  if (p->sx == 1 && p->sy == 0) return launch(pixel_pack_kernel<1, 0>, p, stream);
  if (p->sx == 0 && p->sy == 0) return launch(pixel_pack_kernel<0, 0>, p, stream);
  return (int)cudaErrorInvalidValue;
}

// 3D-LUT interpolation in FFmpeg lut3d semantics, shared by kernel A
// (lut3d.cu) and kernel B (fused420.cu).
//
// Every function follows colorcore/interp.py op for op: the domain mapping
// of _prepare, PREV/NEXT/NEAR, FFmpeg's strict-comparison case splits, and
// the same left-to-right evaluation order of each weighted sum. The library
// is built with -fmad=false, so no multiply-add is contracted and each
// operation rounds like the NumPy and PyTorch versions do.
//
// The table is (N, N, N, 4) float32 indexed [r][g][b], RGB padded to 16
// bytes so that one corner is one 16-byte load through the read-only cache.
#pragma once

#include <cuda_runtime.h>

namespace lutk {

enum Interp : int {
  kNearest = 0,
  kTrilinear = 1,
  kTetrahedral = 2,
  kPyramid = 3,
  kPrism = 4,
};

struct LutArgs {
  const float4* table;  // (n, n, n, 4) f32
  int n;
  float dmin[3];
  float dmax[3];
};

__device__ __forceinline__ float clip01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

__device__ __forceinline__ float4 corner(const LutArgs& L, int r, int g,
                                         int b) {
  return __ldg(L.table + ((r * L.n + g) * L.n + b));
}

__device__ __forceinline__ float4 f4(float x) {
  return make_float4(x, x, x, 0.0f);
}
__device__ __forceinline__ float4 operator+(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, 0.0f);
}
__device__ __forceinline__ float4 operator-(float4 a, float4 b) {
  return make_float4(a.x - b.x, a.y - b.y, a.z - b.z, 0.0f);
}
__device__ __forceinline__ float4 operator*(float4 a, float s) {
  return make_float4(a.x * s, a.y * s, a.z * s, 0.0f);
}
__device__ __forceinline__ float4 operator*(float s, float4 a) {
  return make_float4(s * a.x, s * a.y, s * a.z, 0.0f);
}

// interp._prepare: clip, map through the domain, clip, scale by N-1.
__device__ __forceinline__ float scaled_coord(const LutArgs& L, float x,
                                              int axis) {
  float span = L.dmax[axis] - L.dmin[axis];
  float t = clip01((clip01(x) - L.dmin[axis]) / span);
  return t * (float)(L.n - 1);
}

__device__ __forceinline__ float4 lut_apply(const LutArgs& L, int interp,
                                            float r, float g, float b) {
  const float sr = scaled_coord(L, r, 0);
  const float sg = scaled_coord(L, g, 1);
  const float sb = scaled_coord(L, b, 2);
  const int top = L.n - 1;

  if (interp == kNearest) {
    // NEAR(x) = trunc(x + 0.5), clipped to the grid
    int ir = min(max((int)floorf(sr + 0.5f), 0), top);
    int ig = min(max((int)floorf(sg + 0.5f), 0), top);
    int ib = min(max((int)floorf(sb + 0.5f), 0), top);
    return corner(L, ir, ig, ib);
  }

  const int r0 = (int)floorf(sr), g0 = (int)floorf(sg), b0 = (int)floorf(sb);
  const int r1 = min(r0 + 1, top), g1 = min(g0 + 1, top), b1 = min(b0 + 1, top);
  const float dr = sr - (float)r0, dg = sg - (float)g0, db = sb - (float)b0;

  if (interp == kTrilinear) {
    float4 c000 = corner(L, r0, g0, b0), c001 = corner(L, r0, g0, b1);
    float4 c010 = corner(L, r0, g1, b0), c011 = corner(L, r0, g1, b1);
    float4 c100 = corner(L, r1, g0, b0), c101 = corner(L, r1, g0, b1);
    float4 c110 = corner(L, r1, g1, b0), c111 = corner(L, r1, g1, b1);
    float4 c00 = c000 * (1.0f - db) + c001 * db;
    float4 c01 = c010 * (1.0f - db) + c011 * db;
    float4 c10 = c100 * (1.0f - db) + c101 * db;
    float4 c11 = c110 * (1.0f - db) + c111 * db;
    float4 c0 = c00 * (1.0f - dg) + c01 * dg;
    float4 c1 = c10 * (1.0f - dg) + c11 * dg;
    return c0 * (1.0f - dr) + c1 * dr;
  }

  if (interp == kPyramid) {
    float4 c000 = corner(L, r0, g0, b0), c111 = corner(L, r1, g1, b1);
    if (dg > dr && db > dr) {
      float4 c001 = corner(L, r0, g0, b1), c010 = corner(L, r0, g1, b0);
      float4 c011 = corner(L, r0, g1, b1);
      return c000 + (c111 - c011) * dr + (c010 - c000) * dg +
             (c001 - c000) * db + (c011 - c001 - c010 + c000) * dg * db;
    }
    if (dr > dg && db > dg) {
      float4 c100 = corner(L, r1, g0, b0), c001 = corner(L, r0, g0, b1);
      float4 c101 = corner(L, r1, g0, b1);
      return c000 + (c100 - c000) * dr + (c111 - c101) * dg +
             (c001 - c000) * db + (c101 - c100 - c001 + c000) * dr * db;
    }
    float4 c100 = corner(L, r1, g0, b0), c010 = corner(L, r0, g1, b0);
    float4 c110 = corner(L, r1, g1, b0);
    return c000 + (c100 - c000) * dr + (c010 - c000) * dg +
           (c111 - c110) * db + (c110 - c100 - c010 + c000) * dr * dg;
  }

  if (interp == kPrism) {
    // triangle over (r, b) in each g plane, linear along g
    const bool upper = db > dr;
    float4 f[2];
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int gi = p ? g1 : g0;
      float4 v00 = corner(L, r0, gi, b0), v11 = corner(L, r1, gi, b1);
      if (upper) {
        float4 v01 = corner(L, r0, gi, b1);
        f[p] = (1.0f - db) * v00 + (db - dr) * v01 + dr * v11;
      } else {
        float4 v10 = corner(L, r1, gi, b0);
        f[p] = (1.0f - dr) * v00 + (dr - db) * v10 + db * v11;
      }
    }
    return f[0] * (1.0f - dg) + f[1] * dg;
  }

  // tetrahedral (also every unknown name): FFmpeg's 6 cases, strict '>'
  float4 c000 = corner(L, r0, g0, b0), c111 = corner(L, r1, g1, b1);
  if (dr > dg) {
    if (dg > db) {
      return (1.0f - dr) * c000 + (dr - dg) * corner(L, r1, g0, b0) +
             (dg - db) * corner(L, r1, g1, b0) + db * c111;
    }
    if (dr > db) {
      return (1.0f - dr) * c000 + (dr - db) * corner(L, r1, g0, b0) +
             (db - dg) * corner(L, r1, g0, b1) + dg * c111;
    }
    return (1.0f - db) * c000 + (db - dr) * corner(L, r0, g0, b1) +
           (dr - dg) * corner(L, r1, g0, b1) + dg * c111;
  }
  if (db > dg) {
    return (1.0f - db) * c000 + (db - dg) * corner(L, r0, g0, b1) +
           (dg - dr) * corner(L, r0, g1, b1) + dr * c111;
  }
  if (db > dr) {
    return (1.0f - dg) * c000 + (dg - db) * corner(L, r0, g1, b0) +
           (db - dr) * corner(L, r0, g1, b1) + dr * c111;
  }
  return (1.0f - dg) * c000 + (dg - dr) * corner(L, r0, g1, b0) +
         (dr - db) * corner(L, r1, g1, b0) + db * c111;
}

}  // namespace lutk

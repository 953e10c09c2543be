// 3D-LUT interpolation in FFmpeg lut3d semantics, shared by kernel A
// (lut3d.cu), kernel C (coarse2.cu) and kernel B (fused420.cu).
//
// interp_cell follows colorcore/interp.py op for op: the domain mapping of
// _prepare, PREV/NEXT/NEAR, FFmpeg's strict-comparison case splits, and the
// same left-to-right evaluation order of each weighted sum. The library is
// built with -fmad=false, so no multiply-add is contracted and each
// operation rounds like the NumPy and PyTorch versions do.
//
// Two table kinds, each with a lut_apply overload:
//   LutArgs      the exact table, (N, N, N, 4) float32 indexed [r][g][b],
//                RGB padded to 16 bytes so that one corner is one 16-byte
//                load through the read-only cache;
//   Coarse2Args  the coarse + residual decomposition of a big LUT
//                (ops/prepare.Coarse2Table): an (M, M, M, 4) f32 coarse
//                table, M = (N+1)/2, and an (N, N, N, 4) int8 residual
//                whose scale depends on the corner's r index and channel.
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

struct Coarse2Args {
  const float4* coarse;  // (m, m, m, 4) f32: dequantised coarse + identity
  const char4* resid;    // (n, n, n, 4) int8 residual
  const float4* rscale;  // (n, 4) f32: residual scale of (r index, channel)
  int n;
  int m;
  int resid_interp;  // the residual term's interp (trilinear for _tri)
  float dmin[3];
  float dmax[3];
};

// corner fetchers: (r, g, b) grid indices -> the table value there
struct F32Corners {
  const float4* table;
  int n;
  __device__ __forceinline__ float4 operator()(int r, int g, int b) const {
    return __ldg(table + ((r * n + g) * n + b));
  }
};

struct ResidCorners {
  const char4* q;
  const float4* scale;
  int n;
  __device__ __forceinline__ float4 operator()(int r, int g, int b) const {
    const char4 v = __ldg(q + ((r * n + g) * n + b));
    const float4 s = __ldg(scale + r);
    return make_float4((float)v.x * s.x, (float)v.y * s.y, (float)v.z * s.z,
                       0.0f);
  }
};

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
__device__ __forceinline__ float scaled_coord(float x, float dmin, float dmax,
                                              int n) {
  float span = dmax - dmin;
  float t = clip01((clip01(x) - dmin) / span);
  return t * (float)(n - 1);
}

// The interpolation of the grid cell at scaled coordinates (sr, sg, sb),
// reading corners through `corner`; top = N - 1.
template <class Corner>
__device__ __forceinline__ float4 interp_cell(const Corner& corner,
                                              int interp, float sr, float sg,
                                              float sb, int top) {

  if (interp == kNearest) {
    // NEAR(x) = trunc(x + 0.5), clipped to the grid
    int ir = min(max((int)floorf(sr + 0.5f), 0), top);
    int ig = min(max((int)floorf(sg + 0.5f), 0), top);
    int ib = min(max((int)floorf(sb + 0.5f), 0), top);
    return corner(ir, ig, ib);
  }

  const int r0 = (int)floorf(sr), g0 = (int)floorf(sg), b0 = (int)floorf(sb);
  const int r1 = min(r0 + 1, top), g1 = min(g0 + 1, top), b1 = min(b0 + 1, top);
  const float dr = sr - (float)r0, dg = sg - (float)g0, db = sb - (float)b0;

  if (interp == kTrilinear) {
    float4 c000 = corner(r0, g0, b0), c001 = corner(r0, g0, b1);
    float4 c010 = corner(r0, g1, b0), c011 = corner(r0, g1, b1);
    float4 c100 = corner(r1, g0, b0), c101 = corner(r1, g0, b1);
    float4 c110 = corner(r1, g1, b0), c111 = corner(r1, g1, b1);
    float4 c00 = c000 * (1.0f - db) + c001 * db;
    float4 c01 = c010 * (1.0f - db) + c011 * db;
    float4 c10 = c100 * (1.0f - db) + c101 * db;
    float4 c11 = c110 * (1.0f - db) + c111 * db;
    float4 c0 = c00 * (1.0f - dg) + c01 * dg;
    float4 c1 = c10 * (1.0f - dg) + c11 * dg;
    return c0 * (1.0f - dr) + c1 * dr;
  }

  if (interp == kPyramid) {
    float4 c000 = corner(r0, g0, b0), c111 = corner(r1, g1, b1);
    if (dg > dr && db > dr) {
      float4 c001 = corner(r0, g0, b1), c010 = corner(r0, g1, b0);
      float4 c011 = corner(r0, g1, b1);
      return c000 + (c111 - c011) * dr + (c010 - c000) * dg +
             (c001 - c000) * db + (c011 - c001 - c010 + c000) * dg * db;
    }
    if (dr > dg && db > dg) {
      float4 c100 = corner(r1, g0, b0), c001 = corner(r0, g0, b1);
      float4 c101 = corner(r1, g0, b1);
      return c000 + (c100 - c000) * dr + (c111 - c101) * dg +
             (c001 - c000) * db + (c101 - c100 - c001 + c000) * dr * db;
    }
    float4 c100 = corner(r1, g0, b0), c010 = corner(r0, g1, b0);
    float4 c110 = corner(r1, g1, b0);
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
      float4 v00 = corner(r0, gi, b0), v11 = corner(r1, gi, b1);
      if (upper) {
        float4 v01 = corner(r0, gi, b1);
        f[p] = (1.0f - db) * v00 + (db - dr) * v01 + dr * v11;
      } else {
        float4 v10 = corner(r1, gi, b0);
        f[p] = (1.0f - dr) * v00 + (dr - db) * v10 + db * v11;
      }
    }
    return f[0] * (1.0f - dg) + f[1] * dg;
  }

  // tetrahedral (also every unknown name): FFmpeg's 6 cases, strict '>'
  float4 c000 = corner(r0, g0, b0), c111 = corner(r1, g1, b1);
  if (dr > dg) {
    if (dg > db) {
      return (1.0f - dr) * c000 + (dr - dg) * corner(r1, g0, b0) +
             (dg - db) * corner(r1, g1, b0) + db * c111;
    }
    if (dr > db) {
      return (1.0f - dr) * c000 + (dr - db) * corner(r1, g0, b0) +
             (db - dg) * corner(r1, g0, b1) + dg * c111;
    }
    return (1.0f - db) * c000 + (db - dr) * corner(r0, g0, b1) +
           (dr - dg) * corner(r1, g0, b1) + dg * c111;
  }
  if (db > dg) {
    return (1.0f - db) * c000 + (db - dg) * corner(r0, g0, b1) +
           (dg - dr) * corner(r0, g1, b1) + dr * c111;
  }
  if (db > dr) {
    return (1.0f - dg) * c000 + (dg - db) * corner(r0, g1, b0) +
           (db - dr) * corner(r0, g1, b1) + dr * c111;
  }
  return (1.0f - dg) * c000 + (dg - dr) * corner(r0, g1, b0) +
         (dr - db) * corner(r1, g1, b0) + db * c111;
}

__device__ __forceinline__ float4 lut_apply(const LutArgs& L, int interp,
                                            float r, float g, float b) {
  return interp_cell(F32Corners{L.table, L.n}, interp,
                     scaled_coord(r, L.dmin[0], L.dmax[0], L.n),
                     scaled_coord(g, L.dmin[1], L.dmax[1], L.n),
                     scaled_coord(b, L.dmin[2], L.dmax[2], L.n), L.n - 1);
}

// ---------------------------------------------------------------------------
// coarse + residual: interp(L) = interp(U(C)) + interp(R)
// ---------------------------------------------------------------------------

// The interp's weights on the 8 corners of the fine cell, w[i][j][k] for
// corner (r0 + i, g0 + j, b0 + k), the next index clamped to the grid as in
// interp_cell. The same cases and strict comparisons as interp_cell.
__device__ __forceinline__ void cell_weights(int interp, float sr, float sg,
                                             float sb, int top,
                                             float w[2][2][2]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) (&w[0][0][0])[i] = 0.0f;
  const int r0 = (int)floorf(sr), g0 = (int)floorf(sg), b0 = (int)floorf(sb);
  const float dr = sr - (float)r0, dg = sg - (float)g0, db = sb - (float)b0;

  if (interp == kNearest) {
    // NEAR(x) = trunc(x + 0.5): the prev or the next corner of the cell
    const int ir = min(max((int)floorf(sr + 0.5f), 0), top) - r0;
    const int ig = min(max((int)floorf(sg + 0.5f), 0), top) - g0;
    const int ib = min(max((int)floorf(sb + 0.5f), 0), top) - b0;
    // selects, not w[ir][ig][ib]: a runtime index would put w in local
    // memory
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int k = 0; k < 2; ++k)
          w[i][j][k] = (i == ir && j == ig && k == ib) ? 1.0f : 0.0f;
    return;
  }
  if (interp == kTrilinear) {
    const float wr[2] = {1.0f - dr, dr}, wg[2] = {1.0f - dg, dg};
    const float wb[2] = {1.0f - db, db};
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int k = 0; k < 2; ++k) w[i][j][k] = wr[i] * wg[j] * wb[k];
    return;
  }
  if (interp == kPyramid) {
    if (dg > dr && db > dr) {
      w[0][0][0] = 1.0f - dg - db + dg * db;
      w[0][1][0] = dg - dg * db;
      w[0][0][1] = db - dg * db;
      w[0][1][1] = dg * db - dr;
      w[1][1][1] = dr;
    } else if (dr > dg && db > dg) {
      w[0][0][0] = 1.0f - dr - db + dr * db;
      w[1][0][0] = dr - dr * db;
      w[0][0][1] = db - dr * db;
      w[1][0][1] = dr * db - dg;
      w[1][1][1] = dg;
    } else {
      w[0][0][0] = 1.0f - dr - dg + dr * dg;
      w[1][0][0] = dr - dr * dg;
      w[0][1][0] = dg - dr * dg;
      w[1][1][0] = dr * dg - db;
      w[1][1][1] = db;
    }
    return;
  }
  if (interp == kPrism) {
    // triangle over (r, b) in each g plane, linear along g
    const bool upper = db > dr;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const float wg = p ? dg : 1.0f - dg;
      if (upper) {
        w[0][p][0] = (1.0f - db) * wg;
        w[0][p][1] = (db - dr) * wg;
      } else {
        w[0][p][0] = (1.0f - dr) * wg;
        w[1][p][0] = (dr - db) * wg;
      }
      w[1][p][1] = (upper ? dr : db) * wg;
    }
    return;
  }
  // tetrahedral (also every unknown name): FFmpeg's 6 cases, strict '>'
  if (dr > dg) {
    if (dg > db) {
      w[0][0][0] = 1.0f - dr; w[1][0][0] = dr - dg;
      w[1][1][0] = dg - db; w[1][1][1] = db;
    } else if (dr > db) {
      w[0][0][0] = 1.0f - dr; w[1][0][0] = dr - db;
      w[1][0][1] = db - dg; w[1][1][1] = dg;
    } else {
      w[0][0][0] = 1.0f - db; w[0][0][1] = db - dr;
      w[1][0][1] = dr - dg; w[1][1][1] = dg;
    }
  } else if (db > dg) {
    w[0][0][0] = 1.0f - db; w[0][0][1] = db - dg;
    w[0][1][1] = dg - dr; w[1][1][1] = dr;
  } else if (db > dr) {
    w[0][0][0] = 1.0f - dg; w[0][1][0] = dg - db;
    w[0][1][1] = db - dr; w[1][1][1] = dr;
  } else {
    w[0][0][0] = 1.0f - dg; w[0][1][0] = dg - dr;
    w[1][1][0] = dr - db; w[1][1][1] = db;
  }
}

// One axis of the fine -> coarse tap remap (JAX prepare.remap_taps_to_coarse_np,
// lut3d._remap_axis_jnp). U is separable linear: fine index f is coarse f/2
// when even, the midpoint of coarse (f-1)/2 and (f+1)/2 when odd. A fine
// cell at prev p sits in coarse cell p/2, and its two fine taps (w0 at p,
// w1 at p+1) land on that cell's two coarse lines as
//   p even: (w0 + w1/2, w1/2)      p odd: (w0/2, w0/2 + w1).
__device__ __forceinline__ void remap_taps(float& w0, float& w1, bool even) {
  if (even) {
    w0 = w0 + 0.5f * w1;
    w1 = 0.5f * w1;
  } else {
    w1 = 0.5f * w0 + w1;
    w0 = 0.5f * w0;
  }
}

// The coarse term: the interp of U(C) at fine coordinates, evaluated on one
// 8-corner coarse cell. The interp's 8 fine-corner weights fold through the
// per-axis 2x2 remap, axis by axis (r, g, b), and the 8 coarse corners sum
// in the fixed order (r, g, b) = 000, 001, ..., 111. Exact: U is linear and
// separable.
//
// Top edge: at p = N - 1 (an input at the domain max) the fine next index
// is clamped to N - 1 = coarse M - 1, while the remap puts half of its
// weight on coarse line p/2 + 1 = M, one past the grid. That line is
// clamped to M - 1 too, so both halves land on fine N - 1's own value.
__device__ __forceinline__ float4 coarse_term(const Coarse2Args& C, int interp,
                                              float sr, float sg, float sb) {
  float w[2][2][2];
  cell_weights(interp, sr, sg, sb, C.n - 1, w);
  const int pr = (int)floorf(sr), pg = (int)floorf(sg), pb = (int)floorf(sb);
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
  const int top = C.m - 1;
  const int cr[2] = {pr >> 1, min((pr >> 1) + 1, top)};
  const int cg[2] = {pg >> 1, min((pg >> 1) + 1, top)};
  const int cb[2] = {pb >> 1, min((pb >> 1) + 1, top)};
  const F32Corners corner{C.coarse, C.m};
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int k = 0; k < 2; ++k)
        acc = acc + w[i][j][k] * corner(cr[i], cg[j], cb[k]);
  return acc;
}

__device__ __forceinline__ float4 lut_apply(const Coarse2Args& C, int interp,
                                            float r, float g, float b) {
  const float sr = scaled_coord(r, C.dmin[0], C.dmax[0], C.n);
  const float sg = scaled_coord(g, C.dmin[1], C.dmax[1], C.n);
  const float sb = scaled_coord(b, C.dmin[2], C.dmax[2], C.n);
  const float4 resid = interp_cell(ResidCorners{C.resid, C.rscale, C.n},
                                   C.resid_interp, sr, sg, sb, C.n - 1);
  return coarse_term(C, interp, sr, sg, sb) + resid;
}

}  // namespace lutk

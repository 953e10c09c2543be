// 3D-LUT interpolation in FFmpeg lut3d semantics, shared by kernel B
// (fused420.cuh) and kernels A and C (planar_lut.cuh).
//
// interp_cell follows colorcore/interp.py op for op: the domain mapping of
// _prepare, PREV/NEXT/NEAR, FFmpeg's strict-comparison case splits, and the
// same left-to-right evaluation order of each weighted sum. The library is
// built with -fmad=false, so no multiply-add is contracted and each
// operation rounds like the NumPy and PyTorch versions do.
//
// The interpolation is a template parameter: each kernel instantiates one
// kernel per interp. The tetrahedral case split is selects, not branches,
// so that the lanes of a warp in different tetrahedra run one instruction
// stream. Kernel B evaluates a pixel through lut_apply; kernels A and C
// take interp_cell apart (planar_lut.cuh: corners, loads, sums) with the
// same operations, and share its pieces below.
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
  int unit;  // the domain is [0, 1] on every axis
  float dmin[3];
  float dmax[3];
};

struct Coarse2Args {
  const float4* coarse;  // (m, m, m, 4) f32: dequantised coarse + identity
  const char4* resid;    // (n, n, n, 4) int8 residual
  const float4* rscale;  // (n, 4) f32: residual scale of (r index, channel);
                         // global or shared memory
  int n;
  int m;
  int resid_interp;  // the residual term's interp (trilinear for _tri)
  int unit;
  float dmin[3];
  float dmax[3];
};

// The domain of either table kind, and whether it is [0, 1] on every axis.
template <class Args>
__device__ __forceinline__ void set_domain(Args& a, const float* dmin,
                                           const float* dmax) {
  a.unit = 1;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    a.dmin[i] = dmin[i];
    a.dmax[i] = dmax[i];
    a.unit &= dmin[i] == 0.0f && dmax[i] == 1.0f;
  }
}

__device__ __forceinline__ float clip01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

// floorf(x) and (int)floorf(x) for 0 <= x < 2^23 (or x = -0), from two f32
// adds and an integer subtraction: x + 2^23 rounded toward zero holds
// trunc(x) = floor(x) in its low mantissa bits. Bit-equal to the two
// conversions it replaces, which run at a quarter of the f32 rate on the
// card's conversion pipe.
struct Floor {
  float f;
  int i;
};

__device__ __forceinline__ Floor floor_nonneg(float x) {
  const float t = __fadd_rz(x, 8388608.0f);
  return {t - 8388608.0f, __float_as_int(t) - 0x4B000000};
}

// corner fetchers: (r, g, b) grid indices -> the table value there
struct F32Corners {
  const float4* table;
  int n;
  __device__ __forceinline__ float4 operator()(int r, int g, int b) const {
    return __ldg(table + ((r * n + g) * n + b));
  }
};

// (float)v for the int8 in byte k of w ^ 0x80808080 (v + 128): 2^23 + v +
// 128 assembled in the bits, less 2^23 + 128, both exact. One byte
// permute and one add in place of a conversion.
__device__ __forceinline__ float int8_to_float(unsigned int biased, int k) {
  return __int_as_float(__byte_perm(biased, 0x4B000000u, 0x7540 + k)) -
         8388736.0f;
}

// The residual of one cell: the scale depends only on the corner's r
// index, so it is read once for each of the cell's two r lines (r_lo and
// its clamped next) and selected per corner.
struct ResidCorners {
  const char4* q;
  int n;
  int r_lo;
  float4 s_lo;
  float4 s_hi;
  __device__ __forceinline__ float4 operator()(int r, int g, int b) const {
    const unsigned int v =
        __ldg((const unsigned int*)(q + ((r * n + g) * n + b))) ^ 0x80808080u;
    const float4 s = r == r_lo ? s_lo : s_hi;
    return make_float4(int8_to_float(v, 0) * s.x, int8_to_float(v, 1) * s.y,
                       int8_to_float(v, 2) * s.z, 0.0f);
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

// interp._prepare: clip, map through the domain, clip, scale by N-1. On
// the [0, 1] domain clip01((clip01(x) - 0) / 1) is clip01(x) bit for bit,
// so the division is skipped.
__device__ __forceinline__ float scaled_coord(float x, float dmin, float dmax,
                                              int n, int unit) {
  const float t = unit ? clip01(x) : clip01((clip01(x) - dmin) / (dmax - dmin));
  return t * (float)(n - 1);
}

// FFmpeg's tetrahedral cases, strict '>', as one form: with the deltas
// sorted x >= y >= z, the corners 000, A (one step along x's axis), B (A
// plus one step along y's axis) and 111 weigh (1 - x), (x - y), (y - z)
// and z. Each of the six cases of colorcore.interp has this form and this
// order of evaluation, ties included.
struct Tetra {
  float x, y, z;
  bool ar, ag, ab;  // A's axis
  bool br, bg, bb;  // B's axes (all but z's)
};

__device__ __forceinline__ Tetra tetra_case(float dr, float dg, float db) {
  const bool rg = dr > dg, gb = dg > db, rb = dr > db, bgt = db > dg,
             brt = db > dr;
  Tetra t;
  // x: r in cases 1-2 (dr > dg, and dg > db or dr > db), g in 5-6
  t.ar = rg && (gb || rb);
  t.ag = !rg && !bgt;
  t.ab = !t.ar && !t.ag;
  // z: b in cases 1 and 6, g in 2-3, r in 4-5
  const bool zg = rg && !gb;
  const bool zr = !rg && (bgt || brt);
  const bool zb = !zg && !zr;
  const bool yr = !t.ar && !zr, yg = !t.ag && !zg;
  t.x = t.ar ? dr : (t.ag ? dg : db);
  t.y = yr ? dr : (yg ? dg : db);
  t.z = zr ? dr : (zg ? dg : db);
  t.br = !zr;
  t.bg = !zg;
  t.bb = !zb;
  return t;
}

// The interpolation of the grid cell at scaled coordinates (sr, sg, sb),
// reading corners through `corner`; top = N - 1.
template <int INTERP, class Corner>
__device__ __forceinline__ float4 interp_cell(const Corner& corner, float sr,
                                              float sg, float sb, int top) {
  if constexpr (INTERP == kNearest) {
    // NEAR(x) = trunc(x + 0.5), clipped to the grid
    int ir = min(max(floor_nonneg(sr + 0.5f).i, 0), top);
    int ig = min(max(floor_nonneg(sg + 0.5f).i, 0), top);
    int ib = min(max(floor_nonneg(sb + 0.5f).i, 0), top);
    return corner(ir, ig, ib);
  } else {
    const Floor fr = floor_nonneg(sr), fg = floor_nonneg(sg),
                fb = floor_nonneg(sb);
    const int r0 = fr.i, g0 = fg.i, b0 = fb.i;
    const int r1 = min(r0 + 1, top), g1 = min(g0 + 1, top),
              b1 = min(b0 + 1, top);
    const float dr = sr - fr.f, dg = sg - fg.f, db = sb - fb.f;

    if constexpr (INTERP == kTrilinear) {
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
    } else if constexpr (INTERP == kPyramid) {
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
    } else if constexpr (INTERP == kPrism) {
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
    } else {  // tetrahedral (also every unknown name)
      const Tetra t = tetra_case(dr, dg, db);
      const float4 c000 = corner(r0, g0, b0), c111 = corner(r1, g1, b1);
      const float4 ca = corner(t.ar ? r1 : r0, t.ag ? g1 : g0, t.ab ? b1 : b0);
      const float4 cb = corner(t.br ? r1 : r0, t.bg ? g1 : g0, t.bb ? b1 : b0);
      return (1.0f - t.x) * c000 + (t.x - t.y) * ca + (t.y - t.z) * cb +
             t.z * c111;
    }
  }
}

template <int INTERP>
__device__ __forceinline__ float4 lut_apply(const LutArgs& L, float r,
                                            float g, float b) {
  return interp_cell<INTERP>(
      F32Corners{L.table, L.n},
      scaled_coord(r, L.dmin[0], L.dmax[0], L.n, L.unit),
      scaled_coord(g, L.dmin[1], L.dmax[1], L.n, L.unit),
      scaled_coord(b, L.dmin[2], L.dmax[2], L.n, L.unit), L.n - 1);
}

// ---------------------------------------------------------------------------
// coarse + residual: interp(L) = interp(U(C)) + interp(R)
// ---------------------------------------------------------------------------

// The interp's weights on the 8 corners of the fine cell, w[i][j][k] for
// corner (r0 + i, g0 + j, b0 + k), the next index clamped to the grid as in
// interp_cell. The same cases and strict comparisons as interp_cell.
template <int INTERP>
__device__ __forceinline__ void cell_weights(float sr, float sg, float sb,
                                             int top, float w[2][2][2]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) (&w[0][0][0])[i] = 0.0f;
  const Floor fr = floor_nonneg(sr), fg = floor_nonneg(sg),
              fb = floor_nonneg(sb);
  const int r0 = fr.i, g0 = fg.i, b0 = fb.i;
  const float dr = sr - fr.f, dg = sg - fg.f, db = sb - fb.f;

  if constexpr (INTERP == kNearest) {
    // NEAR(x) = trunc(x + 0.5): the prev or the next corner of the cell
    const int ir = min(max(floor_nonneg(sr + 0.5f).i, 0), top) - r0;
    const int ig = min(max(floor_nonneg(sg + 0.5f).i, 0), top) - g0;
    const int ib = min(max(floor_nonneg(sb + 0.5f).i, 0), top) - b0;
    // selects, not w[ir][ig][ib]: a runtime index would put w in local
    // memory
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int k = 0; k < 2; ++k)
          w[i][j][k] = (i == ir && j == ig && k == ib) ? 1.0f : 0.0f;
  } else if constexpr (INTERP == kTrilinear) {
    const float wr[2] = {1.0f - dr, dr}, wg[2] = {1.0f - dg, dg};
    const float wb[2] = {1.0f - db, db};
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int k = 0; k < 2; ++k) w[i][j][k] = wr[i] * wg[j] * wb[k];
  } else if constexpr (INTERP == kPyramid) {
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
  } else if constexpr (INTERP == kPrism) {
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
  } else {  // tetrahedral (also every unknown name), one form as above
    const Tetra t = tetra_case(dr, dg, db);
    const float wa = t.x - t.y, wb = t.y - t.z;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const bool is_a = i == t.ar && j == t.ag && k == t.ab;
          const bool is_b = i == t.br && j == t.bg && k == t.bb;
          w[i][j][k] = is_a ? wa : (is_b ? wb : 0.0f);
        }
    w[0][0][0] = 1.0f - t.x;
    w[1][1][1] = t.z;
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
template <int INTERP>
__device__ __forceinline__ float4 coarse_term(const Coarse2Args& C, float sr,
                                              float sg, float sb) {
  float w[2][2][2];
  cell_weights<INTERP>(sr, sg, sb, C.n - 1, w);
  const int pr = floor_nonneg(sr).i, pg = floor_nonneg(sg).i,
            pb = floor_nonneg(sb).i;
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

template <int INTERP>
__device__ __forceinline__ float4 lut_apply(const Coarse2Args& C, float r,
                                            float g, float b) {
  const float sr = scaled_coord(r, C.dmin[0], C.dmax[0], C.n, C.unit);
  const float sg = scaled_coord(g, C.dmin[1], C.dmax[1], C.n, C.unit);
  const float sb = scaled_coord(b, C.dmin[2], C.dmax[2], C.n, C.unit);
  const int r0 = floor_nonneg(sr).i;
  const ResidCorners rc{C.resid, C.n, r0, C.rscale[r0],
                        C.rscale[min(r0 + 1, C.n - 1)]};
  // the residual's interp is the render's own or, under a _tri tier,
  // trilinear
  const float4 resid =
      C.resid_interp == kTrilinear
          ? interp_cell<kTrilinear>(rc, sr, sg, sb, C.n - 1)
          : interp_cell<INTERP>(rc, sr, sg, sb, C.n - 1);
  return coarse_term<INTERP>(C, sr, sg, sb) + resid;
}

}  // namespace lutk

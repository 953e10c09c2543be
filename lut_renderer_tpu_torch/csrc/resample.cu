// The resample: swscale's bicubic resize of one plane of a frame stack,
// (frames, h, w) float32 -> (frames, oh, ow), as two banded passes.
//
// Replaces no TPU kernel: the JAX package computes the resample as two
// dense einsums outside any Pallas kernel (lut_renderer_tpu/ops/
// resample.py::resample_plane), and the port ran them as dense cuBLAS
// products, 12 a 4K batch of two, multiplying by zero almost everywhere (a
// 2:1 downscale has 8 non-zero weights a row of 2160 or 3840). Here each
// weight matrix comes as a band (ops/resample.py Band): a start column and
// K taps an output row.
//
// Bound on Hopper: device memory. The taps are few (8 at 2:1 down, 4 up),
// so reading the plane once and writing the result once sets the least
// time. Design: a block owns an output tile. It stages the tile's input
// window (the tile times the ratio, plus the taps) into shared memory with
// cp.async copies, 16 bytes each where the rows allow; runs the vertical
// pass into an f32 intermediate in shared memory; then the horizontal pass
// out of it, its taps stored transposed so that neighbouring outputs read
// neighbouring banks. The (oh, w) intermediate never reaches device
// memory. Tile, window and taps come from the band and the shapes
// (ops/resample.py geometry): one algorithm for every ratio. Where no
// tile's whole window fits, a 1x1 tile stages its window in chunks of rows
// and carries its vertical sums across them in shared memory.
//
// Arithmetic, as the plain version (resample_plane_reference): the
// vertical pass first, rounded to f32, then the horizontal pass, each sum
// over the slots in ascending order from 0, every multiply and add rounded
// on its own (__fmul_rn, __fadd_rn). So the kernel equals it bit for bit,
// whatever the TF32 setting, and a frame's result does not depend on the
// batch.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

// The launch: mirrored by ops/resample.py _ResampleParams.
struct ResampleParams {
  const float* x;        // (frames, h, w)
  float* out;            // (frames, oh, ow)
  const int* v_start;    // (oh,) first input row of each output row
  const float* v_taps;   // (oh, kv)
  const int* h_start;    // (ow,) first input column of each output column
  const float* h_taps;   // (ow, kh)
  long long frames;
  int h;
  int w;
  int oh;
  int ow;
  int kv;
  int kh;
  int tile_h;   // output rows a block
  int tile_w;   // output columns a block
  int win_h;    // input rows of the largest window of a tile
  int win_w;    // its columns, a multiple of 4 (the row pitch)
  int chunk_h;  // window rows staged at once
  int vec;      // x 16-byte aligned and w a multiple of 4
};

namespace {

constexpr int kThreads = 256;              // ops/resample.py THREADS
constexpr size_t kSmemBytes = 48 * 1024;   // ops/resample.py SMEM_BYTES
constexpr long long kMaxGridYZ = 65535;    // row tiles, frames

// A block's shared memory, as ops/resample.py smem_bytes: the staged rows,
// the vertical sums, the tile's taps and starts.
size_t smem_bytes(const ResampleParams& p) {
  return sizeof(float) *
         ((size_t)(p.chunk_h + p.tile_h) * p.win_w + (size_t)p.tile_h * p.kv +
          (size_t)p.tile_w * p.kh + p.tile_h + p.tile_w);
}

// Copy rows [0, n) x columns [0, cols) of x (row stride w) into win (row
// stride pitch), asynchronously, then wait for this thread's copies.
__device__ __forceinline__ void stage_rows(float* win, int pitch,
                                           const float* x, int w, int n,
                                           int cols, int vec) {
  const int unit = vec ? 4 : 1;
  const int q = cols / unit;  // units a row
  const int tid = threadIdx.x;
  int r = tid / q;
  int c = tid - r * q;
  while (r < n) {
    float* dst = win + r * pitch + c * unit;
    const float* src = x + (long long)r * w + c * unit;
    if (vec) {
      __pipeline_memcpy_async(dst, src, 16);
    } else {
      __pipeline_memcpy_async(dst, src, 4);
    }
    c += kThreads;
    while (c >= q) {
      c -= q;
      ++r;
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
}

__global__ void __launch_bounds__(kThreads)
    resample_banded_gemm_kernel(const ResampleParams p) {
  extern __shared__ float smem[];
  const int pitch = p.win_w;
  float* win = smem;                      // chunk_h x pitch: input rows
  float* mid = win + p.chunk_h * pitch;   // tile_h x pitch: vertical sums
  float* vt = mid + p.tile_h * pitch;     // tile_h x kv
  float* ht = vt + p.tile_h * p.kv;       // kh x tile_w (a tap's row)
  int* vs = reinterpret_cast<int*>(ht + p.tile_w * p.kh);  // tile_h
  int* hs = vs + p.tile_h;                                 // tile_w

  const int z = blockIdx.z;  // the frame
  const int i0 = blockIdx.y * p.tile_h;
  const int j0 = blockIdx.x * p.tile_w;
  const int th = min(p.tile_h, p.oh - i0);
  const int tw = min(p.tile_w, p.ow - j0);
  const int r0 = __ldg(p.v_start + i0);
  const int c0 = __ldg(p.h_start + j0) & (p.vec ? ~3 : ~0);
  const int rows = min(p.win_h, p.h - r0);
  const int cols = min(p.win_w, p.w - c0);
  const float* x = p.x + ((long long)z * p.h + r0) * (long long)p.w + c0;

  const int tid = threadIdx.x;
  for (int t = tid; t < th * p.kv; t += kThreads) {
    vt[t] = __ldg(p.v_taps + (long long)i0 * p.kv + t);
  }
  // transposed, so that neighbouring outputs read neighbouring banks
  for (int t = tid; t < tw * p.kh; t += kThreads) {
    const int j = t / p.kh;
    ht[(t - j * p.kh) * p.tile_w + j] =
        __ldg(p.h_taps + (long long)j0 * p.kh + t);
  }
  for (int t = tid; t < th; t += kThreads) {
    vs[t] = __ldg(p.v_start + i0 + t) - r0;
  }
  for (int t = tid; t < tw; t += kThreads) {
    hs[t] = __ldg(p.h_start + j0 + t) - c0;
  }
  __syncthreads();
  const int cend = hs[tw - 1] + p.kh;  // columns the horizontal pass reads

  // the vertical pass, a chunk of window rows at a time: each sum (i, c)
  // adds the slots whose rows lie in the chunk; the first chunk that holds
  // any of them holds slot 0 and starts the sum
  for (int r_lo = 0; r_lo < rows; r_lo += p.chunk_h) {
    const int n = min(p.chunk_h, rows - r_lo);
    stage_rows(win, pitch, x + (long long)r_lo * p.w, p.w, n, cols, p.vec);
    __syncthreads();
    int i = tid / cend;
    int c = tid - i * cend;
    while (i < th) {
      const int lo = max(0, r_lo - vs[i]);
      const int hi = min(p.kv, r_lo + n - vs[i]);
      if (lo < hi) {
        const float* tap = vt + i * p.kv;
        const float* src = win + (vs[i] + lo - r_lo) * pitch + c;
        float acc = lo == 0 ? 0.f : mid[i * pitch + c];
        for (int k = lo; k < hi; ++k, src += pitch) {
          acc = __fadd_rn(acc, __fmul_rn(tap[k], *src));
        }
        mid[i * pitch + c] = acc;
      }
      c += kThreads;
      while (c >= cend) {
        c -= cend;
        ++i;
      }
    }
    __syncthreads();
  }

  // the horizontal pass out of the vertical sums
  float* out = p.out + ((long long)z * p.oh + i0) * p.ow + j0;
  int i = tid / tw;
  int j = tid - i * tw;
  while (i < th) {
    const float* src = mid + i * pitch + hs[j];
    float acc = 0.f;
    for (int k = 0; k < p.kh; ++k) {
      acc = __fadd_rn(acc, __fmul_rn(ht[k * p.tile_w + j], src[k]));
    }
    out[(long long)i * p.ow + j] = acc;
    j += kThreads;
    while (j >= tw) {
      j -= tw;
      ++i;
    }
  }
}

}  // namespace

extern "C" __attribute__((visibility("default"))) int resample_launch(
    const ResampleParams* p, void* stream) {
  if (p->frames <= 0) return 0;
  if (p->tile_h < 1 || p->tile_w < 1 || p->chunk_h < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const long long row_tiles = (p->oh + p->tile_h - 1) / p->tile_h;
  const size_t smem = smem_bytes(*p);
  if (p->frames > kMaxGridYZ || row_tiles > kMaxGridYZ || smem > kSmemBytes ||
      p->win_w % 4 != 0 ||
      (p->vec && (p->w % 4 != 0 ||
                  reinterpret_cast<unsigned long long>(p->x) % 16 != 0))) {
    return (int)cudaErrorInvalidValue;
  }
  dim3 grid((unsigned)((p->ow + p->tile_w - 1) / p->tile_w),
            (unsigned)row_tiles, (unsigned)p->frames);
  resample_banded_gemm_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      *p);
  return (int)cudaGetLastError();
}

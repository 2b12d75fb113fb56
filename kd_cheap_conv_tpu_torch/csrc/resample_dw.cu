// The decoder's bilinear upsample and the depthwise conv, forward and backward.
//
// Replaces the Pallas kernels of kd_cheap_conv_tpu/ops/pallas/:
//   _k_up_fwd (upsample.py:85, pallas_call :143)           -> up_fwd_kernel<T>
//   _k_up_bwd (upsample.py:99, pallas_call :186)           -> up_bwd_kernel<T>
//   _k_dw_fwd, _k_dw_dx (dwconv.py:79, :89; :164, :246),
//   _k_conv (dwhwnc.py:119; :174)                          -> dw_conv_kernel<T, K>
//   _k_dw_dk (dwconv.py:98; :185), _k_dk (dwhwnc.py:124; :217) -> dw_dk_kernel<T, K>
// (dwconv.py and dwhwnc.py are one computation in two TPU layouts; both read
// NHWC here.)
//
// What they compute (activations NHWC, unpadded):
// - up_fwd: the half-pixel bilinear upsample (align_corners=False) from the
//   host tables of ops/upsample.py: per output row two (input row, f32
//   weight) taps, per output column two (input column, weight rounded to
//   the activation dtype) taps; where both taps of an axis clip onto one
//   index the table holds the summed weight and a zero. The rounding points
//   are the JAX kernel's: z = w0 x[r0] + w1 x[r1] in f32, rounded to the
//   activation dtype; y = m0 z[c0] + m1 z[c1] in f32, rounded once.
// - up_bwd: the transposed interpolation in gather form (no atomics): each
//   input pixel sums its own output taps from the per-input lists (output
//   index, weight; -1 ends a list): u = sum m g over the column list in f32,
//   not rounded; gx = sum w u over the row list in f32, rounded once.
// - dw_conv: the depthwise K x K conv, stride 1, dilation d, pad d (K - 1) / 2,
//   taps (K*K, C) f32; out-of-image taps are skipped (they read zero in the
//   JAX kernels, which pad the input). With flip set, tap t reads taps row
//   K*K - 1 - t: the input gradient. Inputs and taps widened to f32, the
//   taps summed in the JAX kernel's order (row-major), rounded once.
// - dw_dk: dk[t][c] = sum over pixels of x[tap t] * g in f32, as CTA partials
//   (grid.x, K*K, C) that the wrapper sums in a fixed order.
// The upsample and conv products and sums are separate roundings (no FMA
// contraction), as the plain versions' torch ops round them, so the kernels
// give the plain versions' values bit for bit.
//
// Determinism: no float atomics. A dk sum has one owner (a thread's register,
// then a fixed butterfly across the eight pixel lanes of its warp) and is
// written as its CTA's partial; the grid depends on the shape only.
//
// What bounds them on an H100: about nine multiply-adds per element moved,
// far below the card's FLOP/byte balance, so all four are bound by HBM bytes:
// the design reads each input through 16-byte channel-group loads with
// neighbouring threads on neighbouring channel groups, keeps the taps and the
// sums in registers, and writes each output once (the upsample's 16x larger
// output dominates its traffic). The re-reads of the halo and of the
// upsample's 2x2 neighbourhood come from L1/L2. A simple first version:
// no shared-memory staging, no pipelining.
//
// The C entry points launch on the caller's stream and return
// cudaGetLastError(); the Python wrapper raises if it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStrip = 4;       // dw_conv: output columns per thread
constexpr int kLanes = 8;       // dw_dk: pixel lanes per channel group (in a warp)
constexpr int kDkGroups = 32;   // dw_dk: channel groups per CTA (8 warps x 4)
constexpr int kDkPixels = 256;  // dw_dk: pixels per CTA (its partial)

__device__ __forceinline__ float mul_add(float acc, float a, float b) {
  return __fadd_rn(acc, __fmul_rn(a, b));
}

// ---------------------------------------------------------------------------
// up_fwd: one thread per (output pixel, 8-channel group)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
up_fwd_kernel(const T* __restrict__ x, const int* __restrict__ rows,
              const float* __restrict__ rw, const int* __restrict__ cols,
              const float* __restrict__ cw, T* __restrict__ y, int n, int hi, int wi, int ho,
              int wo, int c) {
  const int groups = c / 8;
  const long long total = (long long)n * ho * wo * groups;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const int g = (int)(i % groups);
  const long long pix = i / groups;
  const int ox = (int)(pix % wo), oy = (int)((pix / wo) % ho), img = (int)(pix / ((long long)wo * ho));
  const int r0 = rows[2 * oy], r1 = rows[2 * oy + 1], c0 = cols[2 * ox], c1 = cols[2 * ox + 1];
  const float a0 = rw[2 * oy], a1 = rw[2 * oy + 1], b0 = cw[2 * ox], b1 = cw[2 * ox + 1];
  const T* base = x + (size_t)img * hi * wi * c + 8 * g;
  float x00[8], x10[8], x01[8], x11[8], out[8];
  load8<T>(base + ((size_t)r0 * wi + c0) * c, x00);
  load8<T>(base + ((size_t)r1 * wi + c0) * c, x10);
  load8<T>(base + ((size_t)r0 * wi + c1) * c, x01);
  load8<T>(base + ((size_t)r1 * wi + c1) * c, x11);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float z0 = rounded<T>(__fadd_rn(__fmul_rn(a0, x00[e]), __fmul_rn(a1, x10[e])));
    const float z1 = rounded<T>(__fadd_rn(__fmul_rn(a0, x01[e]), __fmul_rn(a1, x11[e])));
    out[e] = __fadd_rn(__fmul_rn(b0, z0), __fmul_rn(b1, z1));
  }
  store8<T>(y + (size_t)pix * c + 8 * g, out);
}

// ---------------------------------------------------------------------------
// up_bwd: one thread per (input pixel, 8-channel group), gathering its output
// taps: rlist/rlw (hi, lr) over output rows, clist/clw (wi, lc) over columns
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
up_bwd_kernel(const T* __restrict__ g, const int* __restrict__ rlist,
              const float* __restrict__ rlw, int lr, const int* __restrict__ clist,
              const float* __restrict__ clw, int lc, T* __restrict__ gx, int n, int hi, int wi,
              int ho, int wo, int c) {
  const int groups = c / 8;
  const long long total = (long long)n * hi * wi * groups;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const int cg = (int)(i % groups);
  const long long pix = i / groups;
  const int ix = (int)(pix % wi), iy = (int)((pix / wi) % hi), img = (int)(pix / ((long long)wi * hi));
  const T* base = g + (size_t)img * ho * wo * c + 8 * cg;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int j = 0; j < lr; ++j) {
    const int ro = rlist[iy * lr + j];
    if (ro < 0) break;
    const float wr = rlw[iy * lr + j];
    float u[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int q = 0; q < lc; ++q) {
      const int co = clist[ix * lc + q];
      if (co < 0) break;
      const float m = clw[ix * lc + q];
      float gv[8];
      load8<T>(base + ((size_t)ro * wo + co) * c, gv);
#pragma unroll
      for (int e = 0; e < 8; ++e) u[e] = mul_add(u[e], m, gv[e]);
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = mul_add(acc[e], wr, u[e]);
  }
  store8<T>(gx + (size_t)pix * c + 8 * cg, acc);
}

// ---------------------------------------------------------------------------
// dw_conv: one thread per (row strip of kStrip output pixels, 8-channel group);
// each tap's eight weights are loaded once for the strip
// ---------------------------------------------------------------------------

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
dw_conv_kernel(const T* __restrict__ x, const float* __restrict__ taps, T* __restrict__ y,
               int n, int h, int w, int c, int dil, int flip) {
  const int groups = c / 8, strips = (w + kStrip - 1) / kStrip;
  const long long total = (long long)n * h * strips * groups;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const int cg = (int)(i % groups);
  const long long rest = i / groups;
  const int sx = (int)(rest % strips), oy = (int)((rest / strips) % h);
  const int img = (int)(rest / ((long long)strips * h)), ox0 = sx * kStrip;
  const T* base = x + (size_t)img * h * w * c + 8 * cg;
  float acc[kStrip][8];
#pragma unroll
  for (int s = 0; s < kStrip; ++s)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[s][e] = 0.f;
#pragma unroll
  for (int ti = 0; ti < K; ++ti) {
    const int yy = oy + (ti - K / 2) * dil;
    if (yy < 0 || yy >= h) continue;
#pragma unroll
    for (int tj = 0; tj < K; ++tj) {
      const int t = flip ? K * K - 1 - (ti * K + tj) : ti * K + tj;
      float kv[8];
      load8<float>(taps + (size_t)t * c + 8 * cg, kv);
#pragma unroll
      for (int s = 0; s < kStrip; ++s) {
        const int xx = ox0 + s + (tj - K / 2) * dil;
        if (ox0 + s >= w || xx < 0 || xx >= w) continue;
        float xv[8];
        load8<T>(base + ((size_t)yy * w + xx) * c, xv);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[s][e] = mul_add(acc[s][e], xv[e], kv[e]);
      }
    }
  }
#pragma unroll
  for (int s = 0; s < kStrip; ++s)
    if (ox0 + s < w) store8<T>(y + (((size_t)img * h + oy) * w + ox0 + s) * c + 8 * cg, acc[s]);
}

// ---------------------------------------------------------------------------
// dw_dk: grid (pixel chunks of kDkPixels, blocks of kDkGroups channel groups,
// K tap rows). A warp holds 4 channel groups x kLanes pixel lanes; each
// thread sums its tap row's K taps x 8 channels over every kLanes-th pixel
// of the chunk, then the lanes' sums meet in a fixed butterfly.
// ---------------------------------------------------------------------------

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
dw_dk_kernel(const T* __restrict__ x, const T* __restrict__ g, float* __restrict__ partial,
             int n, int h, int w, int c, int dil) {
  const int lane = threadIdx.x & 31, pl = lane % kLanes;
  const int cg = blockIdx.y * kDkGroups + (threadIdx.x >> 5) * (32 / kLanes) + lane / kLanes;
  const int ti = blockIdx.z, groups = c / 8;
  const int P = n * h * w, p0 = blockIdx.x * kDkPixels, p1 = min(P, p0 + kDkPixels);
  float acc[K][8];
#pragma unroll
  for (int tj = 0; tj < K; ++tj)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[tj][e] = 0.f;
  if (cg < groups) {
    for (int p = p0 + pl; p < p1; p += kLanes) {
      const int img = p / (h * w), py = (p / w) % h, px = p % w;
      const int yy = py + (ti - K / 2) * dil;
      if (yy < 0 || yy >= h) continue;
      float gv[8];
      load8<T>(g + (size_t)p * c + 8 * cg, gv);
      const T* row = x + ((size_t)img * h + yy) * w * c + 8 * cg;
#pragma unroll
      for (int tj = 0; tj < K; ++tj) {
        const int xx = px + (tj - K / 2) * dil;
        if (xx < 0 || xx >= w) continue;
        float xv[8];
        load8<T>(row + (size_t)xx * c, xv);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[tj][e] = fmaf(xv[e], gv[e], acc[tj][e]);
      }
    }
  }
#pragma unroll
  for (int tj = 0; tj < K; ++tj)
#pragma unroll
    for (int e = 0; e < 8; ++e)
#pragma unroll
      for (int off = kLanes / 2; off > 0; off /= 2)
        acc[tj][e] += __shfl_xor_sync(0xffffffffu, acc[tj][e], off);
  if (pl == 0 && cg < groups) {
#pragma unroll
    for (int tj = 0; tj < K; ++tj) {
      float* dst = partial + ((size_t)blockIdx.x * K * K + ti * K + tj) * c + 8 * cg;
      store8<float>(dst, acc[tj]);
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

int blocks(long long threads) { return (int)((threads + kThreads - 1) / kThreads); }

template <typename T>
cudaError_t run_up_fwd(const void* x, const void* rows, const void* rw, const void* cols,
                       const void* cw, void* y, int n, int hi, int wi, int ho, int wo, int c,
                       cudaStream_t st) {
  up_fwd_kernel<T><<<blocks((long long)n * ho * wo * (c / 8)), kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const int*>(rows), static_cast<const float*>(rw),
      static_cast<const int*>(cols), static_cast<const float*>(cw), static_cast<T*>(y), n, hi,
      wi, ho, wo, c);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_up_bwd(const void* g, const void* rlist, const void* rlw, int lr,
                       const void* clist, const void* clw, int lc, void* gx, int n, int hi,
                       int wi, int ho, int wo, int c, cudaStream_t st) {
  up_bwd_kernel<T><<<blocks((long long)n * hi * wi * (c / 8)), kThreads, 0, st>>>(
      static_cast<const T*>(g), static_cast<const int*>(rlist), static_cast<const float*>(rlw),
      lr, static_cast<const int*>(clist), static_cast<const float*>(clw), lc,
      static_cast<T*>(gx), n, hi, wi, ho, wo, c);
  return cudaGetLastError();
}

template <typename T, int K>
cudaError_t run_dw_conv(const void* x, const void* taps, void* y, int n, int h, int w, int c,
                        int dil, int flip, cudaStream_t st) {
  const long long threads = (long long)n * h * ((w + kStrip - 1) / kStrip) * (c / 8);
  dw_conv_kernel<T, K><<<blocks(threads), kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(taps), static_cast<T*>(y), n, h, w,
      c, dil, flip);
  return cudaGetLastError();
}

template <typename T, int K>
cudaError_t run_dw_dk(const void* x, const void* g, void* partial, int n, int h, int w, int c,
                      int dil, int grid, cudaStream_t st) {
  const dim3 dims(grid, (c / 8 + kDkGroups - 1) / kDkGroups, K);
  dw_dk_kernel<T, K><<<dims, kThreads, 0, st>>>(static_cast<const T*>(x),
                                               static_cast<const T*>(g),
                                               static_cast<float*>(partial), n, h, w, c, dil);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dw_conv_k(int k, const void* x, const void* taps, void* y, int n, int h, int w,
                      int c, int dil, int flip, cudaStream_t st) {
  switch (k) {
    case 3: return run_dw_conv<T, 3>(x, taps, y, n, h, w, c, dil, flip, st);
    case 5: return run_dw_conv<T, 5>(x, taps, y, n, h, w, c, dil, flip, st);
    case 7: return run_dw_conv<T, 7>(x, taps, y, n, h, w, c, dil, flip, st);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dw_dk_k(int k, const void* x, const void* g, void* partial, int n, int h, int w,
                    int c, int dil, int grid, cudaStream_t st) {
  switch (k) {
    case 3: return run_dw_dk<T, 3>(x, g, partial, n, h, w, c, dil, grid, st);
    case 5: return run_dw_dk<T, 5>(x, g, partial, n, h, w, c, dil, grid, st);
    case 7: return run_dw_dk<T, 7>(x, g, partial, n, h, w, c, dil, grid, st);
  }
  return cudaErrorInvalidValue;
}

bool shape_ok(int n, int h, int w, int c) {
  return n >= 1 && h >= 1 && w >= 1 && c >= 8 && c % 8 == 0;
}

}  // namespace

extern "C" {

// Upsample, forward. x (n, hi, wi, c), y (n, ho, wo, c) in dtype (0 float32,
// 1 bfloat16); rows (ho, 2), cols (wo, 2) int32; rw (ho, 2), cw (wo, 2) f32.
int kdcc_up_fwd(int dtype, const void* x, const void* rows, const void* rw, const void* cols,
                const void* cw, void* y, int n, int hi, int wi, int ho, int wo, int c,
                void* stream) {
  if (!shape_ok(n, hi, wi, c) || ho < hi || wo < wi) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)run_up_fwd<float>(x, rows, rw, cols, cw, y, n, hi, wi, ho, wo, c, st);
  if (dtype == 1)
    return (int)run_up_fwd<__nv_bfloat16>(x, rows, rw, cols, cw, y, n, hi, wi, ho, wo, c, st);
  return (int)cudaErrorInvalidValue;
}

// Upsample, backward. g (n, ho, wo, c), gx (n, hi, wi, c) in dtype; rlist
// (hi, lr), clist (wi, lc) int32 (-1 ends a list); rlw, clw f32 alike.
int kdcc_up_bwd(int dtype, const void* g, const void* rlist, const void* rlw, int lr,
                const void* clist, const void* clw, int lc, void* gx, int n, int hi, int wi,
                int ho, int wo, int c, void* stream) {
  if (!shape_ok(n, hi, wi, c) || ho < hi || wo < wi || lr < 1 || lc < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)run_up_bwd<float>(g, rlist, rlw, lr, clist, clw, lc, gx, n, hi, wi, ho, wo, c,
                                  st);
  if (dtype == 1)
    return (int)run_up_bwd<__nv_bfloat16>(g, rlist, rlw, lr, clist, clw, lc, gx, n, hi, wi, ho,
                                          wo, c, st);
  return (int)cudaErrorInvalidValue;
}

// Depthwise conv (flip 0) or its input gradient (flip 1). x, y (n, h, w, c) in
// dtype; taps (k * k, c) f32; k 3, 5 or 7.
int kdcc_dw_conv(int dtype, const void* x, const void* taps, void* y, int n, int h, int w,
                 int c, int k, int dil, int flip, void* stream) {
  if (!shape_ok(n, h, w, c) || dil < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dw_conv_k<float>(k, x, taps, y, n, h, w, c, dil, flip, st);
  if (dtype == 1)
    return (int)dw_conv_k<__nv_bfloat16>(k, x, taps, y, n, h, w, c, dil, flip, st);
  return (int)cudaErrorInvalidValue;
}

// The x extent of dw_dk's grid on n * h * w pixels, by which the caller sizes
// the CTA partials.
int kdcc_dw_dk_grid(int n, int h, int w) {
  return (int)(((long long)n * h * w + kDkPixels - 1) / kDkPixels);
}

// Depthwise weight gradient. x, g (n, h, w, c) in dtype; partial (grid, k * k,
// c) f32, grid = kdcc_dw_dk_grid(n, h, w).
int kdcc_dw_dk(int dtype, const void* x, const void* g, void* partial, int n, int h, int w,
               int c, int k, int dil, int grid, void* stream) {
  if (!shape_ok(n, h, w, c) || dil < 1 || grid != kdcc_dw_dk_grid(n, h, w))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dw_dk_k<float>(k, x, g, partial, n, h, w, c, dil, grid, st);
  if (dtype == 1)
    return (int)dw_dk_k<__nv_bfloat16>(k, x, g, partial, n, h, w, c, dil, grid, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

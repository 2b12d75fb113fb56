// The separable conv's tile loop in float32: one depthwise k x k -> 1x1
// product per launch, shared by head_convs.cu `sep_fwd_f32_kernel` (the
// separable conv and pass P1 in float32) and xchain_eval.cu
// `xsep_eval_kernel` (the Xception eval chains' folded sep convs in
// float32). Both are parity variants: bfloat16 runs head_convs.cu's namespace
// spf and xchain_eval.cu's depthwise pass + wgmma product. Each kernel is a
// __global__ of its own that calls `sep_conv` with its options, so the
// profiler tells them apart.
//
// What it computes (NHWC, P = n * h * w pixels, the input the channel
// concatenation of x0 (c0) and x1 (c1), never built):
//   t[p, c] = sum_tap taps[tap, c] * act(x)[p + dil * (tap - centre), c]
//             (f32; zero outside each image; act = relu or none)
//   y[p, o] = [b[o] +] sum_c w[o, c] * t[p, c]
//             [+ res[p, o]]                                (identity residual)
//             [+ bsk[o] + sum_c wsk[o, c] * res[p, c]]     (1x1 skip, width cs)
//   y       = relu(y) if final_relu, stored in Tout
//   and, with a partial pointer, the per-channel sum and sum of squares of
//   the f32 product (before any bias) as the CTA's partial (2, co).
// t enters the product rounded to T. The taps' sums run in tap order with
// fmaf, the product in K order, so every option of a launch gives its
// output bit for bit.
//
// Design: flat tiles of kTP pixels x kNT output channels (gridDim.y chunks
// of Co), a CTA looping over tiles with stride gridDim.x. Per K chunk of
// kKC input channels a thread forms t for one pixel and 8 channels while
// staging (taps and x read through L1), the CTA stages the w chunk, then
// mma.cuh's WarpGemm multiplies (FMAs in the mma fragment layout for
// float32, mma.sync for bfloat16). The skip is a second K loop into the
// same accumulators. The tile then goes to shared memory (over the
// operands); the epilogue gives a thread 8 channels and every
// kGroupRows-th row. Staging is synchronous and serial with the products.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace {
namespace sepconv {

constexpr int kThreads = 256;
constexpr int kTP = 64;     // pixels per tile
constexpr int kKC = 32;     // input channels per K chunk
constexpr int kNT = 256;    // output channels per CTA (gridDim.y chunks)
constexpr int kMaxK = 7;    // widest depthwise kernel
// WarpGemm's warp grid: 1 x 8 warps, each a 4 x 4 block of 16 x 8 sub-tiles
constexpr int kMW = 4, kNW = 4, kSlots = kMW * kNW, kWN = kNT / 8 / kNW;
static_assert(kThreads / 32 == kMmaWarps && kTP / 16 == kMW && kWN == kMmaWarps,
              "warp grid");
static_assert(kTP * (kKC / 8) == kThreads, "staging: a thread per pixel and 8 channels");
constexpr int kGroups = kNT / 8, kGroupRows = kThreads / kGroups;   // epilogue

// dynamic shared memory: the operands (t, the w chunk), then the f32 tile
// over them
template <typename T> __host__ __device__ constexpr int smem_bytes() {
  return (kTP * (kNT + 4) * 4 > (kTP + kNT) * ld_of(kKC) * (int)sizeof(T))
             ? kTP * (kNT + 4) * 4
             : (kTP + kNT) * ld_of(kKC) * (int)sizeof(T);
}

// one launch's operands; Tin the input's type, T the operands', Tout y's
template <typename Tin, typename T, typename Tout> struct Args {
  const Tin* x0;        // (P, c0)
  const Tin* x1;        // (P, c1), or null with c1 = 0
  const float* taps;    // (k * k, c0 + c1)
  const T* w;           // (co, c0 + c1)
  const float* b;       // (co,) or null
  const T* res;         // residual 1: (P, co); 2: the skip's input (P, cs)
  const T* wsk;         // (co, cs) the skip's weight (residual 2)
  const float* bsk;     // (co,) its bias (residual 2)
  Tout* y;              // (P, co)
  float* partial;       // (gridDim.x, 2, co) moments, or null
  int n, h, w_, c0, c1, co, cs, k, dil;
  int pre_relu, residual, final_relu;   // residual 0 none, 1 identity, 2 skip
};

// the K chunk [k0, k0 + kKC) of rows co0 .. co0 + kNT of w (rows of kdim)
// -> bs [kNT][ld_of(kKC)], zero past ncols and kdim
template <typename T>
__device__ __forceinline__ void stage_w(T* bs, const T* __restrict__ w, int co0, int ncols,
                                        int k0, int kdim) {
  for (int i = threadIdx.x; i < kNT * (kKC / 8); i += kThreads) {
    const int row = i / (kKC / 8), cj = k0 + 8 * (i % (kKC / 8));
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (row < ncols && cj < kdim) load8<T>(w + (size_t)(co0 + row) * kdim + cj, v);
    store8<T>(bs + row * ld_of(kKC) + (cj - k0), v);
  }
}

template <typename Tin, typename T, typename Tout>
__device__ __forceinline__ void sep_conv(const Args<Tin, T, Tout>& a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int lda = ld_of(kKC), ldc = kNT + 4;
  T* as = reinterpret_cast<T*>(smem);          // [kTP][lda] t (or skip input) chunk
  T* bs = as + kTP * lda;                       // [kNT][lda] w chunk
  float* cs = reinterpret_cast<float*>(smem);   // [kTP][ldc] the tile, after the K loops
  const int ci = a.c0 + a.c1, hw = a.h * a.w_, P = a.n * hw, half = a.k / 2;
  const int tid = threadIdx.x, r = tid / (kKC / 8), j = tid % (kKC / 8);   // staging
  const int eg = tid % kGroups, er = tid / kGroups;                        // epilogue
  const int co0 = blockIdx.y * kNT, ncols = min(kNT, a.co - co0), nt = ncols / 8;
  const int ntiles = (P + kTP - 1) / kTP;
  // this thread's epilogue channels' bias and skip bias
  float bias[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float bsk[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (eg < nt)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if (a.b != nullptr) bias[e] = a.b[co0 + 8 * eg + e];
      if (a.residual == 2) bsk[e] = a.bsk[co0 + 8 * eg + e];
    }
  float s = 0.f, q = 0.f;   // moments of channel co0 + tid
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int p0 = tile * kTP, np = min(kTP, P - p0);
    const int p = p0 + r, img = p / hw, py = (p - img * hw) / a.w_;
    const int px = p - img * hw - py * a.w_;
    float acc[kSlots][4];
    zero(acc);
    for (int k0 = 0; k0 < ci; k0 += kKC) {
      const int c = k0 + 8 * j;
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (r < np && c < ci) {
        const Tin* src = c < a.c0 ? a.x0 + c : a.x1 + (c - a.c0);
        const int st = c < a.c0 ? a.c0 : a.c1;
        for (int ti = 0; ti < a.k; ++ti) {
          const int yy = py + (ti - half) * a.dil;
          if (yy < 0 || yy >= a.h) continue;
          for (int tj = 0; tj < a.k; ++tj) {
            const int xx = px + (tj - half) * a.dil;
            if (xx < 0 || xx >= a.w_) continue;
            float xv[8], kv[8];
            load8<Tin>(src + ((size_t)(img * a.h + yy) * a.w_ + xx) * st, xv);
            load8<float>(a.taps + (size_t)(ti * a.k + tj) * ci + c, kv);
#pragma unroll
            for (int e = 0; e < 8; ++e)
              v[e] = fmaf(kv[e], a.pre_relu ? fmaxf(xv[e], 0.f) : xv[e], v[e]);
          }
        }
      }
      store8<T>(as + r * lda + 8 * j, v);
      stage_w<T>(bs, a.w, co0, ncols, k0, ci);
      __syncthreads();
      WarpGemm<T, kMW, kNW, kWN>::run(acc, as, lda, bs, lda, nt, kKC);
      __syncthreads();
    }
    if (a.residual == 2)   // the 1x1 skip: a second K loop into the same sums
      for (int k0 = 0; k0 < a.cs; k0 += kKC) {
        const int c = k0 + 8 * j;
        float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        if (r < np && c < a.cs) load8<T>(a.res + (size_t)p * a.cs + c, v);
        store8<T>(as + r * lda + 8 * j, v);
        stage_w<T>(bs, a.wsk, co0, ncols, k0, a.cs);
        __syncthreads();
        WarpGemm<T, kMW, kNW, kWN>::run(acc, as, lda, bs, lda, nt, kKC);
        __syncthreads();
      }
    frags_to_smem<kMW, kNW, kWN>(acc, cs, ldc);
    __syncthreads();
    if (eg < nt)
      for (int row = er; row < np; row += kGroupRows) {
        const size_t at = (size_t)(p0 + row) * a.co + co0 + 8 * eg;
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = cs[row * ldc + 8 * eg + e];
        if (a.b != nullptr)
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] += bias[e];
        if (a.residual == 1) {
          float add[8];
          load8<T>(a.res + at, add);
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] += add[e];
        } else if (a.residual == 2) {
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] += bsk[e];
        }
        if (a.final_relu)
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = fmaxf(v[e], 0.f);
        store8<Tout>(a.y + at, v);
      }
    if (a.partial != nullptr && tid < ncols)
      for (int row = 0; row < np; ++row) {
        const float val = cs[row * ldc + tid];
        s += val;
        q = fmaf(val, val, q);
      }
    __syncthreads();
  }
  if (a.partial != nullptr && tid < ncols) {
    a.partial[(size_t)blockIdx.x * 2 * a.co + co0 + tid] = s;
    a.partial[((size_t)blockIdx.x * 2 + 1) * a.co + co0 + tid] = q;
  }
}

// sets the kernel's dynamic shared memory and launches it on st over
// `grid` CTAs along x (at most the tiles) and the chunks of Co along y
template <typename Tin, typename T, typename Tout, typename K>
cudaError_t launch(K kern, const Args<Tin, T, Tout>& a, int grid, cudaStream_t st) {
  constexpr int smem = smem_bytes<T>();
  static_assert(smem <= 232448, "an H100 CTA's shared memory");
  cudaError_t e = cudaFuncSetAttribute((const void*)kern,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(grid, (a.co + kNT - 1) / kNT), kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace sepconv
}  // namespace

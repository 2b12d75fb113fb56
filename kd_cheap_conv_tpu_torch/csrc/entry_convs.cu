// The config-#2 step's image entry: the student's entry conv inside the
// train-mode stem chain (forward, weight gradient, input gradient) and the
// teacher's eval stem + maxpool, each one kernel.
//
// Replaces the Pallas kernels of kd_cheap_conv_tpu/ops/pallas/:
//   _k_f0        (_run_f0, stem.py:466)                 -> f0_fwd_kernel
//   _k_f0_wgrad  (_run_f0_bwd, stem.py:531)             -> f0_wgrad_kernel
//   _k_f0_xgrad  (_run_f0_bwd, stem.py:531)             -> f0_xgrad_kernel
//   _k_tstem     (fused_stem_pool_eval_nhcw, tstem.py:134) -> tstem_kernel
//
// The functions are the JAX kernels', not their TPU layout. The JAX kernels
// read a host-packed space-to-depth image (channel-sublane NHCW, a zero
// margin) and contract it with lane rolls and 0/1 selection matmuls; here
// every kernel reads the NHWC image with the stride in its index, and the
// packing, an exact permutation of the image, is not needed.
//
// f0 (MobileNetV2 features[0].conv, 3x3 / stride 2 / pad 1, 3 -> C0):
// - forward: a0 = conv(x, w0) in f32 from operands in the activation dtype
//   (x and w0 as stored), a0 written in that dtype, and per CTA the sum and
//   sum of squares of the f32 accumulator per channel (before rounding), for
//   bn0's batch moments;
// - weight gradient: ga = the train-mode BN backward of bn0 applied to gy0
//   (the dw1 backward link's output, relu6' already applied), pack (mean,
//   var, gamma, Sg, Sgx, 1/M), rounded to the activation dtype; dW0[c][k] =
//   sum over output pixels of ga[c] * x-window[k], f32, per CTA;
// - input gradient: dx[y][x] = sum over the taps that reach (y, x) of
//   w0 * ga, with ga recomputed from gy0 and a0: output row
//   h = (y + 1 - dh) / 2 where that is an integer in [0, Ho), likewise the
//   column.
// teacher stem (ResNet stem.conv 7x7 / stride 2 / pad 3, 3 -> 64, eval BN
// folded into the weight and a bias by the wrapper, relu, then maxpool 3x3 /
// stride 2 / pad 1 with -inf padding): a tile of pooled outputs per CTA,
// its conv rows and columns (one of halo on each side) computed into shared
// memory and pooled from there. The pool takes the max of values rounded to
// the output dtype, which equals rounding the max (rounding is monotone).
//
// Determinism: no float atomics. bn0's moments and dW0 are register sums of
// one fixed owner thread, reduced across the CTA in a fixed order and
// written as the CTA's partial; the wrapper sums the partials in a fixed
// order, and the grid depends on the shape only.
//
// What bounds them on an H100: f0's three kernels move bytes (forward 93 MB,
// backward 160 MB at config #2, 27 MACs per output value); the teacher stem
// does 19.9 GFLOP of products for 59 MB. This first version runs all
// products as f32 FMAs from shared memory: the image window and the weights
// are staged once per tile (the weights once per CTA, grid-stride loops), a
// thread owns 8 output channels of a pixel (f0) or 4 pixels x 8 channels
// (the stem), so a weight load serves several FMAs. Tensor cores
// (mma.sync, K = 147 padded to 160) are the later lever for the stem.
//
// The C entry points launch on the caller's stream and return
// cudaGetLastError(); the Python wrapper raises if it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;   // threads per CTA, every kernel
constexpr int kF0MaxC = 64;     // widest C0 (f0: register and smem budgets)
constexpr int kF0MaxCols = 2 * kThreads + 1;     // image columns of a tile (C0 = 8: 256 pixels)
// teacher stem
constexpr int kTsCo = 64, kTsK = 147;             // 7 x 7 x 3 taps
constexpr int kTsTPH = 4, kTsTPW = 16;            // pooled rows, columns per tile
constexpr int kTsCR = 2 * kTsTPH + 1;             // conv rows of a tile (9)
constexpr int kTsCCP = 36;                        // conv columns, 2 * kTsTPW + 1 padded to 4
constexpr int kTsIR = 2 * (kTsCR - 1) + 7;        // image rows of a tile (23)
constexpr int kTsIC = 2 * (kTsCCP - 1) + 7;       // image columns of a tile (77)
constexpr int kTsXs = (kTsIR * kTsIC * 3 + 3) / 4 * 4;   // its floats, 16-byte padded

// ---------------------------------------------------------------------------
// f0 tiles: one segment of tp output columns of one output row; the image
// window of a tile is 3 rows x (2 tp + 1) columns x 3 channels, zero outside
// the image (the conv's padding)
// ---------------------------------------------------------------------------

struct F0Geom {
  int n, h, w, c0, ho, wo, ng, tp, nseg;
  __device__ F0Geom(int n_, int h_, int w_, int c0_)
      : n(n_), h(h_), w(w_), c0(c0_), ho((h_ + 1) / 2), wo((w_ + 1) / 2), ng(c0_ / 8),
        tp(kThreads / (c0_ / 8)), nseg(0) {
    nseg = (wo + tp - 1) / tp;
  }
};

// stage the image window of tile (img, oh, ow0) with np output columns
template <typename T>
__device__ __forceinline__ void f0_stage_x(const T* __restrict__ x, float* xs, const F0Geom& g,
                                           long long img, int oh, int ow0, int np) {
  const int ncols = 2 * np + 1, iw0 = 2 * ow0 - 1;
  for (int i = threadIdx.x; i < 3 * ncols * 3; i += kThreads) {
    const int dh = i / (ncols * 3), rem = i - dh * ncols * 3;
    const int col = rem / 3, ci = rem - col * 3;
    const int ih = 2 * oh - 1 + dh, iw = iw0 + col;
    float v = 0.f;
    if (ih >= 0 && ih < g.h && iw >= 0 && iw < g.w)
      v = to_f<T>(x[((img * g.h + ih) * g.w + iw) * 3 + ci]);
    xs[(dh * kF0MaxCols + col) * 3 + ci] = v;
  }
}

// ---------------------------------------------------------------------------
// f0 forward: thread = (pixel p of the tile, channel octet q)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
f0_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
              float* __restrict__ partial, int n, int h, int wd, int c0) {
  __shared__ __align__(16) float ws[27 * kF0MaxC];           // [k][c0]
  __shared__ float xs[3 * kF0MaxCols * 3];                   // [dh][col][ci]
  __shared__ float red[kThreads * 16];                       // [thread][sum 8, sq 8]
  const F0Geom g(n, h, wd, c0);
  const int tid = threadIdx.x, p = tid / g.ng, q = tid - p * g.ng;
  const bool active = p < g.tp;
  for (int i = tid; i < 27 * c0; i += kThreads) {
    const int c = i / 27, k = i - c * 27;
    ws[k * c0 + c] = to_f<T>(w[i]);
  }
  float s[8], sq[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j] = sq[j] = 0.f;
  const long long ntiles = (long long)n * g.ho * g.nseg;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int seg = (int)(t % g.nseg);
    const long long r = t / g.nseg;
    const int oh = (int)(r % g.ho);
    const long long img = r / g.ho;
    const int ow0 = seg * g.tp, np = min(g.tp, g.wo - ow0);
    __syncthreads();                  // the previous tile's reads of xs are done
    f0_stage_x<T>(x, xs, g, img, oh, ow0, np);
    __syncthreads();
    if (active && p < np) {
      float acc[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = 0.f;
#pragma unroll
      for (int dh = 0; dh < 3; ++dh)
#pragma unroll
        for (int dw = 0; dw < 3; ++dw)
#pragma unroll
          for (int ci = 0; ci < 3; ++ci) {
            const int k = (dh * 3 + dw) * 3 + ci;
            const float xv = xs[(dh * kF0MaxCols + 2 * p + dw) * 3 + ci];
            const float4 wa = *reinterpret_cast<const float4*>(ws + k * c0 + 8 * q);
            const float4 wb = *reinterpret_cast<const float4*>(ws + k * c0 + 8 * q + 4);
            acc[0] = fmaf(xv, wa.x, acc[0]);
            acc[1] = fmaf(xv, wa.y, acc[1]);
            acc[2] = fmaf(xv, wa.z, acc[2]);
            acc[3] = fmaf(xv, wa.w, acc[3]);
            acc[4] = fmaf(xv, wb.x, acc[4]);
            acc[5] = fmaf(xv, wb.y, acc[5]);
            acc[6] = fmaf(xv, wb.z, acc[6]);
            acc[7] = fmaf(xv, wb.w, acc[7]);
          }
      store8<T>(y + ((img * g.ho + oh) * g.wo + ow0 + p) * c0 + 8 * q, acc);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j] += acc[j];
        sq[j] = fmaf(acc[j], acc[j], sq[j]);
      }
    }
  }
  // per channel: the CTA's pixel threads of its octet, in pixel order
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    red[tid * 16 + j] = s[j];
    red[tid * 16 + 8 + j] = sq[j];
  }
  __syncthreads();
  for (int e = tid; e < 2 * c0; e += kThreads) {
    const int stat = e / c0, c = e - stat * c0, oq = c / 8, j = c % 8;
    float v = 0.f;
    for (int pp = 0; pp < g.tp; ++pp) v += red[(pp * g.ng + oq) * 16 + stat * 8 + j];
    partial[(size_t)blockIdx.x * 2 * c0 + e] = v;
  }
}

// ---------------------------------------------------------------------------
// f0 weight gradient: the tile's ga (bn0 backward at the real output
// pixels) and image window in shared memory; thread = (tap k, channel
// quartet) items, dW0 in registers across tiles
// ---------------------------------------------------------------------------

constexpr int kF0WItems = (27 * kF0MaxC / 4 + kThreads - 1) / kThreads;   // 2

template <typename T>
__global__ void __launch_bounds__(kThreads)
f0_wgrad_kernel(const T* __restrict__ gy, const T* __restrict__ a0, const T* __restrict__ x,
                const float* __restrict__ pn, float* __restrict__ partial, int n, int h,
                int wd, int c0, float eps) {
  __shared__ __align__(16) float gas[kThreads * 8];          // [p][c0], tp * c0 = 2048
  __shared__ float xs[3 * kF0MaxCols * 3];
  __shared__ BnBwd bb[kF0MaxC];
  const F0Geom g(n, h, wd, c0);
  const int tid = threadIdx.x, nq4 = c0 / 4, items = 27 * nq4;
  for (int c = tid; c < c0; c += kThreads) bb[c] = load_bn_bwd(pn, c, eps);
  float acc[kF0WItems][4];
#pragma unroll
  for (int j = 0; j < kF0WItems; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const long long ntiles = (long long)n * g.ho * g.nseg;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int seg = (int)(t % g.nseg);
    const long long r = t / g.nseg;
    const int oh = (int)(r % g.ho);
    const long long img = r / g.ho;
    const int ow0 = seg * g.tp, np = min(g.tp, g.wo - ow0);
    __syncthreads();
    f0_stage_x<T>(x, xs, g, img, oh, ow0, np);
    const size_t base = ((img * g.ho + oh) * g.wo + ow0) * (size_t)c0;
    for (int i = tid; i < np * c0; i += kThreads) {
      const int c = i % c0;
      gas[i] = rounded<T>(bn_bwd(to_f<T>(gy[base + i]), to_f<T>(a0[base + i]), bb[c]));
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kF0WItems; ++j) {
      const int it = tid + j * kThreads;
      if (it < items) {
        const int k = it / nq4, cq = it - k * nq4;
        const int dh = k / 9, dw = (k / 3) % 3, ci = k % 3;
        const float* xr = xs + (dh * kF0MaxCols + dw) * 3 + ci;
        for (int pp = 0; pp < np; ++pp) {
          const float xv = xr[6 * pp];
          const float4 gv = *reinterpret_cast<const float4*>(gas + pp * c0 + 4 * cq);
          acc[j][0] = fmaf(gv.x, xv, acc[j][0]);
          acc[j][1] = fmaf(gv.y, xv, acc[j][1]);
          acc[j][2] = fmaf(gv.z, xv, acc[j][2]);
          acc[j][3] = fmaf(gv.w, xv, acc[j][3]);
        }
      }
    }
  }
  // every (c, k) has one owner: its sum is the CTA's partial
#pragma unroll
  for (int j = 0; j < kF0WItems; ++j) {
    const int it = tid + j * kThreads;
    if (it < items) {
      const int k = it / nq4, cq = it - k * nq4;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        partial[((size_t)blockIdx.x * c0 + 4 * cq + e) * 27 + k] = acc[j][e];
    }
  }
}

// ---------------------------------------------------------------------------
// f0 input gradient: thread = one image pixel, its 3 channels; ga of the
// (at most 2 x 2) output pixels it reaches recomputed from gy0 and a0
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
f0_xgrad_kernel(const T* __restrict__ gy, const T* __restrict__ a0, const float* __restrict__ pn,
                const T* __restrict__ w, T* __restrict__ dx, int n, int h, int wd, int c0,
                float eps) {
  __shared__ float ws[27 * kF0MaxC];                         // [k][c0]
  __shared__ BnBwd bb[kF0MaxC];
  const int ho = (h + 1) / 2, wo = (wd + 1) / 2;
  for (int i = threadIdx.x; i < 27 * c0; i += kThreads) {
    const int c = i / 27, k = i - c * 27;
    ws[k * c0 + c] = to_f<T>(w[i]);
  }
  for (int c = threadIdx.x; c < c0; c += kThreads) bb[c] = load_bn_bwd(pn, c, eps);
  __syncthreads();
  const long long pix = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (pix >= (long long)n * h * wd) return;
  const int ix = (int)(pix % wd);
  const long long r = pix / wd;
  const int iy = (int)(r % h);
  const long long img = r / h;
  float acc[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int dh = 0; dh < 3; ++dh) {
    const int ty = iy + 1 - dh;
    if (ty < 0 || (ty & 1) || ty / 2 >= ho) continue;
#pragma unroll
    for (int dw = 0; dw < 3; ++dw) {
      const int tx = ix + 1 - dw;
      if (tx < 0 || (tx & 1) || tx / 2 >= wo) continue;
      const size_t base = ((img * ho + ty / 2) * wo + tx / 2) * (size_t)c0;
      const float* wk = ws + (dh * 3 + dw) * 3 * c0;
      for (int c8 = 0; c8 < c0; c8 += 8) {
        float gv[8], av[8];
        load8<T>(gy + base + c8, gv);
        load8<T>(a0 + base + c8, av);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float ga = rounded<T>(bn_bwd(gv[j], av[j], bb[c8 + j]));
#pragma unroll
          for (int ci = 0; ci < 3; ++ci) acc[ci] = fmaf(ga, wk[ci * c0 + c8 + j], acc[ci]);
        }
      }
    }
  }
#pragma unroll
  for (int ci = 0; ci < 3; ++ci) dx[pix * 3 + ci] = from_f<T>(acc[ci]);
}

// ---------------------------------------------------------------------------
// teacher stem: tile = kTsTPH x kTsTPW pooled outputs of one image; its
// conv rows 2 po0 - 1 .. and columns 2 qo0 - 1 .. (kTsCR x kTsCCP) go to
// shared memory in the output dtype, -inf where the pool pads
// ---------------------------------------------------------------------------

__host__ __device__ constexpr int tstem_smem_bytes(int esize) {
  return 4 * (kTsK * kTsCo + kTsCo + kTsXs) + esize * kTsCR * kTsCCP * kTsCo;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
tstem_kernel(const T* __restrict__ x, const T* __restrict__ w, const float* __restrict__ bias,
             T* __restrict__ y, int n, int h, int wd) {
  extern __shared__ __align__(16) float sm[];
  float* ws = sm;                                 // [k][half][octet][4]: channel 8 o + 4 half + e
  float* bs = ws + kTsK * kTsCo;                  // [64]
  float* xs = bs + kTsCo;                         // [kTsIR][kTsIC][3]
  T* cs = reinterpret_cast<T*>(xs + kTsXs);      // [kTsCR][kTsCCP][64]
  const int tid = threadIdx.x;
  const int hc = (h + 1) / 2, wc = (wd + 1) / 2, ho = (hc + 1) / 2, wo = (wc + 1) / 2;
  for (int i = tid; i < kTsCo * kTsK; i += kThreads) {
    const int c = i / kTsK, k = i - c * kTsK;
    ws[k * kTsCo + ((c / 4) % 2) * 32 + (c / 8) * 4 + c % 4] = to_f<T>(w[i]);
  }
  for (int c = tid; c < kTsCo; c += kThreads) bs[c] = bias[c];
  const int nth = (ho + kTsTPH - 1) / kTsTPH, ntw = (wo + kTsTPW - 1) / kTsTPW;
  const long long ntiles = (long long)n * nth * ntw;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int tw = (int)(t % ntw);
    const long long r = t / ntw;
    const int th = (int)(r % nth);
    const long long img = r / nth;
    const int po0 = th * kTsTPH, qo0 = tw * kTsTPW;
    const int nph = min(kTsTPH, ho - po0), npw = min(kTsTPW, wo - qo0);
    const int cr = 2 * nph + 1, nq = (2 * npw + 1 + 3) / 4;     // conv rows, column quads
    const int ir = 2 * (cr - 1) + 7, ic = 2 * (4 * nq - 1) + 7;  // image rows, columns
    const int gr0 = 2 * po0 - 1, gc0 = 2 * qo0 - 1;             // first conv row, column
    const int iy0 = 2 * gr0 - 3, ix0 = 2 * gc0 - 3;             // first image row, column
    __syncthreads();                  // the previous tile's pool is done
    for (int i = tid; i < ir * ic * 3; i += kThreads) {
      const int rr = i / (ic * 3), rem = i - rr * ic * 3;
      const int col = rem / 3, ci = rem - col * 3;
      const int iy = iy0 + rr, ix = ix0 + col;
      float v = 0.f;
      if (iy >= 0 && iy < h && ix >= 0 && ix < wd)
        v = to_f<T>(x[((img * h + iy) * wd + ix) * 3 + ci]);
      xs[(rr * kTsIC + col) * 3 + ci] = v;
    }
    __syncthreads();
    // conv: item = (conv row, column quad, channel octet) -> 4 x 8 values
    for (int it = tid; it < cr * nq * 8; it += kThreads) {
      const int o = it % 8, rest = it / 8, qd = rest % nq, rr = rest / nq;
      float acc[4][8];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[j][e] = 0.f;
      for (int dh = 0; dh < 7; ++dh) {
        const float* xrow = xs + (2 * rr + dh) * kTsIC * 3 + 8 * qd * 3;
        const float* wrow = ws + dh * 21 * kTsCo + o * 4;
#pragma unroll
        for (int dw = 0; dw < 7; ++dw)
#pragma unroll
          for (int ci = 0; ci < 3; ++ci) {
            const float* wk = wrow + (dw * 3 + ci) * kTsCo;
            const float4 wa = *reinterpret_cast<const float4*>(wk);
            const float4 wb = *reinterpret_cast<const float4*>(wk + 32);
            const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float xv = xrow[(2 * j + dw) * 3 + ci];
#pragma unroll
              for (int e = 0; e < 8; ++e) acc[j][e] = fmaf(xv, wv[e], acc[j][e]);
            }
          }
      }
      const int gr = gr0 + rr;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int lc = 4 * qd + j, gc = gc0 + lc;
        const bool ok = gr >= 0 && gr < hc && gc >= 0 && gc < wc;
        T* dst = cs + (rr * kTsCCP + lc) * kTsCo + 8 * o;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = from_f<T>(ok ? fmaxf(acc[j][e] + bs[8 * o + e], 0.f) : -INFINITY);
      }
    }
    __syncthreads();
    // pool: item = (pooled row, pooled column, channel octet)
    for (int it = tid; it < nph * npw * 8; it += kThreads) {
      const int o = it % 8, rest = it / 8, lq = rest % npw, lp = rest / npw;
      float m[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) m[e] = -INFINITY;
#pragma unroll
      for (int dr = 0; dr < 3; ++dr)
#pragma unroll
        for (int dc = 0; dc < 3; ++dc) {
          float v[8];
          load8<T>(cs + ((2 * lp + dr) * kTsCCP + 2 * lq + dc) * kTsCo + 8 * o, v);
#pragma unroll
          for (int e = 0; e < 8; ++e) m[e] = fmaxf(m[e], v[e]);
        }
      store8<T>(y + ((img * ho + po0 + lp) * wo + qo0 + lq) * kTsCo + 8 * o, m);
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

bool f0_width_ok(int c0) { return c0 >= 8 && c0 % 8 == 0 && c0 <= kF0MaxC; }

template <typename T>
cudaError_t run_f0_fwd(const void* x, const void* w, void* y, void* partial, int n, int h,
                       int wd, int c0, int grid, cudaStream_t st) {
  f0_fwd_kernel<T><<<grid, kThreads, 0, st>>>(static_cast<const T*>(x),
                                              static_cast<const T*>(w), static_cast<T*>(y),
                                              static_cast<float*>(partial), n, h, wd, c0);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_f0_wgrad(const void* gy, const void* a0, const void* x, const void* pn,
                         void* partial, int n, int h, int wd, int c0, float eps, int grid,
                         cudaStream_t st) {
  f0_wgrad_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(gy), static_cast<const T*>(a0), static_cast<const T*>(x),
      static_cast<const float*>(pn), static_cast<float*>(partial), n, h, wd, c0, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_f0_xgrad(const void* gy, const void* a0, const void* pn, const void* w,
                         void* dx, int n, int h, int wd, int c0, float eps, cudaStream_t st) {
  const long long pix = (long long)n * h * wd;
  const int grid = (int)((pix + kThreads - 1) / kThreads);
  f0_xgrad_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(gy), static_cast<const T*>(a0), static_cast<const float*>(pn),
      static_cast<const T*>(w), static_cast<T*>(dx), n, h, wd, c0, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_tstem(const void* x, const void* w, const void* bias, void* y, int n, int h,
                      int wd, int grid, int smem, cudaStream_t st) {
  auto kern = tstem_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kern<<<grid, kThreads, smem, st>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                                     static_cast<const float*>(bias), static_cast<T*>(y), n,
                                     h, wd);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// f0 forward. x (n, h, w, 3) and w (c0, 27) [k = (dh * 3 + dw) * 3 + ci] in
// dtype; y (n, (h + 1) / 2, (w + 1) / 2, c0) in dtype; partial (grid, 2, c0)
// f32: [sum, sum of squares] of the f32 accumulator.
int kdcc_f0_fwd(int dtype, const void* x, const void* w, void* y, void* partial, int n, int h,
                int wd, int c0, int grid, void* stream) {
  if (grid < 1 || !f0_width_ok(c0)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)run_f0_fwd<float>(x, w, y, partial, n, h, wd, c0, grid, st);
  if (dtype == 1)
    return (int)run_f0_fwd<__nv_bfloat16>(x, w, y, partial, n, h, wd, c0, grid, st);
  return (int)cudaErrorInvalidValue;
}

// f0 weight gradient. gy, a0 (n, ho, wo, c0) and x (n, h, w, 3) in dtype;
// pn (c0, 6) f32; partial (grid, c0, 27) f32.
int kdcc_f0_wgrad(int dtype, const void* gy, const void* a0, const void* x, const void* pn,
                  void* partial, int n, int h, int wd, int c0, float eps, int grid,
                  void* stream) {
  if (grid < 1 || !f0_width_ok(c0)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)run_f0_wgrad<float>(gy, a0, x, pn, partial, n, h, wd, c0, eps, grid, st);
  if (dtype == 1)
    return (int)run_f0_wgrad<__nv_bfloat16>(gy, a0, x, pn, partial, n, h, wd, c0, eps, grid,
                                            st);
  return (int)cudaErrorInvalidValue;
}

// f0 input gradient. gy, a0 (n, ho, wo, c0) in dtype; pn (c0, 6) f32; w
// (c0, 27) in dtype; dx (n, h, w, 3) in dtype.
int kdcc_f0_xgrad(int dtype, const void* gy, const void* a0, const void* pn, const void* w,
                  void* dx, int n, int h, int wd, int c0, float eps, void* stream) {
  if (!f0_width_ok(c0)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)run_f0_xgrad<float>(gy, a0, pn, w, dx, n, h, wd, c0, eps, st);
  if (dtype == 1)
    return (int)run_f0_xgrad<__nv_bfloat16>(gy, a0, pn, w, dx, n, h, wd, c0, eps, st);
  return (int)cudaErrorInvalidValue;
}

// Teacher stem + maxpool. x (n, h, w, 3) and w (64, 147) [k = (dh * 7 + dw)
// * 3 + ci, the eval BN's scale folded in] in dtype; bias (64) f32; y (n, ho,
// wo, 64) in dtype, ho = ((h + 1) / 2 + 1) / 2. smem must be the layout's.
int kdcc_tstem(int dtype, const void* x, const void* w, const void* bias, void* y, int n,
               int h, int wd, int grid, int smem, void* stream) {
  const int esize = dtype == 0 ? 4 : 2;
  if (grid < 1 || smem != tstem_smem_bytes(esize)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)run_tstem<float>(x, w, bias, y, n, h, wd, grid, smem, st);
  if (dtype == 1)
    return (int)run_tstem<__nv_bfloat16>(x, w, bias, y, n, h, wd, grid, smem, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

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
// does 19.9 GFLOP of products for 59 MB. The f0 kernels and the stem's f32
// variant (parity only) run their products as f32 FMAs from shared memory:
// the image window and the weights are staged once per tile (the weights
// once per CTA, grid-stride loops), a thread owns 8 output channels of a
// pixel (f0) or 4 pixels x 8 channels (the stem), so a weight load serves
// several FMAs. The bf16 stem (the main path's) is an implicit GEMM on the
// tensor cores, `tsm::tstem_kernel` below.
//
// The C entry points launch on the caller's stream and return
// cudaGetLastError(); the Python wrapper raises if it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"
#include "wgmma.cuh"

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
// teacher stem, bf16 (tsm::tstem_kernel): an implicit GEMM on the tensor
// cores. Space-to-depth turns the stride-2 7x7 conv into a stride-1 4x4
// conv over 12 channels: s2d pixel (S, C) holds image rows 2S - 3 + a,
// columns 2C - 3 + b, channel a * 6 + b * 3 + ci; conv pixel (r, c) reads
// s2d pixels (r + dR, c + dC), dR, dC < 4, tap dh = 2 dR + a, dw = 2 dC + b
// (dh or dw = 7 has a zero weight). Padded to 16 channels, one s2d tap is
// one k16 step of mma.sync m16n8k16: K = 256, N = 64, M = the tile's conv
// pixels flattened (row-major).
//
// A CTA walks tiles of at most kPH x kPW pooled outputs (the rows and
// columns split evenly, so no tile is a sliver), round-robin over one wave
// of two CTAs an SM. Per tile: the image rows of its window arrive by
// 16-byte cp.async as raw NHWC bytes (the next tile's while this one
// computes, two raw stages), are re-laid into the s2d tile in shared memory
// ([row][column][16 channels], the two 16-byte halves of a pixel swapped
// when bit 2 of its column is set, so that ldmatrix reads 8 consecutive
// pixels without bank conflicts), then each warp takes m16 blocks w and
// w + 8 (then w + 16 and w + 24): A by ldmatrix.x4, B from the weights staged
// once per CTA in the fragment layout (ops/tstem.py `stem_frag`: one 16-byte
// load a lane gives b0 and b1 of two n8 blocks), f32 sums. The epilogue adds
// the shift, takes the relu, rounds to bf16 (-inf outside the conv's extent,
// the pool's padding) into the conv tile ([pixel][64] with 16-byte chunks
// XOR-swizzled by the pixel's low 3 bits), and the pool reads 3 x 3
// windows of 16-byte chunks from it. The conv output never reaches HBM.
// ---------------------------------------------------------------------------

namespace tsm {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;                         // 8 warps; two CTAs an SM
constexpr int kPH = 4, kPW = 16;                      // pooled tile maxima
constexpr int kCR = 2 * kPH + 1, kCC = 2 * kPW + 1;   // conv tile maxima (9, 33)
constexpr int kSR = kCR + 3, kSC = kCC + 3;           // s2d tile (12, 36); kSC * 32 % 128 == 0
constexpr int kIR = 2 * kSR;                          // image rows a tile (24)
constexpr int kRawRow = 448;                          // bytes a staged image row: 6 x 72 + alignment
constexpr int kWBytes = 16 * 4 * 32 * 16;             // [tap][n16 pair][lane][8 bf16]
constexpr int kOffShift = kWBytes;
constexpr int kOffS2d = kOffShift + 64 * 4;
constexpr int kOffCs = kOffS2d + kSR * kSC * 32;
constexpr int kOffRaw = kOffCs + kCR * kCC * 128;
constexpr int kSmem = kOffRaw + 2 * kIR * kRawRow;     // 106368 (ops/tstem.py `bf16_smem_bytes`)
static_assert(kSmem == 106368, "ops/tstem.py mirrors this layout");
static_assert((kSC * 32) % 128 == 0, "the s2d swizzle assumes whole 128-byte rows");

// the pooled-output tiles of an (n, h, w) image batch: nrt x nct per image
struct Tiles {
  int h, w, hc, wc, ho, wo, nrt, nct;
  long long count;
};
__host__ __device__ inline Tiles tiles_of(int n, int h, int w) {
  Tiles t;
  t.h = h, t.w = w, t.hc = (h + 1) / 2, t.wc = (w + 1) / 2;
  t.ho = (t.hc + 1) / 2, t.wo = (t.wc + 1) / 2;
  t.nrt = (t.ho + kPH - 1) / kPH, t.nct = (t.wo + kPW - 1) / kPW;
  t.count = (long long)n * t.nrt * t.nct;
  return t;
}

struct Tile {
  long long img;
  int po0, nph, qo0, npw, cr, cc, gr0, gc0, iy0, ix0;
};
// tile t: row tile i covers pooled rows [i ho / nrt, (i + 1) ho / nrt), likewise
// the columns; its conv rows start at gr0 = 2 po0 - 1, its s2d rows at gr0,
// its image rows at 2 gr0 - 3
__device__ __forceinline__ Tile tile_at(const Tiles& g, long long t) {
  Tile T;
  const int j = (int)(t % g.nct);
  const long long r = t / g.nct;
  const int i = (int)(r % g.nrt);
  T.img = r / g.nrt;
  T.po0 = i * g.ho / g.nrt, T.nph = (i + 1) * g.ho / g.nrt - T.po0;
  T.qo0 = j * g.wo / g.nct, T.npw = (j + 1) * g.wo / g.nct - T.qo0;
  T.cr = 2 * T.nph + 1, T.cc = 2 * T.npw + 1;
  T.gr0 = 2 * T.po0 - 1, T.gc0 = 2 * T.qo0 - 1;
  T.iy0 = 2 * T.gr0 - 3, T.ix0 = 2 * T.gc0 - 3;
  return T;
}

// the tile's image rows, raw: for each in-image row the 16-byte blocks that
// cover its in-image columns (x is 16-byte aligned, so no block leaves the
// allocation); one warp a row
__device__ __forceinline__ void issue_raw(const bf16* x, char* raw, const Tiles& g,
                                          const Tile& T) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nir = 2 * (T.cr + 3), nic = 2 * (T.cc + 3);
  const int lo = max(T.ix0, 0), hi = min(T.ix0 + nic, g.w);
  const char* xb = reinterpret_cast<const char*>(x);
  for (int q = warp; q < nir; q += kThreads / 32) {
    const int iy = T.iy0 + q;
    if (iy < 0 || iy >= g.h) continue;
    const long long base = (T.img * g.h + iy) * (long long)g.w * 6;
    const long long a0 = (base + 6LL * lo) & ~15LL, a1 = (base + 6LL * hi + 15) & ~15LL;
    const int nch = (int)((a1 - a0) >> 4);
    for (int c = lane; c < nch; c += 32) hop::cp_async16(raw + q * kRawRow + 16 * c, xb + a0 + 16 * c);
  }
}

// raw rows -> the s2d tile: item = (s2d pixel, a), six channels; zero
// outside the image (the conv's padding)
__device__ __forceinline__ void to_s2d(const char* raw, char* s2d, const Tiles& g,
                                       const Tile& T) {
  const int sc_n = T.cc + 3, items = (T.cr + 3) * sc_n * 2;
  const int lo = max(T.ix0, 0);
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int a = it & 1, pix = it >> 1, sr = pix / sc_n, sc = pix - sr * sc_n;
    const int q = 2 * sr + a, iy = T.iy0 + q;
    const bool row_ok = iy >= 0 && iy < g.h;
    const long long base = (T.img * g.h + iy) * (long long)g.w * 6;
    const uint16_t* rp =
        reinterpret_cast<const uint16_t*>(raw + q * kRawRow + (int)((base + 6LL * lo) & 15));
    uint32_t v[6];
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int ix = T.ix0 + 2 * sc + b;
      const bool ok = row_ok && ix >= 0 && ix < g.w;
#pragma unroll
      for (int ci = 0; ci < 3; ++ci) v[3 * b + ci] = ok ? rp[3 * (ix - lo) + ci] : 0u;
    }
    char* px = s2d + (sr * kSC + sc) * 32;
    const int key = (sc >> 2) & 1;
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      const int wd = 3 * a + e;     // 32-bit word of the pixel's 16 channels
      *reinterpret_cast<uint32_t*>(px + (((wd >> 2) ^ key) << 4) + ((wd & 3) << 2)) =
          v[2 * e] | (v[2 * e + 1] << 16);
    }
  }
}

__device__ __forceinline__ uint32_t s2d_addr(uint32_t base, int sr, int sc, int half) {
  return base + ((((sr * kSC + sc) << 1) + (half ^ ((sc >> 2) & 1))) << 4);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// NB (1 or 2) m16 blocks mb[] of the tile: the 16 taps' products, then the
// epilogue into the conv tile
template <int NB>
__device__ __forceinline__ void blocks(const int (&mb)[2], const uint4* ws, const float* sh,
                                       uint32_t s2d_base, char* cs, const Tiles& g,
                                       const Tile& T) {
  const int lane = threadIdx.x & 31, M = T.cr * T.cc;
  int r[NB], c[NB];
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    int p = mb[i] * 16 + (lane & 15);
    if (p >= M) p = 0;              // a padding row: any address, its sums are dropped
    r[i] = p / T.cc, c[i] = p - r[i] * T.cc;
  }
  const int half = lane >> 4;
  float acc[NB][8][4];
#pragma unroll
  for (int i = 0; i < NB; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
#pragma unroll
  for (int s = 0; s < 16; ++s) {
    uint4 b[4];
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) b[jp] = ws[(s * 4 + jp) * 32 + lane];
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      uint32_t a[4];
      ldsm_x4(a, s2d_addr(s2d_base, r[i] + (s >> 2), c[i] + (s & 3), half));
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        const uint32_t b0[2] = {b[jp].x, b[jp].y}, b1[2] = {b[jp].z, b[jp].w};
        mma_bf16(acc[i][2 * jp], a, b0);
        mma_bf16(acc[i][2 * jp + 1], a, b1);
      }
    }
  }
  // epilogue: shift, relu, bf16; -inf outside the conv's extent
#pragma unroll
  for (int i = 0; i < NB; ++i)
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int p = mb[i] * 16 + (lane >> 2) + 8 * e2;
      if (p >= M) continue;
      const int rr = p / T.cc, cc = p - rr * T.cc, gr = T.gr0 + rr, gc = T.gc0 + cc;
      const bool ok = gr >= 0 && gr < g.hc && gc >= 0 && gc < g.wc;
      char* dst = cs + p * 128 + ((lane & 3) << 2);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 8 * j + 2 * (lane & 3);
        const float v0 = ok ? fmaxf(acc[i][j][2 * e2] + sh[col], 0.f) : -INFINITY;
        const float v1 = ok ? fmaxf(acc[i][j][2 * e2 + 1] + sh[col + 1], 0.f) : -INFINITY;
        *reinterpret_cast<__nv_bfloat162*>(dst + ((j ^ (p & 7)) << 4)) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
}

__global__ void __launch_bounds__(kThreads, 2)
tstem_kernel(const bf16* __restrict__ x, const uint4* __restrict__ wf,
             const float* __restrict__ shift, bf16* __restrict__ y, int n, int h, int w) {
  extern __shared__ __align__(128) char sm[];
  const uint4* ws = reinterpret_cast<const uint4*>(sm);
  float* sh = reinterpret_cast<float*>(sm + kOffShift);
  char* s2d = sm + kOffS2d;
  char* cs = sm + kOffCs;
  char* raw = sm + kOffRaw;
  const int tid = threadIdx.x, warp = tid >> 5;
  const Tiles g = tiles_of(n, h, w);
  for (int i = tid; i < kWBytes / 16; i += kThreads) hop::cp_async16(sm + 16 * i, wf + i);
  for (int i = tid; i < 64; i += kThreads) sh[i] = shift[i];
  // channels 12..15 of every s2d pixel stay zero: to_s2d writes 0..11
  for (int i = tid; i < kSR * kSC * 2; i += kThreads)
    reinterpret_cast<uint4*>(s2d)[i] = make_uint4(0u, 0u, 0u, 0u);
  long long t = blockIdx.x;
  if (t < g.count) issue_raw(x, raw, g, tile_at(g, t));
  hop::cp_async_commit();
  const uint32_t s2d_base = hop::smem_u32(s2d);
  for (int stage = 0; t < g.count; t += gridDim.x, stage ^= 1) {
    const Tile T = tile_at(g, t);
    hop::cp_async_wait<0>();
    __syncthreads();        // this tile's rows (the first time, the weights) landed; the last pool is done
    if (t + gridDim.x < g.count)
      issue_raw(x, raw + (stage ^ 1) * kIR * kRawRow, g, tile_at(g, t + gridDim.x));
    hop::cp_async_commit();
    to_s2d(raw + stage * kIR * kRawRow, s2d, g, T);
    __syncthreads();
    const int nmb = (T.cr * T.cc + 15) / 16;
    for (int m0 = warp; m0 < nmb; m0 += 16) {
      const int mb[2] = {m0, m0 + 8};
      if (m0 + 8 < nmb)
        blocks<2>(mb, ws, sh, s2d_base, cs, g, T);
      else
        blocks<1>(mb, ws, sh, s2d_base, cs, g, T);
    }
    __syncthreads();
    // pool: item = (pooled row, pooled column, channel octet)
    for (int it = tid; it < T.nph * T.npw * 8; it += kThreads) {
      const int o = it & 7, rest = it >> 3, lq = rest % T.npw, lp = rest / T.npw;
      uint4 m;
#pragma unroll
      for (int dr = 0; dr < 3; ++dr)
#pragma unroll
        for (int dc = 0; dc < 3; ++dc) {
          const int p = (2 * lp + dr) * T.cc + 2 * lq + dc;
          const uint4 v = *reinterpret_cast<const uint4*>(cs + p * 128 + ((o ^ (p & 7)) << 4));
          if (dr == 0 && dc == 0) {
            m = v;
          } else {
            __nv_bfloat162* a = reinterpret_cast<__nv_bfloat162*>(&m);
            const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
            for (int k = 0; k < 4; ++k) a[k] = __hmax2(a[k], b[k]);
          }
        }
      *reinterpret_cast<uint4*>(y + ((T.img * g.ho + T.po0 + lp) * g.wo + T.qo0 + lq) * 64 +
                                8 * o) = m;
    }
  }
  hop::cp_async_wait<0>();
}

}  // namespace tsm

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

// Teacher stem + maxpool. x (n, h, w, 3) in dtype; bias (64) f32; y (n, ho,
// wo, 64) in dtype, ho = ((h + 1) / 2 + 1) / 2. float32: w (64, 147) [k =
// (dh * 7 + dw) * 3 + ci, the eval BN's scale folded in], the CUDA-core
// kernel. bfloat16: w the same weights in tsm's fragment layout (16384
// values, ops/tstem.py `stem_frag`), x 16-byte aligned, the tensor-core
// kernel. smem must be the kernel's layout.
int kdcc_tstem(int dtype, const void* x, const void* w, const void* bias, void* y, int n,
               int h, int wd, int grid, int smem, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (grid < 1 || n < 1 || h < 1 || wd < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    if (smem != tstem_smem_bytes(4)) return (int)cudaErrorInvalidValue;
    return (int)run_tstem<float>(x, w, bias, y, n, h, wd, grid, smem, st);
  }
  if (dtype != 1 || smem != tsm::kSmem || reinterpret_cast<uintptr_t>(x) % 16 ||
      ctas_per_sm<tsm::tstem_kernel>(tsm::kThreads, smem) < 1)
    return (int)cudaErrorInvalidValue;
  tsm::tstem_kernel<<<grid, tsm::kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint4*>(w),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(y), n, h, wd);
  return (int)cudaGetLastError();
}

}  // extern "C"

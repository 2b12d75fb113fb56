// Pixelwise CE + softened KL over bilinearly upsampled class-major logits,
// forward (kernel C) and backward (kernel D).
//
// Replaces the Pallas kernels of kd_cheap_conv_tpu/ops/pallas/losses.py:
//   fused_ce_kl_loss_upsampled, forward  _up2_fwd_kernel_kl / _ce  -> kernel C
//   fused_ce_kl_loss_upsampled, backward _up2_bwd_kernel_kl / _ce  -> kernel D
// (and fused_ce_loss_upsampled, their beta = 0 instance: KL = false below).
//
// The function is the JAX kernel's, not its block layout. The TPU computed
// the interpolation as two matmuls over block-diagonal tables (MXU work);
// here a CTA stages a head-resolution window of s and t in shared memory
// (f32, the teacher clipped at head resolution, before the upsample, as the
// JAX kernel does) and each full-resolution pixel reads its 2x2 taps there.
// Interpolation: half-pixel bilinear, source index clamped to [0, in - 1];
// the per-axis taps (lo index, weight of lo + 1) come from host tables that
// the wrapper builds exactly as the JAX package's bilinear_matrix does.
//
// Per pixel, all in f32, with one pixel's C upsampled logits in registers:
//   nll = lse(s) - s[label]            (a label outside [0, C): s[label] = 0)
//   log_p_t = max(t/T - lse(t/T), -87),  log_p_s = s/T - lse(s/T)
//   kl  = sum_c exp(log_p_t) * (log_p_t - log_p_s)
// valid = label != ignore; CE sums valid pixels, KL sums every pixel.
// Every lse is max-subtracted, so equal logits (a clipped row) are exact.
//
// What bounds both on an H100: the special-function unit. Each needs at
// least 3 exponentials per class and pixel (s, s/T, t/T): 265 M at config
// #2 (16 x 21 x 513 x 513), ~63 us at 16 results per clock per SM, against
// ~17 us to read C's ~56 MB (bf16 logits 2 x 11.2 MB, int64 labels 33.7
// MB). Both take exactly those 3, by ex2.approx of arguments in log2 units:
// s is staged prescaled by log2(e); t is staged unscaled (at the clip |t| /
// T reaches 7500, where a scaled copy would round coarser than t itself)
// and t/T - m scaled after the subtraction. Shared parts: a head-resolution
// tile of kTY x kTX, whose window [c][kWH][kWW] sits at a compile-time
// stride so that a class's taps are immediate offsets (D: s's planes, then
// t's; C: (s, t) pairs, one 8-byte load a tap for both); exact instances
// for 19 and 21 classes (configs #3 and #2), bins of 8 up to 32 for the
// rest.
//
// Kernel C (namespace cfw): one launch on one wave of persistent CTAs (four
// of 128 threads an SM) that walk head-resolution tiles, CTA b the tiles
// [b per, (b + 1) per): the split depends on the shape alone. The time
// goes to issuing instructions (FP32 work beside the 3 ex2), not to bytes:
// small CTAs keep one CTA's staging beside three others' pixels, the
// windows hold (s, t / T) pairs, and the labels are loaded a pixel ahead.
// A tile owns every output
// pixel whose lower taps (lo_y, lo_x) fall inside it, so each output pixel
// is computed exactly once; its window is the tile plus one row and column
// (the last tile of an axis may take one more row or column). A thread per
// pixel: the taps' weights and offsets
// from the tile's tables, its s and t/T (each the four taps' weighted sum),
// the three exponentials each once (exp(log_p_t) = max(exp(t/T - m_t) /
// sum, e^-87), exp being monotone: the JAX formula up to rounding),
// s[label] from the window by the same arithmetic. Each
// thread sums its pixels' (nll * valid, valid, kl) in a fixed order, the
// CTA in a fixed order, and the CTAs' partials are summed over an integer
// ticket by the last CTA to finish, in a fixed order, into the (3,) sums.
// No float atomics anywhere: the result is the same bits every call.
//
// Kernel D (namespace dbw): gather form, one launch. A CTA owns an 8 x 16
// tile of ds (head resolution) for all classes and recomputes the
// per-pixel gradient
//   g = a * (softmax(s) - onehot) * valid + k * (softmax(s/T) - softmax(t/T))
// on every full-resolution pixel that taps the tile (~1.15x overlap with
// the neighbouring tiles), in passes of `rows` full-resolution rows. The
// plan (ops/losses_fused.py plan) sizes a pass at ~3 pixels a thread.
// Per pass:
//   (a) a thread per pixel: its C upsampled logits of s and t in registers,
//       the three exponentials per class exp(s - m), exp(s/T - m/T),
//       exp(t/T - m_t) taken once and kept from the sums to the gradient
//       (3 per class and pixel, the bound's count) -> g in shared memory;
//   (b) horizontal taps: each (class, full row, head column) sums its
//       full-resolution columns' g with their weights -> hs;
//   (c) vertical taps: each (class, head row, head column) cell adds the
//       pass's rows that tap it, in row order, into its accumulator.
// In (b) and (c) an item carries 8 classes, so a tap's weight is formed
// once for the 8 and their adds are independent. Every thread has work in
// all three; the tap tables of the CTA's range (lo, frac of its rows and
// columns, [ob, oe) of its head rows and columns) are staged once in
// shared memory. Each cell of ds has one owner
// thread and a fixed order of adds (rows ascending, within a row the lower
// tap then the upper, columns ascending): ds is the same bits every call.
// g stays f32 through the transposed interpolation; ds is rounded once to
// the logits' dtype. a and k come from a device buffer (the folded
// cotangents), so the backward needs no host sync. Both dtypes run it.
// Windows are staged by plain loads: a head row of 129 bf16 is no 16-byte
// (cp.async, TMA) unit; two or more CTAs an SM overlap one CTA's staging
// with another's passes (in C and D alike).
//
// The C entry points launch on the caller's stream and return
// cudaGetLastError(); the Python wrapper raises if it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegClamp = -87.f;
constexpr float kExpNegClamp = 1.6458115e-38f;   // expf(-87), the clamped p_t
constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;
constexpr int kThreads = 256;      // kernel D's CTA (C's: cfw::kThreads)
constexpr int kTY = 8, kTX = 16;   // a head-resolution tile
// a tile's window: its full-resolution pixels tap head rows and columns
// within one of the tile, so [kTY + 2][kTX + 2] holds every window (also
// kernel C's, whose last tile of an axis may have one more row or column),
// and the compile-time plane lets a class's taps be immediate offsets
constexpr int kWH = kTY + 2, kWW = kTX + 2, kPlane = kWH * kWW;
constexpr int kSmemMax = 232448;

struct Args {
  const void* s;               // (n, c, h, w) float or bfloat16
  const void* t;               // same; unused without KL
  const int64_t* labels;       // (n, H, W)
  const int* lo_y;             // (H,) lower source row of each output row
  const float* fy;             // (H,) weight of the upper source row
  const int* lo_x;             // (W,)
  const float* fx;             // (W,)
  const int* ob_y;             // (h,) output rows [ob_y, oe_y) tap source row (D)
  const int* oe_y;
  const int* ob_x;             // (w,)
  const int* oe_x;
  const int* tb_y;             // (tiles_y + 1,) output rows [tb_y[i], tb_y[i + 1])
  const int* tb_x;             //   have their lo_y in C's row tile i; (tiles_x + 1,)
  int dtype;                   // 0 float, 1 bfloat16
  int n, c, h, w, H, W;
  float inv_t, clip;           // clip 0: none
  int ignore_index;
};

__device__ __forceinline__ float load_f32(const void* p, size_t i, int dtype) {
  return dtype == 1 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                    : static_cast<const float*>(p)[i];
}

// 2^x and log2(x) on the special-function unit; ex2 flushes results below
// 2^-126 to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The windows of s and (with KL) t: rows [y0, y0 + ny) x cols [x0, x0 +
// nx) of every class plane of image img, as f32: s scaled by log2(e) (its
// exponentials are powers of 2 of it), t clipped to +-clip. kPairs
// (kernel C): one window of (s, t / T) pairs [c][kWH][kWW] (float2), one
// 8-byte load a tap for both; else (kernel D) ws [c][kWH][kWW], then t's
// unscaled. A thread of the kNT takes a class and row (kPairs) or a
// tensor, class and row: one address a tensor, the row's loads all in
// flight, then its stores.
template <bool KL, bool kPairs, int kNT>
__device__ void stage(float* ws, const Args& a, int img, int y0, int ny, int x0, int nx) {
  constexpr bool kPair = KL && kPairs;
  for (int it = threadIdx.x; it < (KL && !kPair ? 2 : 1) * a.c * ny; it += kNT) {
    const int tc = it / ny, yy = it - tc * ny;    // [tensor * c +] class, row
    const bool is_t = KL && !kPair && tc >= a.c;
    const int ch = is_t ? tc - a.c : tc;
    const size_t base = ((size_t)(img * a.c + ch) * a.h + y0 + yy) * a.w + x0;
    const void* src = is_t ? a.t : a.s;
    const float clip = is_t || kPair ? a.clip : 0.f;
    float v[kWW], u[kWW];
#pragma unroll
    for (int x = 0; x < kWW; ++x)
      if (x < nx) {
        v[x] = load_f32(src, base + x, a.dtype);
        if (kPair) u[x] = load_f32(a.t, base + x, a.dtype);
      }
    if (kPair) {
      float2* d = reinterpret_cast<float2*>(ws) + ch * kPlane + yy * kWW;
#pragma unroll
      for (int x = 0; x < kWW; ++x)
        if (x < nx)
          d[x] = make_float2(v[x] * kLog2e,
                             (clip > 0.f ? fminf(fmaxf(u[x], -clip), clip) : u[x]) * a.inv_t);
    } else {
      float* d = ws + tc * kPlane + yy * kWW;
#pragma unroll
      for (int x = 0; x < kWW; ++x)
        if (x < nx) d[x] = is_t ? (clip > 0.f ? fminf(fmaxf(v[x], -clip), clip) : v[x])
                                : v[x] * kLog2e;
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

Args make_args(int dtype, const void* s, const void* t, const void* labels,
               const void* lo_y, const void* fy, const void* lo_x, const void* fx,
               int n, int c, int h, int w, int H, int W, float inv_t, float clip,
               int ignore_index) {
  Args a{};
  a.s = s;
  a.t = t;
  a.labels = static_cast<const int64_t*>(labels);
  a.lo_y = static_cast<const int*>(lo_y);
  a.fy = static_cast<const float*>(fy);
  a.lo_x = static_cast<const int*>(lo_x);
  a.fx = static_cast<const float*>(fx);
  a.dtype = dtype;
  a.n = n; a.c = c; a.h = h; a.w = w; a.H = H; a.W = W;
  a.inv_t = inv_t;
  a.clip = clip;
  a.ignore_index = ignore_index;
  return a;
}

// ---------------------------------------------------------------------------
// kernel C (see the head of the file)
// ---------------------------------------------------------------------------

namespace cfw {

// CTAs of kThreads, kSlots at once on an H100: four an SM (the staging of
// one overlaps the others' pixels)
constexpr int kThreads = 128, kSlots = 4 * 132;

// C's tiles along an axis of `size` head pixels: tiles of `tile`, the last
// taking the rest (up to tile + 1)
__host__ __device__ inline int axis_tiles(int size, int tile) {
  const int t = (size + tile - 2) / tile;
  return t > 1 ? t : 1;
}
// the launch's plan: tiles, tiles a CTA walks (per), CTAs; and its
// dynamic shared memory: the windows, the tile's tap tables (lo and frac
// of reg_h rows and reg_w columns), the warps' sums and a flag
struct Plan {
  int tiles_y, tiles_x, tiles, per, grid;
};
__host__ __device__ inline Plan plan(int n, int h, int w) {
  Plan p;
  p.tiles_y = axis_tiles(h, kTY);
  p.tiles_x = axis_tiles(w, kTX);
  p.tiles = n * p.tiles_y * p.tiles_x;
  p.per = (p.tiles + kSlots - 1) / kSlots;
  p.grid = (p.tiles + p.per - 1) / p.per;
  return p;
}
__host__ __device__ inline int smem_bytes(int c, bool kl, int reg_h, int reg_w) {
  return 4 * ((kl ? 2 : 1) * c * kPlane + 2 * reg_h + 2 * reg_w + 4 * (kThreads / 32) + 4);
}

// CMAX bounds the class count C; kExact: C == CMAX, known at compile time.
// partials: (grid, 4) f32, the CTAs' (nll * valid, valid, kl, 0); ticket:
// zero between launches; out: (3,) f32
template <int CMAX, bool KL, bool kExact>
__global__ void __launch_bounds__(kThreads, 4)
ce_kl_up_fwd_kernel(const Args a, int reg_h, int reg_w, float* __restrict__ partials,
                    int* __restrict__ ticket, float* __restrict__ out) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x, C = kExact ? CMAX : a.c;
  const Plan pl = plan(a.n, a.h, a.w);
  float* ws = smem;                             // [c][kWH][kWW] (s, t) pairs, or s
  int* t_ly = reinterpret_cast<int*>(ws + (KL ? 2 : 1) * C * kPlane);   // [reg_h]
  float* t_fy = reinterpret_cast<float*>(t_ly + reg_h);        // [reg_h]
  int* t_lx = reinterpret_cast<int*>(t_fy + reg_h);            // [reg_w]
  float* t_fx = reinterpret_cast<float*>(t_lx + reg_w);        // [reg_w]
  float* red = t_fx + reg_w;                                   // [warps][4]
  int* flag = reinterpret_cast<int*>(red + 4 * (kThreads / 32));

  float nll_v = 0.f, valid_n = 0.f, kl = 0.f;   // this thread's sums, in pixel order
  const int t0 = blockIdx.x * pl.per, t1 = min(t0 + pl.per, pl.tiles);
  for (int tile = t0; tile < t1; ++tile) {
    const int img = tile / (pl.tiles_y * pl.tiles_x), r = tile - img * pl.tiles_y * pl.tiles_x;
    const int iy = r / pl.tiles_x, ix = r - iy * pl.tiles_x;
    const int y0 = iy * kTY, y1 = iy + 1 < pl.tiles_y ? y0 + kTY : a.h;
    const int x0 = ix * kTX, x1 = ix + 1 < pl.tiles_x ? x0 + kTX : a.w;
    const int rb = a.tb_y[iy], re = a.tb_y[iy + 1], qb = a.tb_x[ix], qe = a.tb_x[ix + 1];
    const int nr = re - rb, nq = qe - qb, npx = nr * nq;
    if (nr <= 0 || nq <= 0) continue;             // no output's lower taps fall here
    __syncthreads();                              // the last tile's readers are done
    stage<KL, true, kThreads>(ws, a, img, y0, min(y1, a.h - 1) - y0 + 1, x0,
                              min(x1, a.w - 1) - x0 + 1);
    for (int i = tid; i < nr; i += kThreads) t_ly[i] = a.lo_y[rb + i] - y0, t_fy[i] = a.fy[rb + i];
    for (int i = tid; i < nq; i += kThreads) t_lx[i] = a.lo_x[qb + i] - x0, t_fx[i] = a.fx[qb + i];
    __syncthreads();
    const int hy_max = a.h - 1 - y0, hx_max = a.w - 1 - x0;   // the clamp, window-relative
    // pixel i of the tile's nr x nq: row i / nq, taken as (i + 0.5) / nq in
    // f32, exact for i < 2^20 (it is at least 0.5 / nq from an integer);
    // its label loaded one pixel ahead
    const float inv_nq = 1.f / (float)nq;
    const int64_t* lrow = a.labels + ((size_t)img * a.H + rb) * a.W + qb;
    auto label = [&](int i) {
      const int rr = (int)(((float)i + 0.5f) * inv_nq);
      return i < npx ? __ldcs(lrow + (size_t)rr * a.W + i - rr * nq) : int64_t(0);
    };
    int64_t lbl_next = label(tid);
    for (int i = tid; i < npx; i += kThreads) {
      const int rr = (int)(((float)i + 0.5f) * inv_nq), qq = i - rr * nq;
      const int64_t lbl = lbl_next;
      lbl_next = label(i + kThreads);
      const int ly = t_ly[rr], lx = t_lx[qq];
      const int hy = min(ly + 1, hy_max), hx = min(lx + 1, hx_max);
      const float wy = t_fy[rr], wx = t_fx[qq];
      const float w00 = (1.f - wy) * (1.f - wx), w01 = (1.f - wy) * wx;
      const float w10 = wy * (1.f - wx), w11 = wy * wx;
      const int o00 = ly * kWW + lx, o01 = ly * kWW + hx;
      const int o10 = hy * kWW + lx, o11 = hy * kWW + hx;
      auto interp = [&](float v00, float v01, float v10, float v11) {
        return fmaf(w11, v11, fmaf(w10, v10, fmaf(w01, v01, w00 * v00)));
      };
      // s (log2 units) and t / T from the (s, t / T) pairs, or s alone
      float sv[CMAX], tv[CMAX], et[CMAX];
      float m_s = -INFINITY, m_t = -INFINITY;
#pragma unroll
      for (int ch = 0; ch < CMAX; ++ch) {
        if (ch < C) {
          if (KL) {
            const float2* p = reinterpret_cast<const float2*>(ws) + ch * kPlane;
            const float2 v00 = p[o00], v01 = p[o01], v10 = p[o10], v11 = p[o11];
            sv[ch] = interp(v00.x, v01.x, v10.x, v11.x);
            tv[ch] = interp(v00.y, v01.y, v10.y, v11.y);
            m_t = fmaxf(m_t, tv[ch]);
          } else {
            const float* p = ws + ch * kPlane;
            sv[ch] = interp(p[o00], p[o01], p[o10], p[o11]);
          }
          m_s = fmaxf(m_s, sv[ch]);
        }
      }
      // the three exponentials, each once: exp(s - m), exp(s/T - m/T) and
      // exp(t/T - m_t), the last kept for p_t
      const float m_sT = m_s * a.inv_t;
      float sum1 = 0.f, sum_s = 0.f, sum_t = 0.f;
#pragma unroll
      for (int ch = 0; ch < CMAX; ++ch) {
        if (ch < C) {
          sum1 += ex2(sv[ch] - m_s);
          if (KL) {
            sum_s += ex2(sv[ch] * a.inv_t - m_sT);
            et[ch] = ex2((tv[ch] - m_t) * kLog2e);
            sum_t += et[ch];
          }
        }
      }
      // s[label] from the window by the same arithmetic (0 outside [0, C))
      float s_lbl = 0.f;
      if (lbl >= 0 && lbl < C) {
        const int o = (int)lbl * kPlane * (KL ? 2 : 1);
        const int st = KL ? 2 : 1;
        s_lbl = interp(ws[o + st * o00], ws[o + st * o01], ws[o + st * o10], ws[o + st * o11]);
      }
      const float valid = lbl != a.ignore_index ? 1.f : 0.f;
      nll_v = fmaf(valid, (m_s + lg2(sum1) - s_lbl) * kLn2, nll_v);
      valid_n += valid;
      if (KL) {
        // natural units for t: lse_t and log_p_t; log2 units for s/T
        const float lse_t = fmaf(lg2(sum_t), kLn2, m_t), rt = 1.f / sum_t;
        const float lse_s2 = m_sT + lg2(sum_s);
        float k = 0.f;
#pragma unroll
        for (int ch = 0; ch < CMAX; ++ch) {
          if (ch < C) {
            // exp(max(d, -87)) = max(exp(d), e^-87): the clamp as a max
            const float lpt = fmaxf(tv[ch] - lse_t, kNegClamp);
            const float pt = fmaxf(et[ch] * rt, kExpNegClamp);
            const float lps2 = fmaf(sv[ch], a.inv_t, -lse_s2);
            k = fmaf(pt, fmaf(-kLn2, lps2, lpt), k);
          }
        }
        kl += k;
      }
    }
  }

  // the CTA's sums: warps by shuffles, then the warps in order
  nll_v = warp_sum(nll_v);
  valid_n = warp_sum(valid_n);
  kl = warp_sum(kl);
  if (tid % 32 == 0) {
    red[4 * (tid / 32)] = nll_v;
    red[4 * (tid / 32) + 1] = valid_n;
    red[4 * (tid / 32) + 2] = kl;
  }
  __syncthreads();
  if (tid < 4) {
    float v = 0.f;
    if (tid < 3)
#pragma unroll
      for (int wi = 0; wi < kThreads / 32; ++wi) v += red[4 * wi + tid];
    __stcg(partials + 4 * blockIdx.x + tid, v);
  }
  // the CTAs' partials, summed by the last CTA to finish: lane l adds
  // CTAs l, l + 32, .. in order, then the lanes by shuffles (a fixed tree)
  __threadfence();
  __syncthreads();
  if (tid == 0) *flag = atomicAdd(ticket, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!*flag || tid >= 32) return;
  __threadfence();
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int b = tid; b < (int)gridDim.x; b += 32) {
    const float4 q = __ldcg(reinterpret_cast<const float4*>(partials) + b);
    v.x += q.x, v.y += q.y, v.z += q.z;
  }
  v.x = warp_sum(v.x);
  v.y = warp_sum(v.y);
  v.z = warp_sum(v.z);
  if (tid == 0) {
    out[0] = v.x, out[1] = v.y, out[2] = v.z;
    *ticket = 0;
  }
}

template <int CMAX, bool KL, bool kExact>
cudaError_t run(const Args& a, int reg_h, int reg_w, float* partials, int* ticket, float* out,
                int grid, int smem, cudaStream_t stream) {
  static bool raised = false;   // the shared-memory opt-in, once per instance
  if (!raised) {
    const cudaError_t e = cudaFuncSetAttribute(ce_kl_up_fwd_kernel<CMAX, KL, kExact>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               kSmemMax);
    if (e != cudaSuccess) return e;
    raised = true;
  }
  ce_kl_up_fwd_kernel<CMAX, KL, kExact><<<grid, kThreads, smem, stream>>>(a, reg_h, reg_w,
                                                                           partials, ticket, out);
  return cudaGetLastError();
}

// the class counts of configs #2 and #3 exactly, every other up to 32
template <bool KL>
cudaError_t dispatch(const Args& a, int reg_h, int reg_w, float* partials, int* ticket,
                     float* out, int grid, int smem, cudaStream_t s) {
  if (a.c == 21) return run<21, KL, true>(a, reg_h, reg_w, partials, ticket, out, grid, smem, s);
  if (a.c == 19) return run<19, KL, true>(a, reg_h, reg_w, partials, ticket, out, grid, smem, s);
  if (a.c <= 8) return run<8, KL, false>(a, reg_h, reg_w, partials, ticket, out, grid, smem, s);
  if (a.c <= 16) return run<16, KL, false>(a, reg_h, reg_w, partials, ticket, out, grid, smem, s);
  if (a.c <= 24) return run<24, KL, false>(a, reg_h, reg_w, partials, ticket, out, grid, smem, s);
  if (a.c <= 32) return run<32, KL, false>(a, reg_h, reg_w, partials, ticket, out, grid, smem, s);
  return cudaErrorInvalidValue;
}

}  // namespace cfw

// ---------------------------------------------------------------------------
// kernel D (see the head of the file)
// ---------------------------------------------------------------------------

namespace dbw {

constexpr int kGroup = 8;          // classes a tap item carries

// Dynamic shared memory of a launch, in floats and ints of 4 bytes:
// windows ws [c][kWH][kWW] (and wt with KL), g [c][rows][gs_ld], the
// horizontal sums hs [c][rows][kTX], the tile's accumulators [c][kTY][kTX],
// then the tap tables: lo (relative to the window) and frac of reg_w
// columns and reg_h rows, [ob, oe) of kTX columns and kTY rows.
// ops/losses_fused.py bwd_smem_bytes mirrors it.
// A row of g holds column q at q + q / 32 and rows are gs_ld apart, 2 mod
// 4: in (b) the 16 head columns of a row read g 4 columns apart and the
// next row's 16 sit 2 banks over, so a warp's 32 reads hit 32 banks.
__host__ __device__ inline int gs_ld(int reg_w) {
  const int w = reg_w + (reg_w - 1) / 32 + 1;
  return w + ((6 - w % 4) % 4);
}
__host__ __device__ inline int smem_bytes(int c, bool kl, int reg_h, int reg_w, int rows) {
  return 4 * (c * ((kl ? 2 : 1) * kPlane + rows * gs_ld(reg_w) + rows * kTX +
                   kTY * kTX) +
              2 * reg_w + 2 * reg_h + 2 * kTX + 2 * kTY);
}

// CMAX bounds the class count C; kExact: C == CMAX, known at compile time
template <int CMAX, bool KL, bool kExact>
__global__ void __launch_bounds__(kThreads, 2)
ce_kl_up_bwd_kernel(const Args a, const float* __restrict__ scales, void* __restrict__ ds,
                    int reg_h, int reg_w, int rows) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x, img = blockIdx.z, C = kExact ? CMAX : a.c;
  const int y0 = blockIdx.y * kTY, x0 = blockIdx.x * kTX;
  const int y1 = min(y0 + kTY, a.h), x1 = min(x0 + kTX, a.w);
  const int ty = y1 - y0, tx = x1 - x0;
  // full-resolution pixels whose taps touch the tile
  const int rb = a.ob_y[y0], re = a.oe_y[y1 - 1];
  const int qb = a.ob_x[x0], qe = a.oe_x[x1 - 1];
  constexpr int plane = kPlane;
  float* ws = smem;                                   // [c][kWH][kWW]
  float* wt = ws + C * plane;                         // with KL
  const int ldg = gs_ld(reg_w);
  float* gs = ws + (KL ? 2 : 1) * C * plane;          // [c][rows][ldg], skewed
  float* hs = gs + C * rows * ldg;                    // [c][rows][kTX]
  float* acc = hs + C * rows * kTX;                   // [c][kTY][kTX]
  int* t_lx = reinterpret_cast<int*>(acc + C * kTY * kTX);   // [reg_w]
  float* t_fx = reinterpret_cast<float*>(t_lx + reg_w);      // [reg_w]
  int* t_ly = reinterpret_cast<int*>(t_fx + reg_w);          // [reg_h]
  float* t_fy = reinterpret_cast<float*>(t_ly + reg_h);      // [reg_h]
  int* t_obx = reinterpret_cast<int*>(t_fy + reg_h);         // [kTX], then oe
  int* t_oby = t_obx + 2 * kTX;                              // [kTY], then oe

  for (int i = tid; i < C * kTY * kTX; i += kThreads) acc[i] = 0.f;
  const int wy0 = rb < re ? a.lo_y[rb] : 0, wx0 = qb < qe ? a.lo_x[qb] : 0;
  if (rb < re && qb < qe) {
    const int ny = min(a.lo_y[re - 1] + 1, a.h - 1) - wy0 + 1;
    const int nx = min(a.lo_x[qe - 1] + 1, a.w - 1) - wx0 + 1;
    stage<KL, false, kThreads>(ws, a, img, wy0, ny, wx0, nx);
  }
  for (int i = tid; i < qe - qb; i += kThreads) {
    t_lx[i] = a.lo_x[qb + i] - wx0;
    t_fx[i] = a.fx[qb + i];
  }
  for (int i = tid; i < re - rb; i += kThreads) {
    t_ly[i] = a.lo_y[rb + i] - wy0;
    t_fy[i] = a.fy[rb + i];
  }
  if (tid < tx) t_obx[tid] = a.ob_x[x0 + tid], t_obx[kTX + tid] = a.oe_x[x0 + tid];
  if (tid < ty) t_oby[tid] = a.ob_y[y0 + tid], t_oby[kTY + tid] = a.oe_y[y0 + tid];
  __syncthreads();
  const float sa = scales[0], sk = scales[1];
  const int rw = qe - qb;
  const int hy_max = a.h - 1 - wy0, hx_max = a.w - 1 - wx0;   // the clamp, window-relative

  for (int rbase = rb; rbase < re; rbase += rows) {
    const int nr = min(rows, re - rbase);
    // (a) the per-pixel gradient of nr full-resolution rows -> gs
    for (int i = tid; i < nr * rw; i += kThreads) {
      const int rr = i / rw, qq = i - rr * rw;
      const int r = rbase + rr;
      const int ly = t_ly[r - rb], lx = t_lx[qq];
      const int hy = min(ly + 1, hy_max), hx = min(lx + 1, hx_max);
      const float wy = t_fy[r - rb], wx = t_fx[qq];
      const float w00 = (1.f - wy) * (1.f - wx), w01 = (1.f - wy) * wx;
      const float w10 = wy * (1.f - wx), w11 = wy * wx;
      const int o00 = ly * kWW + lx, o01 = ly * kWW + hx;
      const int o10 = hy * kWW + lx, o11 = hy * kWW + hx;
      const int64_t lbl = a.labels[((size_t)img * a.H + r) * a.W + qb + qq];
      const float valid = lbl != a.ignore_index ? 1.f : 0.f;
      float sv[CMAX], e2[CMAX], tv[CMAX];
      float m_s = -INFINITY, m_t = -INFINITY;
#pragma unroll
      for (int ch = 0; ch < CMAX; ++ch) {
        if (ch < C) {
          const float* p = ws + ch * plane;
          sv[ch] = fmaf(w11, p[o11], fmaf(w10, p[o10], fmaf(w01, p[o01], w00 * p[o00])));
          m_s = fmaxf(m_s, sv[ch]);
          if (KL) {   // rows, then columns, as kernel C
            const float* q = wt + ch * plane;
            const float tt = (1.f - wx) * q[o00] + wx * q[o01];
            const float tb = (1.f - wx) * q[o10] + wx * q[o11];
            tv[ch] = ((1.f - wy) * tt + wy * tb) * a.inv_t;
            m_t = fmaxf(m_t, tv[ch]);
          }
        }
      }
      // the three exponentials, each once, by ex2.approx of arguments in
      // log2 units (s prescaled; t/T - m_t scaled after the subtraction):
      // every argument is <= 0 after the max, results below 2^-126 flush
      // to 0. sv -> exp(s - m), e2 = exp(s/T - m/T), tv -> exp(t/T - m_t)
      const float m_sT = m_s * a.inv_t;
      float sum1 = 0.f, sum_s = 0.f, sum_t = 0.f;
#pragma unroll
      for (int ch = 0; ch < CMAX; ++ch) {
        if (ch < C) {
          if (KL) {
            e2[ch] = ex2(sv[ch] * a.inv_t - m_sT);
            sum_s += e2[ch];
            tv[ch] = ex2((tv[ch] - m_t) * kLog2e);
            sum_t += tv[ch];
          }
          sv[ch] = ex2(sv[ch] - m_s);
          sum1 += sv[ch];
        }
      }
      const float r1 = 1.f / sum1;
      const float rs = KL ? 1.f / sum_s : 0.f, rt = KL ? 1.f / sum_t : 0.f;
#pragma unroll
      for (int ch = 0; ch < CMAX; ++ch) {
        if (ch < C) {
          const float onehot = ch == lbl ? 1.f : 0.f;
          float g = sa * (sv[ch] * r1 - onehot) * valid;
          if (KL) g += sk * (e2[ch] * rs - tv[ch] * rt);
          gs[(ch * rows + rr) * ldg + qq + (qq >> 5)] = g;
        }
      }
    }
    __syncthreads();
    // (b) horizontal taps: (row, head column, 8 classes) -> hs, each
    //     column's weight taken once for the 8
    const int ng = (C + kGroup - 1) / kGroup;
    for (int i = tid; i < nr * tx * ng; i += kThreads) {
      const int cg = i / (nr * tx), rem = i - cg * nr * tx;
      const int rr = rem / tx, xl = rem - rr * tx;
      const int ix = x0 + xl - wx0;             // window-relative, as t_lx
      const float* grow = gs + (cg * kGroup * rows + rr) * ldg;
      float hsum[kGroup];
#pragma unroll
      for (int k = 0; k < kGroup; ++k) hsum[k] = 0.f;
      for (int q = t_obx[xl]; q < t_obx[kTX + xl]; ++q) {
        const int lx = t_lx[q - qb], hx = min(lx + 1, hx_max);
        const float f = t_fx[q - qb];
        const float wq = (lx == ix ? 1.f - f : 0.f) + (hx == ix ? f : 0.f);
#pragma unroll
        for (int k = 0; k < kGroup; ++k)
          if (cg * kGroup + k < C)
            hsum[k] += wq * grow[k * rows * ldg + (q - qb) + ((q - qb) >> 5)];
      }
#pragma unroll
      for (int k = 0; k < kGroup; ++k)
        if (cg * kGroup + k < C) hs[((cg * kGroup + k) * rows + rr) * kTX + xl] = hsum[k];
    }
    __syncthreads();
    // (c) vertical taps: each (head row, head column, 8 classes) adds the
    //     pass's rows that tap it, in order, the lower tap before the upper
    for (int i = tid; i < ty * tx * ng; i += kThreads) {
      const int cg = i / (ty * tx), rem = i - cg * ty * tx;
      const int iy = rem / tx, xl = rem - iy * tx;
      const int yy = y0 + iy - wy0;             // window-relative, as t_ly
      const int r0 = max(t_oby[iy], rbase), r1 = min(t_oby[kTY + iy], rbase + nr);
      if (r0 >= r1) continue;
      float* cell = acc + (cg * kGroup * kTY + iy) * kTX + xl;
      float v[kGroup];
#pragma unroll
      for (int k = 0; k < kGroup; ++k) v[k] = cg * kGroup + k < C ? cell[k * kTY * kTX] : 0.f;
      for (int r = r0; r < r1; ++r) {
        const int ly = t_ly[r - rb], hy = min(ly + 1, hy_max);
        const float f = t_fy[r - rb];
        const float* hrow = hs + (cg * kGroup * rows + r - rbase) * kTX + xl;
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {
          const float h = cg * kGroup + k < C ? hrow[k * rows * kTX] : 0.f;
          if (ly == yy) v[k] += (1.f - f) * h;
          if (hy == yy) v[k] += f * h;
        }
      }
#pragma unroll
      for (int k = 0; k < kGroup; ++k)
        if (cg * kGroup + k < C) cell[k * kTY * kTX] = v[k];
    }
  }
  __syncthreads();
  // the tile of ds, in the logits' dtype
  for (int i = tid; i < C * ty * tx; i += kThreads) {
    const int ch = i / (ty * tx), rem = i - ch * ty * tx;
    const int iy = rem / tx, ix = rem - iy * tx;
    const float v = acc[(ch * kTY + iy) * kTX + ix];
    const size_t o = ((size_t)(img * C + ch) * a.h + y0 + iy) * a.w + x0 + ix;
    if (a.dtype == 1) static_cast<__nv_bfloat16*>(ds)[o] = __float2bfloat16(v);
    else static_cast<float*>(ds)[o] = v;
  }
}

template <int CMAX, bool KL, bool kExact>
cudaError_t run(const Args& a, const float* scales, void* ds, int reg_h, int reg_w, int rows,
                int smem, cudaStream_t stream) {
  static bool raised = false;   // the shared-memory opt-in, once per instance
  if (!raised) {
    const cudaError_t e = cudaFuncSetAttribute(ce_kl_up_bwd_kernel<CMAX, KL, kExact>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               kSmemMax);
    if (e != cudaSuccess) return e;
    raised = true;
  }
  dim3 grid((a.w + kTX - 1) / kTX, (a.h + kTY - 1) / kTY, a.n);
  ce_kl_up_bwd_kernel<CMAX, KL, kExact><<<grid, kThreads, smem, stream>>>(a, scales, ds, reg_h,
                                                                           reg_w, rows);
  return cudaGetLastError();
}

// the class counts of configs #2 and #3 exactly, every other up to 32
template <bool KL>
cudaError_t dispatch(const Args& a, const float* scales, void* ds, int reg_h, int reg_w,
                     int rows, int smem, cudaStream_t s) {
  if (a.c == 21) return run<21, KL, true>(a, scales, ds, reg_h, reg_w, rows, smem, s);
  if (a.c == 19) return run<19, KL, true>(a, scales, ds, reg_h, reg_w, rows, smem, s);
  if (a.c <= 8) return run<8, KL, false>(a, scales, ds, reg_h, reg_w, rows, smem, s);
  if (a.c <= 16) return run<16, KL, false>(a, scales, ds, reg_h, reg_w, rows, smem, s);
  if (a.c <= 24) return run<24, KL, false>(a, scales, ds, reg_h, reg_w, rows, smem, s);
  if (a.c <= 32) return run<32, KL, false>(a, scales, ds, reg_h, reg_w, rows, smem, s);
  return cudaErrorInvalidValue;
}

}  // namespace dbw

}  // namespace

extern "C" {

// Kernel C. tb_y (tiles_y + 1), tb_x (tiles_x + 1) int32: the output rows
// and columns of C's head tiles (ops/losses_fused.py fwd_bounds); out (3,)
// f32; partials (grid, 4) f32 scratch; ticket one int32, zero, left zero.
// reg_h x reg_w (the most output rows and columns a tile owns), grid and
// smem are ops/losses_fused.py plan's and fwd_grid's: the kernel refuses
// another grid or shared memory size.
int kdcc_ce_kl_up_fwd(int dtype, const void* s, const void* t, const void* labels,
                      const void* lo_y, const void* fy, const void* lo_x, const void* fx,
                      const void* tb_y, const void* tb_x, void* out, void* partials,
                      void* ticket, int n, int c, int h, int w, int H, int W, float inv_t,
                      float clip, int ignore_index, int with_kl, int reg_h, int reg_w, int grid,
                      int smem, void* stream) {
  // a tile's pixel index is split into row and column in f32 (exact below 2^20)
  if ((dtype != 0 && dtype != 1) || c < 1 || n < 1 || h < 1 || w < 1 || reg_h < 1 ||
      reg_w < 1 || reg_h * reg_w >= (1 << 20) || grid != cfw::plan(n, h, w).grid ||
      smem != cfw::smem_bytes(c, with_kl != 0, reg_h, reg_w) || smem > kSmemMax)
    return (int)cudaErrorInvalidValue;
  Args a = make_args(dtype, s, t, labels, lo_y, fy, lo_x, fx, n, c, h, w, H, W, inv_t, clip,
                     ignore_index);
  a.tb_y = static_cast<const int*>(tb_y);
  a.tb_x = static_cast<const int*>(tb_x);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pa = static_cast<float*>(partials);
  int* tk = static_cast<int*>(ticket);
  float* o = static_cast<float*>(out);
  return (int)(with_kl ? cfw::dispatch<true>(a, reg_h, reg_w, pa, tk, o, grid, smem, st)
                       : cfw::dispatch<false>(a, reg_h, reg_w, pa, tk, o, grid, smem, st));
}

// Kernel D. scales: (a, k) f32 on the device; ds: (n, c, h, w) in dtype.
// win_h x win_w (at most kWH x kWW), reg_h x reg_w and rows are
// ops/losses_fused.py plan's; smem must be their layout's bytes.
int kdcc_ce_kl_up_bwd(int dtype, const void* s, const void* t, const void* labels,
                      const void* lo_y, const void* fy, const void* ob_y,
                      const void* oe_y, const void* lo_x, const void* fx,
                      const void* ob_x, const void* oe_x, const void* scales,
                      void* ds, int n, int c, int h, int w, int H, int W,
                      float inv_t, float clip, int ignore_index, int with_kl,
                      int win_h, int win_w, int reg_h, int reg_w, int rows, int smem,
                      void* stream) {
  if ((dtype != 0 && dtype != 1) || c < 1 || reg_h < 1 || reg_w < 1 || rows < 1 ||
      win_h > kWH || win_w > kWW ||
      smem != dbw::smem_bytes(c, with_kl != 0, reg_h, reg_w, rows) || smem > kSmemMax)
    return (int)cudaErrorInvalidValue;
  Args a = make_args(dtype, s, t, labels, lo_y, fy, lo_x, fx, n, c, h, w, H, W,
                     inv_t, clip, ignore_index);
  a.ob_y = static_cast<const int*>(ob_y);
  a.oe_y = static_cast<const int*>(oe_y);
  a.ob_x = static_cast<const int*>(ob_x);
  a.oe_x = static_cast<const int*>(oe_x);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scales);
  return (int)(with_kl ? dbw::dispatch<true>(a, sc, ds, reg_h, reg_w, rows, smem, st)
                       : dbw::dispatch<false>(a, sc, ds, reg_h, reg_w, rows, smem, st));
}

}  // extern "C"

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
// here each full-resolution pixel reads its 2x2 taps from a head-resolution
// window that the CTA stages once in shared memory (f32, the teacher clipped
// at head resolution, before the upsample, as the JAX kernel does).
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
// What bounds it on an H100: the special-function unit. Kernel C needs at
// least 3 exponentials per class and pixel (s, s/T, t/T): 265 M at config #2
// (16 x 21 x 513 x 513), ~63 us at 16 results per clock per SM, against
// ~17 us to read its ~56 MB (bf16 logits 2 x 11.2 MB, int64 labels 33.7 MB).
// Kernel C takes 4 exps per class and pixel (the KL's exp is computed as
// the formula states) and stages windows in f32 (its first design); kernel
// D takes the 3.
//
// Kernel C: one thread per output pixel, 16 x 16 pixels per CTA; the CTA
// reduces its pixels' (nll * valid, valid, kl) with shuffles in a fixed
// order and writes them as its partial; the wrapper sums the partials. No
// float atomics anywhere: the result is deterministic.
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
// with another's passes.
//
// The C entry points launch on the caller's stream and return
// cudaGetLastError(); the Python wrapper raises if it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kFwdTile = 16;           // kernel C: 16 x 16 output pixels
constexpr int kFwdThreads = kFwdTile * kFwdTile;
constexpr float kNegClamp = -87.f;

struct Args {
  const void* s;               // (n, c, h, w) float or bfloat16
  const void* t;               // same; unused without KL
  const int64_t* labels;       // (n, H, W)
  const int* lo_y;             // (H,) lower source row of each output row
  const float* fy;             // (H,) weight of the upper source row
  const int* lo_x;             // (W,)
  const float* fx;             // (W,)
  const int* ob_y;             // (h,) output rows [ob_y, oe_y) tap source row
  const int* oe_y;
  const int* ob_x;             // (w,)
  const int* oe_x;
  int dtype;                   // 0 float, 1 bfloat16
  int n, c, h, w, H, W;
  float inv_t, clip;           // clip 0: none
  int ignore_index;
  int win_h, win_w;            // staged window stride (max over CTAs)
};

__device__ __forceinline__ float load_f32(const void* p, size_t i, int dtype) {
  return dtype == 1 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                    : static_cast<const float*>(p)[i];
}

// Rows [y0, y0 + ny) x cols [x0, x0 + nx) of every class plane of image
// `img` into dst[c][win_h][win_w] as f32, clipped to +-clip when clip > 0.
__device__ void stage_window(float* dst, const void* src, const Args& a,
                             int img, int y0, int ny, int x0, int nx,
                             float clip, int tid, int nthreads) {
  const int per_c = ny * nx;
  for (int i = tid; i < a.c * per_c; i += nthreads) {
    const int ch = i / per_c, rem = i - ch * per_c;
    const int yy = rem / nx, xx = rem - yy * nx;
    float v = load_f32(src, ((size_t)(img * a.c + ch) * a.h + y0 + yy) * a.w
                                + x0 + xx, a.dtype);
    if (clip > 0.f) v = fminf(fmaxf(v, -clip), clip);
    dst[(ch * a.win_h + yy) * a.win_w + xx] = v;
  }
}

// The four taps of one output pixel inside a staged window.
struct Taps {
  int o00, o01, o10, o11;      // offsets within one class plane
  float wy, wx;                // weights of the upper row / right column
};

__device__ __forceinline__ Taps pixel_taps(const Args& a, int r, int q,
                                           int wy0, int wx0) {
  const int ly = a.lo_y[r], lx = a.lo_x[q];
  const int hy = min(ly + 1, a.h - 1), hx = min(lx + 1, a.w - 1);
  Taps t;
  t.o00 = (ly - wy0) * a.win_w + (lx - wx0);
  t.o01 = (ly - wy0) * a.win_w + (hx - wx0);
  t.o10 = (hy - wy0) * a.win_w + (lx - wx0);
  t.o11 = (hy - wy0) * a.win_w + (hx - wx0);
  t.wy = a.fy[r];
  t.wx = a.fx[q];
  return t;
}

__device__ __forceinline__ float interp(const float* plane, const Taps& t) {
  const float top = (1.f - t.wx) * plane[t.o00] + t.wx * plane[t.o01];
  const float bot = (1.f - t.wx) * plane[t.o10] + t.wx * plane[t.o11];
  return (1.f - t.wy) * top + t.wy * bot;
}

// One pixel's upsampled logits: sv[c] = s, tv[c] = clip(t) / T.
template <int CMAX, bool KL>
__device__ __forceinline__ void load_pixel(const float* ws, const float* wt,
                                           const Args& a, const Taps& tp,
                                           float (&sv)[CMAX],
                                           float (&tv)[CMAX], float& m_s,
                                           float& m_t) {
  const int plane = a.win_h * a.win_w;
  m_s = -INFINITY;
  m_t = -INFINITY;
#pragma unroll
  for (int ch = 0; ch < CMAX; ++ch) {
    if (ch < a.c) {
      sv[ch] = interp(ws + ch * plane, tp);
      m_s = fmaxf(m_s, sv[ch]);
      if (KL) {
        tv[ch] = interp(wt + ch * plane, tp) * a.inv_t;
        m_t = fmaxf(m_t, tv[ch]);
      }
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int CMAX, bool KL>
__global__ void __launch_bounds__(kFwdThreads)
ce_kl_up_fwd_kernel(Args a, float* partials) {
  extern __shared__ float smem[];
  __shared__ float red[kFwdThreads / 32][3];
  const int tid = threadIdx.y * kFwdTile + threadIdx.x;
  const int img = blockIdx.z;
  const int r0 = blockIdx.y * kFwdTile, q0 = blockIdx.x * kFwdTile;
  const int r1 = min(r0 + kFwdTile, a.H) - 1, q1 = min(q0 + kFwdTile, a.W) - 1;
  const int wy0 = a.lo_y[r0], wx0 = a.lo_x[q0];
  const int ny = min(a.lo_y[r1] + 1, a.h - 1) - wy0 + 1;
  const int nx = min(a.lo_x[q1] + 1, a.w - 1) - wx0 + 1;
  float* ws = smem;
  float* wt = smem + a.c * a.win_h * a.win_w;
  stage_window(ws, a.s, a, img, wy0, ny, wx0, nx, 0.f, tid, kFwdThreads);
  if (KL) stage_window(wt, a.t, a, img, wy0, ny, wx0, nx, a.clip, tid, kFwdThreads);
  __syncthreads();

  float nll_v = 0.f, valid = 0.f, kl = 0.f;
  const int r = r0 + threadIdx.y, q = q0 + threadIdx.x;
  if (r < a.H && q < a.W) {
    const Taps tp = pixel_taps(a, r, q, wy0, wx0);
    const int64_t lbl = a.labels[((size_t)img * a.H + r) * a.W + q];
    float sv[CMAX], tv[CMAX], m_s, m_t;
    load_pixel<CMAX, KL>(ws, wt, a, tp, sv, tv, m_s, m_t);
    const float m_sT = m_s * a.inv_t;
    float sum1 = 0.f, sum_s = 0.f, sum_t = 0.f, s_lbl = 0.f;
#pragma unroll
    for (int ch = 0; ch < CMAX; ++ch) {
      if (ch < a.c) {
        sum1 += expf(sv[ch] - m_s);
        if (ch == lbl) s_lbl = sv[ch];
        if (KL) {
          sum_s += expf(sv[ch] * a.inv_t - m_sT);
          sum_t += expf(tv[ch] - m_t);
        }
      }
    }
    valid = lbl != a.ignore_index ? 1.f : 0.f;
    nll_v = valid * (m_s + logf(sum1) - s_lbl);
    if (KL) {
      const float lse_s = m_sT + logf(sum_s), lse_t = m_t + logf(sum_t);
#pragma unroll
      for (int ch = 0; ch < CMAX; ++ch) {
        if (ch < a.c) {
          const float lpt = fmaxf(tv[ch] - lse_t, kNegClamp);
          const float lps = sv[ch] * a.inv_t - lse_s;
          kl += expf(lpt) * (lpt - lps);
        }
      }
    }
  }
  nll_v = warp_sum(nll_v);
  valid = warp_sum(valid);
  kl = warp_sum(kl);
  if ((tid & 31) == 0) {
    red[tid >> 5][0] = nll_v;
    red[tid >> 5][1] = valid;
    red[tid >> 5][2] = kl;
  }
  __syncthreads();
  if (tid < 3) {
    float v = 0.f;
#pragma unroll
    for (int i = 0; i < kFwdThreads / 32; ++i) v += red[i][tid];
    const size_t cta = ((size_t)img * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    partials[cta * 3 + tid] = v;
  }
}

template <int CMAX, bool KL>
cudaError_t run_fwd(const Args& a, float* partials, int smem, cudaStream_t stream) {
  auto k = ce_kl_up_fwd_kernel<CMAX, KL>;
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.W + kFwdTile - 1) / kFwdTile, (a.H + kFwdTile - 1) / kFwdTile, a.n);
  k<<<grid, dim3(kFwdTile, kFwdTile), smem, stream>>>(a, partials);
  return cudaGetLastError();
}

// One instantiation per class bound (registers hold one pixel's logits).
template <bool KL>
cudaError_t dispatch_fwd(const Args& a, float* partials, int smem, cudaStream_t s) {
  if (a.c <= 8) return run_fwd<8, KL>(a, partials, smem, s);
  if (a.c <= 16) return run_fwd<16, KL>(a, partials, smem, s);
  if (a.c <= 24) return run_fwd<24, KL>(a, partials, smem, s);
  if (a.c <= 32) return run_fwd<32, KL>(a, partials, smem, s);
  return cudaErrorInvalidValue;
}

Args make_args(int dtype, const void* s, const void* t, const void* labels,
               const void* lo_y, const void* fy, const void* lo_x, const void* fx,
               int n, int c, int h, int w, int H, int W, float inv_t, float clip,
               int ignore_index, int win_h, int win_w) {
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
  a.win_h = win_h;
  a.win_w = win_w;
  return a;
}

// ---------------------------------------------------------------------------
// kernel D (see the head of the file)
// ---------------------------------------------------------------------------

namespace dbw {

constexpr int kThreads = 256;
constexpr int kTY = 8, kTX = 16;   // the head-resolution tile
// a tile's window: its full-resolution pixels tap head rows and columns
// within one of the tile, so [kTY + 2][kTX + 2] holds every window, and the
// compile-time plane lets a class's taps be immediate offsets
constexpr int kWH = kTY + 2, kWW = kTX + 2, kPlane = kWH * kWW;
constexpr int kGroup = 8;          // classes a tap item carries
constexpr int kSmemMax = 232448;

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

// The windows of s and (with KL) t: rows [y0, y0 + ny) x cols [x0, x0 +
// nx) of every class plane of image img into ws / wt [c][kWH][kWW] as f32,
// s scaled by log2(e) (its exponentials below are powers of 2 of it), t
// clipped to +-clip and not scaled (at the clip |t| / T reaches 7500, where
// a scaled copy would round coarser than t itself). A thread takes a
// (tensor, class, row): one address, the row's loads all in flight, then
// its stores.
constexpr float kLog2e = 1.4426950408889634f;
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
template <bool KL>
__device__ void stage(float* ws, const Args& a, int img, int y0, int ny, int x0, int nx) {
  for (int it = threadIdx.x; it < (KL ? 2 : 1) * a.c * ny; it += kThreads) {
    const int tc = it / ny, yy = it - tc * ny;    // tensor * c + class, row
    const bool is_t = KL && tc >= a.c;
    const int ch = is_t ? tc - a.c : tc;
    const size_t base = ((size_t)(img * a.c + ch) * a.h + y0 + yy) * a.w + x0;
    const void* src = is_t ? a.t : a.s;
    const float clip = is_t ? a.clip : 0.f;
    float v[kWW];
#pragma unroll
    for (int x = 0; x < kWW; ++x)
      if (x < nx) v[x] = load_f32(src, base + x, a.dtype);
    float* d = ws + tc * kPlane + yy * kWW;
#pragma unroll
    for (int x = 0; x < kWW; ++x)
      if (x < nx) d[x] = is_t ? (clip > 0.f ? fminf(fmaxf(v[x], -clip), clip) : v[x])
                              : v[x] * kLog2e;
  }
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
    stage<KL>(ws, a, img, wy0, ny, wx0, nx);
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

// Kernel C. partials: (n * ceil(H/16) * ceil(W/16), 3) f32.
int kdcc_ce_kl_up_fwd(int dtype, const void* s, const void* t, const void* labels,
                      const void* lo_y, const void* fy, const void* lo_x,
                      const void* fx, void* partials, int n, int c, int h, int w,
                      int H, int W, float inv_t, float clip, int ignore_index,
                      int with_kl, int win_h, int win_w, int smem, void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const Args a = make_args(dtype, s, t, labels, lo_y, fy, lo_x, fx, n, c, h, w, H, W,
                           inv_t, clip, ignore_index, win_h, win_w);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(partials);
  return (int)(with_kl ? dispatch_fwd<true>(a, out, smem, st)
                       : dispatch_fwd<false>(a, out, smem, st));
}

// Kernel D. scales: (a, k) f32 on the device; ds: (n, c, h, w) in dtype.
// win_h x win_w (at most dbw::kWH x kWW), reg_h x reg_w and rows are
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
      win_h > dbw::kWH || win_w > dbw::kWW ||
      smem != dbw::smem_bytes(c, with_kl != 0, reg_h, reg_w, rows) || smem > dbw::kSmemMax)
    return (int)cudaErrorInvalidValue;
  Args a = make_args(dtype, s, t, labels, lo_y, fy, lo_x, fx, n, c, h, w, H, W,
                     inv_t, clip, ignore_index, win_h, win_w);
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

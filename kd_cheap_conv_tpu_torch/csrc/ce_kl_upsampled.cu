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
// This first version does 4 exps per class and pixel in C (the KL's exp is
// computed as the formula states) and 5 in D, and stages windows in f32:
// making it fast is later work.
//
// Kernel C: one thread per output pixel, 16 x 16 pixels per CTA; the CTA
// reduces its pixels' (nll * valid, valid, kl) with shuffles in a fixed
// order and writes them as its partial; the wrapper sums the partials. No
// float atomics anywhere: the result is deterministic.
//
// Kernel D: gather form. A CTA owns an 8 x 16 tile of ds (head resolution)
// for all classes, recomputes the per-pixel gradient
//   g = a * (softmax(s) - onehot) * valid + k * (softmax(s/T) - softmax(t/T))
// on every full-resolution pixel that taps the tile (a ~1.2x overlap with
// the neighbouring tiles), a few full-resolution rows at a time into shared
// memory, and accumulates the transposed interpolation into the tile in
// shared memory: each (class, column) cell is owned by one thread and its
// sums run in a fixed order. a and k come from a device buffer (the folded
// cotangents), so the backward needs no host sync.
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
constexpr int kBwdTY = 8, kBwdTX = 16;  // kernel D: head-resolution tile
constexpr int kBwdThreads = 256;
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
__global__ void __launch_bounds__(kBwdThreads)
ce_kl_up_bwd_kernel(Args a, const float* scales, void* ds, int reg_w, int rows) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int img = blockIdx.z;
  const int y0 = blockIdx.y * kBwdTY, x0 = blockIdx.x * kBwdTX;
  const int y1 = min(y0 + kBwdTY, a.h), x1 = min(x0 + kBwdTX, a.w);
  const int ty = y1 - y0, tx = x1 - x0;
  // full-resolution pixels whose taps touch the tile
  const int rb = a.ob_y[y0], re = a.oe_y[y1 - 1];
  const int qb = a.ob_x[x0], qe = a.oe_x[x1 - 1];
  const int plane = a.win_h * a.win_w;
  float* acc = smem;                                   // [c][kBwdTY][kBwdTX]
  float* gs = acc + a.c * kBwdTY * kBwdTX;             // [c][rows][reg_w]
  float* ws = gs + a.c * rows * reg_w;                 // [c][win_h][win_w]
  float* wt = ws + a.c * plane;
  for (int i = tid; i < a.c * kBwdTY * kBwdTX; i += kBwdThreads) acc[i] = 0.f;
  int wy0 = 0, wx0 = 0;
  if (rb < re && qb < qe) {
    wy0 = a.lo_y[rb];
    wx0 = a.lo_x[qb];
    const int ny = min(a.lo_y[re - 1] + 1, a.h - 1) - wy0 + 1;
    const int nx = min(a.lo_x[qe - 1] + 1, a.w - 1) - wx0 + 1;
    stage_window(ws, a.s, a, img, wy0, ny, wx0, nx, 0.f, tid, kBwdThreads);
    if (KL) stage_window(wt, a.t, a, img, wy0, ny, wx0, nx, a.clip, tid, kBwdThreads);
  }
  __syncthreads();
  const float sa = scales[0], sk = scales[1];
  const int rw = qe - qb;

  for (int rbase = rb; rbase < re; rbase += rows) {
    const int nr = min(rows, re - rbase);
    // 1. the per-pixel gradient of nr full-resolution rows -> gs
    for (int i = tid; i < nr * rw; i += kBwdThreads) {
      const int rr = i / rw, qq = i - rr * rw;
      const int r = rbase + rr, q = qb + qq;
      const Taps tp = pixel_taps(a, r, q, wy0, wx0);
      const int64_t lbl = a.labels[((size_t)img * a.H + r) * a.W + q];
      const float valid = lbl != a.ignore_index ? 1.f : 0.f;
      float sv[CMAX], tv[CMAX], m_s, m_t;
      load_pixel<CMAX, KL>(ws, wt, a, tp, sv, tv, m_s, m_t);
      const float m_sT = m_s * a.inv_t;
      float sum1 = 0.f, sum_s = 0.f, sum_t = 0.f;
#pragma unroll
      for (int ch = 0; ch < CMAX; ++ch) {
        if (ch < a.c) {
          sum1 += expf(sv[ch] - m_s);
          if (KL) {
            sum_s += expf(sv[ch] * a.inv_t - m_sT);
            tv[ch] = expf(tv[ch] - m_t);
            sum_t += tv[ch];
          }
        }
      }
      const float r1 = 1.f / sum1;
      const float rs = KL ? 1.f / sum_s : 0.f, rt = KL ? 1.f / sum_t : 0.f;
#pragma unroll
      for (int ch = 0; ch < CMAX; ++ch) {
        if (ch < a.c) {
          const float onehot = ch == lbl ? 1.f : 0.f;
          float g = sa * (expf(sv[ch] - m_s) * r1 - onehot) * valid;
          if (KL) g += sk * (expf(sv[ch] * a.inv_t - m_sT) * rs - tv[ch] * rt);
          gs[(ch * rows + rr) * reg_w + qq] = g;
        }
      }
    }
    __syncthreads();
    // 2. transposed interpolation: each (class, column) cell sums its
    //    columns' taps, then adds the row taps, rows in order
    for (int i = tid; i < a.c * tx; i += kBwdThreads) {
      const int ch = i / tx, ix = x0 + (i - ch * tx);
      const int cb = a.ob_x[ix], ce = a.oe_x[ix];
      float* col = acc + ch * kBwdTY * kBwdTX + (ix - x0);
      for (int rr = 0; rr < nr; ++rr) {
        const float* grow = gs + (ch * rows + rr) * reg_w - qb;
        float hsum = 0.f;
        for (int q = cb; q < ce; ++q) {
          const int lx = a.lo_x[q], hx = min(lx + 1, a.w - 1);
          const float wq = (lx == ix ? 1.f - a.fx[q] : 0.f) + (hx == ix ? a.fx[q] : 0.f);
          hsum += wq * grow[q];
        }
        const int r = rbase + rr;
        const int ly = a.lo_y[r], hy = min(ly + 1, a.h - 1);
        const float fyr = a.fy[r];
        if (ly >= y0 && ly < y1) col[(ly - y0) * kBwdTX] += (1.f - fyr) * hsum;
        if (hy >= y0 && hy < y1) col[(hy - y0) * kBwdTX] += fyr * hsum;
      }
    }
    __syncthreads();
  }
  // 3. the tile of ds, in the logits' dtype
  for (int i = tid; i < a.c * ty * tx; i += kBwdThreads) {
    const int ch = i / (ty * tx), rem = i - ch * ty * tx;
    const int iy = rem / tx, ix = rem - iy * tx;
    const float v = acc[(ch * kBwdTY + iy) * kBwdTX + ix];
    const size_t o = ((size_t)(img * a.c + ch) * a.h + y0 + iy) * a.w + x0 + ix;
    if (a.dtype == 1) static_cast<__nv_bfloat16*>(ds)[o] = __float2bfloat16(v);
    else static_cast<float*>(ds)[o] = v;
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

template <int CMAX, bool KL>
cudaError_t run_bwd(const Args& a, const float* scales, void* ds, int reg_w,
                    int rows, int smem, cudaStream_t stream) {
  auto k = ce_kl_up_bwd_kernel<CMAX, KL>;
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.w + kBwdTX - 1) / kBwdTX, (a.h + kBwdTY - 1) / kBwdTY, a.n);
  k<<<grid, kBwdThreads, smem, stream>>>(a, scales, ds, reg_w, rows);
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

template <bool KL>
cudaError_t dispatch_bwd(const Args& a, const float* scales, void* ds, int reg_w,
                         int rows, int smem, cudaStream_t s) {
  if (a.c <= 8) return run_bwd<8, KL>(a, scales, ds, reg_w, rows, smem, s);
  if (a.c <= 16) return run_bwd<16, KL>(a, scales, ds, reg_w, rows, smem, s);
  if (a.c <= 24) return run_bwd<24, KL>(a, scales, ds, reg_w, rows, smem, s);
  if (a.c <= 32) return run_bwd<32, KL>(a, scales, ds, reg_w, rows, smem, s);
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
int kdcc_ce_kl_up_bwd(int dtype, const void* s, const void* t, const void* labels,
                      const void* lo_y, const void* fy, const void* ob_y,
                      const void* oe_y, const void* lo_x, const void* fx,
                      const void* ob_x, const void* oe_x, const void* scales,
                      void* ds, int n, int c, int h, int w, int H, int W,
                      float inv_t, float clip, int ignore_index, int with_kl,
                      int win_h, int win_w, int reg_w, int rows, int smem,
                      void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  Args a = make_args(dtype, s, t, labels, lo_y, fy, lo_x, fx, n, c, h, w, H, W,
                     inv_t, clip, ignore_index, win_h, win_w);
  a.ob_y = static_cast<const int*>(ob_y);
  a.oe_y = static_cast<const int*>(oe_y);
  a.ob_x = static_cast<const int*>(ob_x);
  a.oe_x = static_cast<const int*>(oe_x);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scales);
  return (int)(with_kl ? dispatch_bwd<true>(a, sc, ds, reg_w, rows, smem, st)
                       : dispatch_bwd<false>(a, sc, ds, reg_w, rows, smem, st));
}

}  // extern "C"

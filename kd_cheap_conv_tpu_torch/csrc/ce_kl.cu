// Pixelwise CE + softened KL on full-resolution class-major logits, forward
// and backward (the cached-teacher step's loss).
//
// Replaces the Pallas kernels of kd_cheap_conv_tpu/ops/pallas/losses.py
// `fused_ce_kl_loss` (:150):
//   forward  _fwd_kernel (:33)  -> ce_kl_fwd_kernel: per-CTA partial sums
//                                  (nll * valid, valid, kl)
//   backward _bwd_kernel (:80)  -> ce_kl_bwd_kernel: ds in one pass
// The same loss as kernels C and D (ce_kl_upsampled.cu) without the
// upsample gather. Per pixel, in f32:
//   nll = lse(s) - s[label]           (a label outside [0, C): s[label] = 0)
//   t   = clip(t, +-clip) / T,  log_p_t = max(t - lse(t), -87)
//   kl  = sum_c exp(log_p_t) * (log_p_t - (s / T - lse(s / T)))
//   ds  = a * (softmax(s) - onehot) * valid + k * (softmax(s / T) - softmax(t))
// valid = label != ignore; CE sums valid pixels, KL every pixel. (a, k) are
// the grad scales the autograd backward folds from the three cotangents (the
// JAX package's _grad_scales), read from device memory: no host sync.
//
// Layouts: s (n, c, h, w) contiguous, f32 or bf16; ds the same. The teacher
// t is (n, c, h, w) by its strides: class-major, or the NHWC memory of the
// cache (class stride 1, pixel stride c), in f32, bf16 or f16 (the cache's
// own dtype: widening f16 to f32 is exact, so the kernel reads the stored
// values and the host never widens them). Labels int64 (n, h, w).
//
// What bounds it on an H100: bytes. At config #1's step (16 x 21 x 513²,
// s bf16, t f16 NHWC, int64 labels) the forward reads 177 + 177 + 34 MB
// (0.116 ms at 3.35 TB/s) and the backward writes ds's 177 MB more; the
// exponentials (4 per class and pixel forward, 3 backward) take ~0.06-0.08
// ms on the special-function units. One thread per pixel keeps its C
// logits in registers: a warp reads each class plane of s in one 64- or
// 128-byte segment, and the teacher's NHWC rows as one contiguous span.
//
// Determinism: no float atomics. Each CTA reduces its pixels' three sums
// with shuffles in a fixed order and writes them as its partial; the
// wrapper sums the partials in a fixed order.
//
// The C entry points launch on the caller's stream and return
// cudaGetLastError(); the Python wrapper raises if it is not 0.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kNegClamp = -87.f;

struct Args {
  const void* s;            // (n, c, hw) f32 or bf16
  const void* t;            // image stride c * hw, class stride t_cs, pixel stride t_ps
  const int64_t* labels;    // (n, hw)
  int s_dt, t_dt;           // 0 f32, 1 bf16, 2 f16
  int n, c, hw;
  int t_cs, t_ps;
  float temp, clip;         // clip 0: none
  int ignore_index;
};

__device__ __forceinline__ float load(const void* p, size_t i, int dt) {
  if (dt == 1) return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  if (dt == 2) return __half2float(static_cast<const __half*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

// one pixel's logits: sv[c] = s, tv[c] = clip(t) / T; their maxima
template <int CMAX>
__device__ __forceinline__ void load_pixel(const Args& a, int img, int pix, float (&sv)[CMAX],
                                           float (&tv)[CMAX], float& m_s, float& m_t) {
  const size_t sb = (size_t)img * a.c * a.hw + pix;
  const size_t tb = (size_t)img * a.c * a.hw + (size_t)pix * a.t_ps;
  m_s = -INFINITY;
  m_t = -INFINITY;
#pragma unroll
  for (int ch = 0; ch < CMAX; ++ch) {
    if (ch < a.c) {
      sv[ch] = load(a.s, sb + (size_t)ch * a.hw, a.s_dt);
      float t = load(a.t, tb + (size_t)ch * a.t_cs, a.t_dt);
      if (a.clip > 0.f) t = fminf(fmaxf(t, -a.clip), a.clip);
      tv[ch] = t / a.temp;
      m_s = fmaxf(m_s, sv[ch]);
      m_t = fmaxf(m_t, tv[ch]);
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int CMAX>
__global__ void __launch_bounds__(kThreads) ce_kl_fwd_kernel(Args a, float* partials) {
  __shared__ float red[kThreads / 32][3];
  const int img = blockIdx.y, pix = blockIdx.x * kThreads + threadIdx.x;
  float nll_v = 0.f, valid = 0.f, kl = 0.f;
  if (pix < a.hw) {
    float sv[CMAX], tv[CMAX], m_s, m_t;
    load_pixel<CMAX>(a, img, pix, sv, tv, m_s, m_t);
    const int64_t lbl = a.labels[(size_t)img * a.hw + pix];
    // s / T is monotone in s: its maximum is m_s / T
    const float m_sT = m_s / a.temp;
    float sum1 = 0.f, sum_s = 0.f, sum_t = 0.f, s_lbl = 0.f;
#pragma unroll
    for (int ch = 0; ch < CMAX; ++ch) {
      if (ch < a.c) {
        sum1 += expf(sv[ch] - m_s);
        sum_s += expf(sv[ch] / a.temp - m_sT);
        sum_t += expf(tv[ch] - m_t);
        if (ch == lbl) s_lbl = sv[ch];
      }
    }
    valid = lbl != a.ignore_index ? 1.f : 0.f;
    nll_v = valid * (m_s + logf(sum1) - s_lbl);
    const float lse_s = m_sT + logf(sum_s), lse_t = m_t + logf(sum_t);
#pragma unroll
    for (int ch = 0; ch < CMAX; ++ch) {
      if (ch < a.c) {
        const float lpt = fmaxf(tv[ch] - lse_t, kNegClamp);
        kl += expf(lpt) * (lpt - (sv[ch] / a.temp - lse_s));
      }
    }
  }
  nll_v = warp_sum(nll_v);
  valid = warp_sum(valid);
  kl = warp_sum(kl);
  const int tid = threadIdx.x;
  if ((tid & 31) == 0) {
    red[tid >> 5][0] = nll_v;
    red[tid >> 5][1] = valid;
    red[tid >> 5][2] = kl;
  }
  __syncthreads();
  if (tid < 3) {
    float v = 0.f;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) v += red[i][tid];
    partials[((size_t)img * gridDim.x + blockIdx.x) * 3 + tid] = v;
  }
}

template <int CMAX>
__global__ void __launch_bounds__(kThreads)
ce_kl_bwd_kernel(Args a, const float* __restrict__ scales, void* __restrict__ ds) {
  const int img = blockIdx.y, pix = blockIdx.x * kThreads + threadIdx.x;
  if (pix >= a.hw) return;
  float sv[CMAX], tv[CMAX], es[CMAX], m_s, m_t;
  load_pixel<CMAX>(a, img, pix, sv, tv, m_s, m_t);
  const int64_t lbl = a.labels[(size_t)img * a.hw + pix];
  const float m_sT = m_s / a.temp;
  float sum1 = 0.f, sum_s = 0.f, sum_t = 0.f;
#pragma unroll
  for (int ch = 0; ch < CMAX; ++ch) {
    if (ch < a.c) {
      es[ch] = expf(sv[ch] / a.temp - m_sT);
      sv[ch] = expf(sv[ch] - m_s);
      tv[ch] = expf(tv[ch] - m_t);
      sum1 += sv[ch];
      sum_s += es[ch];
      sum_t += tv[ch];
    }
  }
  const float sa = lbl != a.ignore_index ? scales[0] : 0.f, sk = scales[1];
  const size_t sb = (size_t)img * a.c * a.hw + pix;
#pragma unroll
  for (int ch = 0; ch < CMAX; ++ch) {
    if (ch < a.c) {
      const float onehot = ch == lbl ? 1.f : 0.f;
      const float g = sa * (sv[ch] / sum1 - onehot) + sk * (es[ch] / sum_s - tv[ch] / sum_t);
      const size_t o = sb + (size_t)ch * a.hw;
      if (a.s_dt == 1) static_cast<__nv_bfloat16*>(ds)[o] = __float2bfloat16(g);
      else static_cast<float*>(ds)[o] = g;
    }
  }
}

// One instantiation per class bound (registers hold one pixel's logits).
template <int CMAX>
cudaError_t run(const Args& a, const float* scales, void* out, bool bwd, cudaStream_t st) {
  const dim3 grid((a.hw + kThreads - 1) / kThreads, a.n);
  if (bwd) ce_kl_bwd_kernel<CMAX><<<grid, kThreads, 0, st>>>(a, scales, out);
  else ce_kl_fwd_kernel<CMAX><<<grid, kThreads, 0, st>>>(a, static_cast<float*>(out));
  return cudaGetLastError();
}

int dispatch(const Args& a, const float* scales, void* out, bool bwd, void* stream) {
  if ((a.s_dt != 0 && a.s_dt != 1) || a.t_dt < 0 || a.t_dt > 2 || a.c < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.c <= 8) return (int)run<8>(a, scales, out, bwd, st);
  if (a.c <= 16) return (int)run<16>(a, scales, out, bwd, st);
  if (a.c <= 24) return (int)run<24>(a, scales, out, bwd, st);
  if (a.c <= 32) return (int)run<32>(a, scales, out, bwd, st);
  return (int)cudaErrorInvalidValue;
}

Args make_args(int s_dt, int t_dt, const void* s, const void* t, const void* labels, int n,
               int c, int hw, int t_cs, int t_ps, float temp, float clip, int ignore_index) {
  Args a{};
  a.s = s;
  a.t = t;
  a.labels = static_cast<const int64_t*>(labels);
  a.s_dt = s_dt;
  a.t_dt = t_dt;
  a.n = n; a.c = c; a.hw = hw;
  a.t_cs = t_cs; a.t_ps = t_ps;
  a.temp = temp;
  a.clip = clip;
  a.ignore_index = ignore_index;
  return a;
}

}  // namespace

extern "C" {

// Forward. partials: (n * ceil(hw / 256), 3) f32.
int kdcc_ce_kl_fwd(int s_dt, int t_dt, const void* s, const void* t, const void* labels,
                   void* partials, int n, int c, int hw, int t_cs, int t_ps, float temp,
                   float clip, int ignore_index, void* stream) {
  const Args a = make_args(s_dt, t_dt, s, t, labels, n, c, hw, t_cs, t_ps, temp, clip,
                           ignore_index);
  return dispatch(a, nullptr, partials, false, stream);
}

// Backward. scales: (a, k) f32 on the device; ds: (n, c, hw) in s's dtype.
int kdcc_ce_kl_bwd(int s_dt, int t_dt, const void* s, const void* t, const void* labels,
                   const void* scales, void* ds, int n, int c, int hw, int t_cs, int t_ps,
                   float temp, float clip, int ignore_index, void* stream) {
  const Args a = make_args(s_dt, t_dt, s, t, labels, n, c, hw, t_cs, t_ps, temp, clip,
                           ignore_index);
  return dispatch(a, static_cast<const float*>(scales), ds, true, stream);
}

}  // extern "C"

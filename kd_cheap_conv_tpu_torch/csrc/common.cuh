// Device helpers shared by the kernel sources: dtype conversion, 2- and
// 8-channel vector loads and stores, the BN arithmetic and the activations
// of the train-mode passes.
//
// The BN arithmetic is rounded as the plain versions' separate torch ops
// round it (no FMA contraction, 1 / sqrt correctly rounded), so a relu or
// relu6 mask computed here is the plain version's, bit for bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
// the value v has as an operand in the activation dtype
template <typename T> __device__ __forceinline__ float rounded(float v) {
  return to_f<T>(from_f<T>(v));
}

// two adjacent channels (the pointer is 2-element aligned: C is even)
template <typename T> __device__ __forceinline__ float2 load2(const T* p);
template <> __device__ __forceinline__ float2 load2<float>(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
template <> __device__ __forceinline__ float2 load2<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
template <typename T> __device__ __forceinline__ void store2(T* p, float a, float b);
template <> __device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <> __device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p, float a,
                                                                   float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// eight adjacent channels (the pointer is 16-byte aligned: C % 8 == 0)
template <typename T> __device__ __forceinline__ void load8(const T* p, float* v);
template <> __device__ __forceinline__ void load8<float>(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
template <> __device__ __forceinline__ void load8<__nv_bfloat16>(const __nv_bfloat16* p,
                                                                float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
template <typename T> __device__ __forceinline__ void store8(T* p, const float* v);
template <> __device__ __forceinline__ void store8<float>(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
template <> __device__ __forceinline__ void store8<__nv_bfloat16>(__nv_bfloat16* p,
                                                                 const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// 1 / sqrt(var + eps), correctly rounded as the plain version's
// 1 / torch.sqrt(var + eps) is
__device__ __forceinline__ float inv_std(float var, float eps) {
  return __frcp_rn(__fsqrt_rn(var + eps));
}

// One BN's forward constants from its pack (mean, var, gamma, beta); a null
// pack is the identity.
struct Bn {
  float mean, inv, gamma, beta;
};
__device__ __forceinline__ Bn load_bn(const float* bn, int c, float eps) {
  if (bn == nullptr) return Bn{0.f, 1.f, 1.f, 0.f};
  return Bn{bn[4 * c], inv_std(bn[4 * c + 1], eps), bn[4 * c + 2], bn[4 * c + 3]};
}
// xhat and u = xhat * gamma + beta
__device__ __forceinline__ float bn_xh(float a, const Bn& b) {
  return __fmul_rn(__fsub_rn(a, b.mean), b.inv);
}
__device__ __forceinline__ float bn_u(float xh, const Bn& b) {
  return __fadd_rn(__fmul_rn(xh, b.gamma), b.beta);
}

// A BN's train-mode backward constants from its pack (mean, var, gamma, Sg,
// Sgx, 1/M): ga = gi * ((gy - sgm) - xh * sgxm), xh = (a - mean) * inv.
struct BnBwd {
  float mean, inv, gi, sgm, sgxm;
};
__device__ __forceinline__ BnBwd load_bn_bwd(const float* p, int c, float eps) {
  const float inv = inv_std(p[6 * c + 1], eps), im = p[6 * c + 5];
  return BnBwd{p[6 * c], inv, __fmul_rn(p[6 * c + 2], inv), __fmul_rn(p[6 * c + 3], im),
               __fmul_rn(p[6 * c + 4], im)};
}
__device__ __forceinline__ float bn_bwd(float gy, float a, const BnBwd& b) {
  const float xh = __fmul_rn(__fsub_rn(a, b.mean), b.inv);
  return __fmul_rn(b.gi, __fsub_rn(__fsub_rn(gy, b.sgm), __fmul_rn(xh, b.sgxm)));
}

// The passes' activation: 0 none, 1 relu6 (MobileNetV2), 2 relu (Xception),
// and its derivative as a 0 / 1 mask.
__device__ __forceinline__ float act(float u, int relu) {
  return relu == 1 ? fminf(fmaxf(u, 0.f), 6.f) : relu == 2 ? fmaxf(u, 0.f) : u;
}
__device__ __forceinline__ float act_grad(float u, int relu) {
  if (relu == 1) return (u > 0.f && u < 6.f) ? 1.f : 0.f;
  if (relu == 2) return u > 0.f ? 1.f : 0.f;
  return 1.f;
}
__host__ __device__ constexpr bool act_ok(int relu) { return relu >= 0 && relu <= 2; }

// mean = s / M and var = q / M - mean^2 of a batch of M = 1 / inv_m values
// from their sum s and sum of squares q, rounded as the plain versions'
// torch ops round them (a division by a scalar is a multiplication by its
// f32 reciprocal there)
__device__ __forceinline__ void moments_out(float s, float q, float inv_m, float* mean,
                                            float* var) {
  const float m = __fmul_rn(s, inv_m);
  *mean = m;
  *var = __fsub_rn(__fmul_rn(q, inv_m), __fmul_rn(m, m));
}

// The sum, in index order, of n (1 <= n <= kMax) values p[0], p[stride], ...
// that other CTAs wrote (read past L1): every load is issued before the
// first add, so the sum waits for one memory latency, not n.
template <int kMax>
__device__ __forceinline__ float ordered_sum_cg(const float* p, int n, size_t stride) {
  float v[kMax];
#pragma unroll
  for (int i = 0; i < kMax; ++i) v[i] = i < n ? __ldcg(p + i * stride) : 0.f;
  float s = v[0];
#pragma unroll
  for (int i = 1; i < kMax; ++i)
    if (i < n) s += v[i];
  return s;
}
// the same for four adjacent values (p 16-byte aligned, stride in float4s)
template <int kMax>
__device__ __forceinline__ float4 ordered_sum4_cg(const float4* p, int n, size_t stride) {
  float4 v[kMax];
#pragma unroll
  for (int i = 0; i < kMax; ++i) v[i] = i < n ? __ldcg(p + i * stride) : make_float4(0.f, 0.f, 0.f, 0.f);
  float4 s = v[0];
#pragma unroll
  for (int i = 1; i < kMax; ++i)
    if (i < n) s.x += v[i].x, s.y += v[i].y, s.z += v[i].z, s.w += v[i].w;
  return s;
}

// host: the current card's SM count, and how many CTAs of kernel kKern an
// SM holds at once at `threads` threads and `smem` bytes of dynamic shared
// memory (the kernel's limit raised to the H100's 227 KB on first use);
// each queried once and kept, so a launch's plan costs no CUDA call
inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms < 1) sms = 1;
  }
  return sms;
}
template <auto kKern> int ctas_per_sm(int threads, int smem) {
  static bool raised = false;
  static int keys[32], vals[32], n = 0;
  const int key = smem * 2048 + threads;
  for (int i = 0; i < n; ++i)
    if (keys[i] == key) return vals[i];
  if (!raised) {
    if (cudaFuncSetAttribute(kKern, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448) !=
        cudaSuccess)
      return 0;
    raised = true;
  }
  int occ = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kKern, threads, smem) != cudaSuccess)
    occ = 0;
  if (n < 32) keys[n] = key, vals[n++] = occ;
  return occ;
}

}  // namespace

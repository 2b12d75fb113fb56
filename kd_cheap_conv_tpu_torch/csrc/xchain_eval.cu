// The Xception eval chains' separable conv with every BN folded in: one
// launch per sep conv of an eval-mode Xception block (the config-#3
// teacher's middle and exit flow, Xception serving).
//
// Replaces the Pallas kernels of kd_cheap_conv_tpu/ops/pallas/xchain.py:
//   _k_block_eval (:99; fused_x_middle_eval :152)           3 launches a block
//   _k_seg_eval   (:746; _run_seg_eval :798, fused_x_tail_eval :840)
//                                                           3 launches a segment
// The TPU kernels keep a whole block (three sep convs) in VMEM with a
// 3-conv halo. At 728-2048 channels that halo does not fit an H100 CTA's
// 227 KB, so here each sep conv is a launch and a block's two intermediates
// go through device memory, in f32 as the TPU kernels keep them.
//
// What it computes (NHWC, P = N * H * W pixels, d the dilation):
//   t[p, c] = sum_tap k[tap, c] * act(x)[p + d * (tap - centre), c]
//             (zero outside each image; act = relu or none)
//   y[p, o] = b[o] + sum_c W[o, c] * round_T(t[p, c])
//             [+ x0[p, o]]                               (identity residual)
//             [+ bsk[o] + sum_c Wsk[o, c] * x0[p, c]]    (1x1 skip)
//   y       = relu(y) if final_relu, stored as Tout
// Rounding points, the JAX kernels': act(x) and the tap sums in f32, t
// rounded to the activation dtype T (the operand `_mm` rounds), W and Wsk
// in T, f32 sums; a block's first two convs store f32 (Tout = float), the
// third rounds once to T.
//
// What bounds it on an H100: the 1x1 products, 2 Co FLOPs per input
// element (728 x 728 in the middle flow, up to 1536 -> 2048 in the exit
// flow), above the ~295 FLOP/byte ridge. The kernel is sep_conv.cuh's tile
// loop, the one head_convs.cu's sep_fwd_kernel runs: t formed while staging
// each K chunk (nine dilated taps of act(x)), mma.sync products, the skip
// as a second K loop into the same accumulators, bias, residual and relu
// in the epilogue. No cross-CTA sums: every output has one owner, so the
// kernel is deterministic.
//
// The C entry point launches on the caller's stream and returns
// cudaGetLastError(); the Python wrapper raises if it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sep_conv.cuh"

namespace {

template <typename Tin, typename T, typename Tout>
__global__ void __launch_bounds__(sepconv::kThreads, 2)
xsep_eval_kernel(const sepconv::Args<Tin, T, Tout> a) {
  sepconv::sep_conv<Tin, T, Tout, false>(a);
}

template <typename Tin, typename T, typename Tout>
cudaError_t run(const void* x, const void* taps, const void* w, const void* b, const void* x0,
                const void* wsk, const void* bsk, void* y, int n, int h, int wd, int ci, int co,
                int c0, int dil, int pre_relu, int residual, int final_relu, cudaStream_t st) {
  sepconv::Args<Tin, T, Tout> a{};
  a.x0 = static_cast<const Tin*>(x);
  a.taps = static_cast<const float*>(taps);
  a.w = static_cast<const T*>(w);
  a.b = static_cast<const float*>(b);
  a.res = static_cast<const T*>(x0);
  a.wsk = static_cast<const T*>(wsk);
  a.bsk = static_cast<const float*>(bsk);
  a.y = static_cast<Tout*>(y);
  a.n = n, a.h = h, a.w_ = wd, a.c0 = ci, a.co = co, a.cs = c0, a.k = 3, a.dil = dil;
  a.pre_relu = pre_relu, a.residual = residual, a.final_relu = final_relu;
  const int tiles = (n * h * wd + sepconv::kTP - 1) / sepconv::kTP;   // one a CTA
  return sepconv::launch(xsep_eval_kernel<Tin, T, Tout>, a, tiles, st);
}

bool width_ok(int c) { return c >= 8 && c % 8 == 0; }

}  // namespace

extern "C" {

// One folded separable conv. Dtype codes 0 float32, 1 bfloat16: in_dt of x,
// dt of w, wsk, x0 (the operands), out_dt of y; in_dt and out_dt are dt or
// float32. x (P, ci), taps (9, ci) f32, w (co, ci), b (co) f32, y (P, co).
// residual 0: none; 1: x0 (P, co) added; 2: the 1x1 skip, x0 (P, c0), wsk
// (co, c0), bsk (co) f32.
int kdcc_xsep_eval(int in_dt, int dt, int out_dt, const void* x, const void* taps,
                   const void* w, const void* b, const void* x0, const void* wsk,
                   const void* bsk, void* y, int n, int h, int wd, int ci, int co, int c0,
                   int dil, int pre_relu, int residual, int final_relu, void* stream) {
  if (!width_ok(ci) || !width_ok(co) || n < 1 || h < 1 || wd < 1 || dil < 1 ||
      residual < 0 || residual > 2 || (residual >= 1 && x0 == nullptr) ||
      (residual == 2 && (!width_ok(c0) || wsk == nullptr || bsk == nullptr)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
#define KDCC_XSEP(TIN, T, TOUT)                                                              \
  return (int)run<TIN, T, TOUT>(x, taps, w, b, x0, wsk, bsk, y, n, h, wd, ci, co, c0, dil,  \
                                pre_relu, residual, final_relu, st)
  if (dt == 0 && in_dt == 0 && out_dt == 0) KDCC_XSEP(float, float, float);
  if (dt == 1 && in_dt == 1 && out_dt == 0) KDCC_XSEP(bf, bf, float);
  if (dt == 1 && in_dt == 0 && out_dt == 0) KDCC_XSEP(float, bf, float);
  if (dt == 1 && in_dt == 0 && out_dt == 1) KDCC_XSEP(float, bf, bf);
  if (dt == 1 && in_dt == 1 && out_dt == 1) KDCC_XSEP(bf, bf, bf);
#undef KDCC_XSEP
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

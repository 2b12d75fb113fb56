// Train-mode BN-barrier passes of the MobileNetV2 stem (features[1..2]) and
// IR chain (features[3..6]), and the depthwise passes of the Xception
// chains: three forward kernels and their backward.
//
// Replaces the Pallas kernels of kd_cheap_conv_tpu/ops/pallas/stem.py:
//   _k_bn_pw     (_run_bn_pw, stem.py:650)      -> bn_pw_fwd_kernel (narrow widths;
//                bf16: npf::bn_pw_fwd_kernel, redesigned for the H100: below)
//   _k_bn_dw     (_run_bn_dw, stem.py:618)      -> dwf::bn_dw_fwd_kernel<T, 1, D>
//   _k_bn_dw_s2  (_run_bn_dw_s2, stem.py:671)   -> dwf::bn_dw_fwd_kernel<T, 2, 1>
//                (redesigned for the H100: one wave, cp.async-staged halo
//                 tiles, moments summed in the kernel; see the kernel)
//   _k_pw_bwd    (_run_pw_bwd, stem.py:1049)    -> pw_bwd_kernel (narrow widths;
//                bf16: nbw::pw_bwd_kernel, redesigned for the H100: below)
//   _k_dw_bwd    (_run_dw_bwd, stem.py:1076)    -> dw_bwd_kernel<T, 1, D>
//   _k_dw_s2_bwd (_run_dw_s2_bwd, stem.py:1111) -> dw_bwd_kernel<T, 2, 1>
//                (redesigned for the H100's SM count and shared memory: see
//                 the kernel)
// The 1x1 passes wider than these kernels take run on wide_pw.cu.
//
// The functions are the JAX kernels', not their TPU layout: activations are
// NHWC (channels last, unpadded); no pad rows, lane padding, selection-matrix
// matmuls or pair views. A stride-2 tap is plain strided indexing.
//
// Forward pass: u = (a - mean) / sqrt(var + eps) * gamma + beta with the
// previous BN's batch moments (f32), h = act(u) (none, relu6 or relu), one
// conv (1x1 Ci->Co; 3x3 depthwise: stride 1 at dilation D = 1 or 2, pad D,
// or stride 2, pad 1; the zero padding applies to h), y written in the activation dtype, and the per-channel sum and sum
// of squares of y (f32, before rounding) for the next BN, unless the
// partial pointer is null (an eval pass: no moments). A missing BN pointer
// is the identity (the IR chain's expand pass reads a finished tensor). The 1x1 conv rounds h and w to the activation dtype and sums in
// f32, as the JAX kernel's matmul does; the depthwise conv is f32 throughout.
//
// Backward pass, given gy_next = dL/du_next (the relu6 mask is applied by the
// pass that produces a gradient): ga = gamma_n * inv_n * (gy - Sg/M -
// xh_n * Sgx/M), the train-mode BN backward of the next BN (or ga = gy
// where there is none); z = act(u_k) recomputed from a_k; the conv's input
// gradient times act'(u_k) gives gy_k (activation dtype); the per-channel
// sums of gy_k and gy_k * xh_k (f32) feed the previous link; the weight
// gradient is f32: dW (Co, Ci) for the 1x1 conv (from ga and z rounded to
// the activation dtype), dk (9, C) for the depthwise conv. ga is formed only
// at real output positions (zero elsewhere), so the -Sg/M constant of the BN
// backward never reaches the weight-gradient sums through padding or ragged
// tiles.
//
// Determinism: no float atomics. Every per-channel sum and weight gradient
// is accumulated by one fixed thread in a fixed order, reduced across the
// CTA in a fixed order and written as the CTA's partial; the wrapper sums
// the partials (a fixed-order reduction), or, in the bf16 1x1 forward and
// backward and the depthwise forward, the kernel does, in a fixed order
// behind integer tickets. The grid depends on the shape (and, for the depthwise backward,
// on the card) only, so two runs give bit-identical results.
//
// What bounds them on an H100: memory. A pass reads its inputs and writes
// its outputs once in bf16 (the 1x1 passes do at most 2 x 192 FLOPs per
// byte moved). The design keeps the work per byte low:
// - the 1x1 forward in bf16 (npf::bn_pw_fwd_kernel) is one launch on one
//   wave of persistent CTAs: a tile's x is one contiguous byte range,
//   copied 16 bytes at a time by cp.async into a ring of 2..4 stages while
//   the tile before is computed; BN and the activation run once per staged
//   element into bf16 h; the product runs on the tensor cores (mma.sync
//   m16n8k16, ldmatrix, W resident), since on the CUDA cores its f32 FMAs
//   (up to 27 FLOPs a byte at 32 <-> 192) sit above their 20 FLOP/byte
//   ridge; the moments are taken from the f32 fragments and summed in the
//   kernel, which writes mean and variance; y leaves through a staging tile
//   16 bytes a lane. The float32 variant (parity only) keeps a synchronous
//   tile loop on FMAs, 4 pixels x 2 channels a thread item;
// - the 1x1 backward in bf16 (nbw::pw_bwd_kernel) is one launch on one wave
//   of persistent CTAs: a tile's gy, a_next and a_k are contiguous byte
//   ranges, copied 16 bytes at a time by cp.async into a ring of 2..4
//   stages while the tile before is computed; the prologue forms ga and z
//   in bf16 in shared memory (exact to the rounding points, half the bytes
//   of f32), both products run on the tensor cores (mma.sync m16n8k16,
//   ldmatrix reading ga as stored for gz and transposed for dW), dW and
//   the sums stay in registers across tiles and the CTAs' partials are
//   summed in the kernel. The float32 variant (parity only) keeps the
//   synchronous tile loop on FMAs, 32 pixels a tile, dW in registers;
// - the depthwise forward runs on one wave of persistent CTAs, each a
//   channel slice of whole 16-byte copies walking 2-D output tiles; a
//   tile's input window is staged by cp.async while the tile before is
//   computed, BN and the activation are applied once per staged element
//   (f32, zero outside the image), a thread computes a strip of outputs x
//   4 channels from shared memory with the taps in registers, and the
//   moments are summed in the kernel, which writes mean and variance; see
//   dwf::bn_dw_fwd_kernel;
// - the depthwise backward runs on a grid sized to the card (a persistent
//   CTA per channel slice walks 8 x 8 input tiles, one partial each at the
//   end), stages gy, a_next and a_k by 16-byte cp.async copies while the
//   previous tile is computed, forms the next BN's backward ga once per
//   output element in shared memory, and gives a thread 4 channels (44
//   accumulators: 8 channels spilled at the two CTAs per SM the latency
//   needs, PERF.md); see dw_bwd_kernel.
// The C entry points launch on the caller's stream and return
// cudaGetLastError(); the Python wrapper raises if it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kThreads = 256;    // threads per CTA, every kernel
constexpr int kPwTile = 64;      // 1x1 forward: pixels per tile
constexpr int kPwBwdTile = 32;   // 1x1 backward: pixels per tile
constexpr int kRP = 4;           // 1x1: pixels per thread item (x 2 channels)
constexpr int kMaxC = 192;       // 1x1: widest Ci and Co (register budgets)
constexpr int kMaxCiCo = 6144;   // 1x1 backward: largest Ci x Co (dW in registers)
constexpr int kFwdItems = (kPwTile / kRP) * (kMaxC / 2) / kThreads;      // 6
constexpr int kBwdItems = (kPwBwdTile / kRP) * (kMaxC / 2) / kThreads;   // 3
constexpr int kDwItems = kMaxCiCo / 4 / kThreads;                         // 6

// ---------------------------------------------------------------------------
// 1x1 forward: tiles of kPwTile pixels; item = kRP pixels x 2 output
// channels
// ---------------------------------------------------------------------------

__host__ __device__ constexpr int pw_fwd_smem_floats(int ci, int co) {
  return ci * co + kPwTile * (ci + 1) + 4 * ci + 2 * (kPwTile / kRP) * co;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bn_pw_fwd_kernel(const T* __restrict__ x, const float* __restrict__ bn,
                 const T* __restrict__ w, T* __restrict__ y,
                 float* __restrict__ partial, int P, int ci, int co, int relu,
                 float eps) {
  extern __shared__ __align__(16) float sm[];
  const int cis = ci + 1, ncp = co / 2;
  const int items = (kPwTile / kRP) * ncp;
  float* wt = sm;                                       // [ci][co] W^T
  float* xs = wt + ci * co;                             // [kPwTile][cis] h
  Bn* bnp = reinterpret_cast<Bn*>(xs + kPwTile * cis);  // [ci]
  float* red = reinterpret_cast<float*>(bnp + ci);      // [2][items][2]
  const int tid = threadIdx.x;
  for (int i = tid; i < co * ci; i += kThreads) wt[(i % ci) * co + i / ci] = to_f<T>(w[i]);
  for (int c = tid; c < ci; c += kThreads) bnp[c] = load_bn(bn, c, eps);
  __syncthreads();

  const float2* wt2 = reinterpret_cast<const float2*>(wt);
  float s[kFwdItems][2], q[kFwdItems][2];
#pragma unroll
  for (int k = 0; k < kFwdItems; ++k) s[k][0] = s[k][1] = q[k][0] = q[k][1] = 0.f;
  const int ntiles = (P + kPwTile - 1) / kPwTile;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long p0 = (long long)tile * kPwTile;
    const int np = min(kPwTile, P - (int)p0);
    for (int i = tid; i < kPwTile * ci; i += kThreads) {
      const int r = i / ci, c = i - r * ci;
      float v = 0.f;
      if (r < np) {
        const Bn b = bnp[c];
        v = rounded<T>(act(bn_u(bn_xh(to_f<T>(x[(p0 + r) * ci + c]), b), b), relu));
      }
      xs[r * cis + c] = v;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFwdItems; ++k) {
      const int it = tid + k * kThreads;
      if (it < items) {
        const int cp = it % ncp, pg = it / ncp;
        const float* xr = xs + pg * kRP * cis;
        float acc[kRP][2];
#pragma unroll
        for (int r = 0; r < kRP; ++r) acc[r][0] = acc[r][1] = 0.f;
        for (int c = 0; c < ci; ++c) {
          const float2 wv = wt2[c * ncp + cp];
#pragma unroll
          for (int r = 0; r < kRP; ++r) {
            const float xv = xr[r * cis + c];
            acc[r][0] = fmaf(xv, wv.x, acc[r][0]);
            acc[r][1] = fmaf(xv, wv.y, acc[r][1]);
          }
        }
#pragma unroll
        for (int r = 0; r < kRP; ++r) {
          const int pr = pg * kRP + r;
          if (pr < np) {
            store2<T>(y + (p0 + pr) * co + 2 * cp, acc[r][0], acc[r][1]);
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              s[k][j] += acc[r][j];
              q[k][j] = fmaf(acc[r][j], acc[r][j], q[k][j]);
            }
          }
        }
      }
    }
    __syncthreads();
  }
  if (partial == nullptr) return;   // no moments wanted (an eval pass)
  // per channel: the items of its pixel groups, in group order
#pragma unroll
  for (int k = 0; k < kFwdItems; ++k) {
    const int it = tid + k * kThreads;
    if (it < items)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        red[it * 2 + j] = s[k][j];
        red[(items + it) * 2 + j] = q[k][j];
      }
  }
  __syncthreads();
  for (int e = tid; e < 2 * co; e += kThreads) {
    const int stat = e / co, o = e - stat * co, cp = o / 2, j = o % 2;
    float v = 0.f;
    for (int pg = 0; pg < kPwTile / kRP; ++pg) v += red[(stat * items + pg * ncp + cp) * 2 + j];
    partial[(size_t)blockIdx.x * 2 * co + e] = v;
  }
}

// ---------------------------------------------------------------------------
// 1x1 backward: tiles of kPwBwdTile pixels. gz item = kRP pixels x 2 input
// channels (its sums in registers); dW item = 2 x 2 entries (in registers
// across tiles)
// ---------------------------------------------------------------------------

__host__ __device__ constexpr int pw_bwd_smem_floats(int ci, int co) {
  return co * ci + kPwBwdTile * co + 2 * kPwBwdTile * ci + 5 * co + 4 * ci +
         2 * (kPwBwdTile / kRP) * ci;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
pw_bwd_kernel(const T* __restrict__ gy, const T* __restrict__ an,
              const float* __restrict__ pn, const T* __restrict__ ak,
              const float* __restrict__ bnk, const T* __restrict__ w,
              T* __restrict__ gyk, float* __restrict__ psum, float* __restrict__ pw,
              int P, int ci, int co, int relu, float eps) {
  extern __shared__ __align__(16) float sm[];
  const int nci = ci / 2, nco = co / 2;
  const int gz_items = (kPwBwdTile / kRP) * nci, dw_items = nco * nci;
  float* ws = sm;                            // [co][ci] W
  float* gas = ws + co * ci;                 // [tile][co] ga, rounded
  float* zs = gas + kPwBwdTile * co;         // [tile][ci] act(u_k), rounded
  float* xhs = zs + kPwBwdTile * ci;         // [tile][ci] xhat_k
  BnBwd* nb = reinterpret_cast<BnBwd*>(xhs + kPwBwdTile * ci);  // [co]
  Bn* kb = reinterpret_cast<Bn*>(nb + co);                       // [ci]
  float* red = reinterpret_cast<float*>(kb + ci);                // [2][gz_items][2]
  const int tid = threadIdx.x;
  const bool next = pn != nullptr;
  for (int i = tid; i < co * ci; i += kThreads) ws[i] = to_f<T>(w[i]);
  if (next)
    for (int c = tid; c < co; c += kThreads) nb[c] = load_bn_bwd(pn, c, eps);
  for (int c = tid; c < ci; c += kThreads) kb[c] = load_bn(bnk, c, eps);
  __syncthreads();

  const float2* ws2 = reinterpret_cast<const float2*>(ws);
  const float2* gas2 = reinterpret_cast<const float2*>(gas);
  const float2* zs2 = reinterpret_cast<const float2*>(zs);
  const float2* xhs2 = reinterpret_cast<const float2*>(xhs);
  float s[kBwdItems][2], q[kBwdItems][2];
#pragma unroll
  for (int k = 0; k < kBwdItems; ++k) s[k][0] = s[k][1] = q[k][0] = q[k][1] = 0.f;
  float dwa[kDwItems][4];                     // dW items of 2 x 2 entries
#pragma unroll
  for (int k = 0; k < kDwItems; ++k) dwa[k][0] = dwa[k][1] = dwa[k][2] = dwa[k][3] = 0.f;

  const int ntiles = (P + kPwBwdTile - 1) / kPwBwdTile;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long p0 = (long long)tile * kPwBwdTile;
    const int np = min(kPwBwdTile, P - (int)p0);
    for (int i = tid; i < kPwBwdTile * co; i += kThreads) {
      const int r = i / co, c = i - r * co;
      float v = 0.f;
      if (r < np) {
        const size_t at = (p0 + r) * co + c;
        v = to_f<T>(gy[at]);
        if (next) v = bn_bwd(v, to_f<T>(an[at]), nb[c]);
        v = rounded<T>(v);
      }
      gas[i] = v;
    }
    for (int i = tid; i < kPwBwdTile * ci; i += kThreads) {
      const int r = i / ci, c = i - r * ci;
      float xh = 0.f, z = 0.f;
      if (r < np) {
        const Bn b = kb[c];
        xh = bn_xh(to_f<T>(ak[(p0 + r) * ci + c]), b);
        z = rounded<T>(act(bn_u(xh, b), relu));
      }
      xhs[i] = xh;
      zs[i] = z;
    }
    __syncthreads();
    // gz = ga . W, gy_k = gz * act'(u_k), and its sums
#pragma unroll
    for (int k = 0; k < kBwdItems; ++k) {
      const int it = tid + k * kThreads;
      if (it < gz_items) {
        const int c2 = it % nci, pg = it / nci;
        const float* gr = gas + pg * kRP * co;
        float acc[kRP][2];
#pragma unroll
        for (int r = 0; r < kRP; ++r) acc[r][0] = acc[r][1] = 0.f;
        for (int o = 0; o < co; ++o) {
          const float2 wv = ws2[o * nci + c2];
#pragma unroll
          for (int r = 0; r < kRP; ++r) {
            const float gv = gr[r * co + o];
            acc[r][0] = fmaf(gv, wv.x, acc[r][0]);
            acc[r][1] = fmaf(gv, wv.y, acc[r][1]);
          }
        }
#pragma unroll
        for (int r = 0; r < kRP; ++r) {
          const int pr = pg * kRP + r;
          if (pr < np) {
            // u_k again from xhat_k: the same two rounded operations
            const float2 xh = xhs2[pr * nci + c2];
            const float g0 = acc[r][0] * act_grad(bn_u(xh.x, kb[2 * c2]), relu);
            const float g1 = acc[r][1] * act_grad(bn_u(xh.y, kb[2 * c2 + 1]), relu);
            store2<T>(gyk + (p0 + pr) * ci + 2 * c2, g0, g1);
            s[k][0] += g0;
            q[k][0] = fmaf(g0, xh.x, q[k][0]);
            s[k][1] += g1;
            q[k][1] = fmaf(g1, xh.y, q[k][1]);
          }
        }
      }
    }
    // dW[o][c] += sum over the tile of ga[p][o] * z[p][c]
#pragma unroll
    for (int k = 0; k < kDwItems; ++k) {
      const int it = tid + k * kThreads;
      if (it < dw_items) {
        const int o2 = it % nco, c2 = it / nco;
        float a00 = 0.f, a01 = 0.f, a10 = 0.f, a11 = 0.f;
        for (int r = 0; r < np; ++r) {
          const float2 g = gas2[r * nco + o2], z = zs2[r * nci + c2];
          a00 = fmaf(g.x, z.x, a00);
          a01 = fmaf(g.x, z.y, a01);
          a10 = fmaf(g.y, z.x, a10);
          a11 = fmaf(g.y, z.y, a11);
        }
        dwa[k][0] += a00;
        dwa[k][1] += a01;
        dwa[k][2] += a10;
        dwa[k][3] += a11;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < kDwItems; ++k) {
    const int it = tid + k * kThreads;
    if (it < dw_items) {
      const int o2 = it % nco, c2 = it / nco;
      float* out = pw + (size_t)blockIdx.x * co * ci + (2 * o2) * ci + 2 * c2;
      out[0] = dwa[k][0];
      out[1] = dwa[k][1];
      out[ci] = dwa[k][2];
      out[ci + 1] = dwa[k][3];
    }
  }
#pragma unroll
  for (int k = 0; k < kBwdItems; ++k) {
    const int it = tid + k * kThreads;
    if (it < gz_items)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        red[it * 2 + j] = s[k][j];
        red[(gz_items + it) * 2 + j] = q[k][j];
      }
  }
  __syncthreads();
  for (int e = tid; e < 2 * ci; e += kThreads) {
    const int stat = e / ci, c = e - stat * ci, c2 = c / 2, j = c % 2;
    float v = 0.f;
    for (int pg = 0; pg < kPwBwdTile / kRP; ++pg)
      v += red[(stat * gz_items + pg * nci + c2) * 2 + j];
    psum[(size_t)blockIdx.x * 2 * ci + e] = v;
  }
}

// ---------------------------------------------------------------------------
// 1x1 backward, bfloat16 (namespace nbw): gy_k, its sums and dW in one launch
// on one wave of persistent CTAs (a CTA per SM) that walk tiles of 128
// pixels (64 where three stages of 128 do not fit). Bound by its bytes (gy,
// a_next, a_k read once, gy_k written once); a tile's phases run in
// lockstep on 16 warps and wait on latency, so shared-memory loads go out
// in batches ahead of the stores and the ldmatrix fragments are
// double-buffered. A tile's pixels are contiguous in every operand (NHWC),
// so its gy, a_next and a_k arrive as three contiguous byte ranges, by
// 16-byte cp.async copies, in a ring of 2..4 stages: the next tiles load
// while this one is computed. Per tile:
//   prologue  ga = rounded(bn_bwd(gy, a_next)) (gy where there is no next
//             BN) and z = rounded(act(u_k)) in bf16, [pixel][channel], zero
//             at pixels past P (bn_bwd of a zero gy is not zero)
//   gz        = ga . W on the tensor cores (mma.sync m16n8k16, f32 sums);
//             gy_k = gz * act'(u_k), u_k and xhat_k recomputed from the
//             staged a_k; gy_k stored, its sums [gy_k, gy_k xhat_k] kept
//             per thread across tiles (one fixed owner each)
//   dW        += ga^T . z, the accumulators in registers across tiles
// The fragments come by ldmatrix: ga is read as stored for gz and
// transposed for dW, W and z transposed (no second copy of anything).
// At the end each CTA leaves its dW and sums as one partial; partials are
// summed in the kernel in a fixed order over two levels of integer tickets:
// the last CTA of each group of kGroup CTAs adds the group's partials in CTA
// order, the last group to finish adds the groups' sums in group order.
// ---------------------------------------------------------------------------

namespace nbw {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 512;            // 16 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTP = 64;                  // pixels per tile, or twice that where 3 stages fit
constexpr int kCtas = 132;               // one wave on an H100, fixed so that the plan and
                                         // the partials' order depend on the shape alone
constexpr int kGroup = 12;               // CTAs per first-level group of the partials' sum
constexpr int kMaxGroups = (kCtas + kGroup - 1) / kGroup;
constexpr int kMaxStages = 4;
constexpr int kSmemMax = 232448;
constexpr int kU = 4;                    // prologue rows a thread loads at once
// gz sub-tiles (16 pixels x 8 channels): a warp keeps the 16-pixel blocks
// warp % 4 (+ 4) and every 4th 8-channel block from warp / 4, kS1 at most;
// dW sub-tiles (16 output x 8 input channels), dealt round-robin
constexpr int kS1 = (kMaxC / 8 + 3) / 4;   // 6
constexpr int kS2 = 5;                     // the most over the widths pw_narrow takes

__host__ __device__ constexpr int r8(int c) { return (c + 7) / 8 * 8; }
__host__ __device__ constexpr int r16(int c) { return (c + 15) / 16 * 16; }

// a shape's layout and plan (host and device)
struct Plan {
  int tp;           // pixels per tile: 2 kTP where that leaves 3 stages, else kTP
  int lg, lz, lw;   // row strides (elements) of ga [tp][lg], z [tp][lz], W [r16(co)][lw]
  int raw;          // bytes of a stage: gy, a_next (with a next BN), a_k
  int stages, smem, grid, groups, v;   // v: floats of a partial (dW, then the sums)
};
__host__ __device__ inline Plan plan(int P, int ci, int co, bool next) {
  Plan p;
  p.lg = r16(co) + 8;
  p.lz = r16(ci) + 8;   // strides of an odd number of 16-byte units: the 8 rows of
  p.lw = r16(ci) + 8;   // an ldmatrix phase fall in 8 distinct bank groups
  for (p.tp = 2 * kTP;; p.tp = kTP) {
    p.raw = p.tp * (co * (next ? 2 : 1) + ci) * 2;
    const int fixed = 2 * (p.tp * p.lg + p.tp * p.lz + r16(co) * p.lw) +
                      ci * (int)sizeof(Bn) + (next ? co * (int)sizeof(BnBwd) : 0) + 16;
    const int st = (kSmemMax - fixed) / p.raw;
    p.stages = st < kMaxStages ? st : kMaxStages;
    p.smem = fixed + p.stages * p.raw;
    if (p.tp == kTP || p.stages >= 3) break;
  }
  // the grid counts kTP-pixel tiles whatever the tile, so it (and the
  // partials' order) does not move with the layout; a CTA may get no tile
  const int ntiles = (P + kTP - 1) / kTP;
  p.grid = ntiles < kCtas ? ntiles : kCtas;
  p.groups = (p.grid + kGroup - 1) / kGroup;
  p.v = co * ci + 2 * ci;   // a multiple of 4: ci and co + 2 are even
  return p;
}

struct Args {
  const bf16 *gy, *an, *ak, *w;   // an: null when pn is
  const float *pn, *bnk;          // pn (co, 6), null: the identity; bnk (ci, 4), null: the identity
  bf16* gyk;                      // (P, ci)
  float* dw;                      // (co, ci)
  float* sums;                    // (ci, 2): [sum gy_k, sum gy_k xhat_k]
  float* scratch;                 // (grid + groups, v): the CTAs' and the groups' partials
  int* tickets;                   // (groups + 1,): zero between launches
  int P, ci, co, relu;
  float eps;
};

// waits until at most n (1..3) of this thread's copy groups are in flight
__device__ __forceinline__ void cp_async_wait_n(int n) {
  if (n >= 3) hop::cp_async_wait<3>();
  else if (n == 2) hop::cp_async_wait<2>();
  else hop::cp_async_wait<1>();
}

// bytes (a multiple of 4) from src to dst, 16 at a time, the last copy short
__device__ __forceinline__ void copy_range(unsigned char* dst, const unsigned char* src,
                                           int bytes) {
  for (int i = 16 * threadIdx.x; i < bytes; i += 16 * kThreads)
    hop::cp_async16_zfill(dst + i, src + i, bytes - i < 16 ? bytes - i : 16);
}

template <int TP>
__global__ void __launch_bounds__(kThreads, 1) pw_bwd_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const bool next = a.pn != nullptr;
  const int ci = a.ci, co = a.co;
  const Plan pl = plan(a.P, ci, co, next);
  const int S = pl.stages;
  unsigned char* raw = smem;                                   // [S][raw]
  bf16* ga = reinterpret_cast<bf16*>(smem + S * pl.raw);      // [TP][lg]
  bf16* zs = ga + TP * pl.lg;                                  // [TP][lz]
  bf16* ws = zs + TP * pl.lz;                                  // [r16(co)][lw]
  Bn* kb = reinterpret_cast<Bn*>(ws + r16(co) * pl.lw);        // [ci]
  BnBwd* nb = reinterpret_cast<BnBwd*>(kb + ci);               // [co]
  int* flag = reinterpret_cast<int*>(nb + (next ? co : 0));
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gyb = TP * co * 2, akoff = gyb * (next ? 2 : 1);   // stage offsets (bytes)

  // ga, z and W zero (the padding of the products stays zero), then W and
  // the BN tables
  for (int i = tid; i < (TP * pl.lg + TP * pl.lz + r16(co) * pl.lw) / 2; i += kThreads)
    reinterpret_cast<uint32_t*>(ga)[i] = 0u;
  __syncthreads();
  for (int i = tid; i < co * ci / 2; i += kThreads) {
    const int o = (2 * i) / ci, c = 2 * i - o * ci;
    *reinterpret_cast<uint32_t*>(ws + o * pl.lw + c) =
        *reinterpret_cast<const uint32_t*>(a.w + 2 * i);
  }
  for (int c = tid; c < ci; c += kThreads) kb[c] = load_bn(a.bnk, c, a.eps);
  if (next)
    for (int o = tid; o < co; o += kThreads) nb[o] = load_bn_bwd(a.pn, o, a.eps);

  const int ntiles = (a.P + TP - 1) / TP;
  auto stage = [&](int tile, unsigned char* dst) {
    const int p0 = tile * TP, np = min(TP, a.P - p0);
    copy_range(dst, reinterpret_cast<const unsigned char*>(a.gy + (size_t)p0 * co), np * co * 2);
    if (next)
      copy_range(dst + gyb, reinterpret_cast<const unsigned char*>(a.an + (size_t)p0 * co),
                 np * co * 2);
    copy_range(dst + akoff, reinterpret_cast<const unsigned char*>(a.ak + (size_t)p0 * ci),
               np * ci * 2);
  };
  for (int j = 0; j < S - 1; ++j) {
    const int tile = blockIdx.x + j * gridDim.x;
    if (tile < ntiles) stage(tile, raw + j * pl.raw);
    hop::cp_async_commit();
  }
  __syncthreads();

  // the prologue's fixed channel pairs: ga's pair gc of every gr-th pixel
  // from gr0, z's pair zc of every zr-th from zr0; their constants in registers
  const int gpairs = co / 2, grs = kThreads / gpairs, gc = 2 * (tid % gpairs), gr0 = tid / gpairs;
  const int zpairs = ci / 2, zrs = kThreads / zpairs, zc = 2 * (tid % zpairs), zr0 = tid / zpairs;
  const BnBwd nb0 = next ? nb[gc] : BnBwd{0.f, 0.f, 0.f, 0.f, 0.f};
  const BnBwd nb1 = next ? nb[gc + 1] : BnBwd{0.f, 0.f, 0.f, 0.f, 0.f};
  const Bn zb0 = kb[zc], zb1 = kb[zc + 1];

  const int NT = r8(ci) / 8, KT = r16(co) / 16;
  const int wm = warp & 3, wn = warp >> 2, g = lane >> 2, t = lane & 3;
  float sum[kS1][4];   // per gz slot: sum gy_k, sum gy_k xhat_k of columns c, c + 1
  float dw[kS2][4];
#pragma unroll
  for (int i = 0; i < kS1; ++i) sum[i][0] = sum[i][1] = sum[i][2] = sum[i][3] = 0.f;
#pragma unroll
  for (int i = 0; i < kS2; ++i) dw[i][0] = dw[i][1] = dw[i][2] = dw[i][3] = 0.f;

  int it = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++it) {
    const int pre = tile + (S - 1) * gridDim.x;
    if (pre < ntiles) stage(pre, raw + ((it + S - 1) % S) * pl.raw);
    hop::cp_async_commit();
    cp_async_wait_n(S - 1);
    __syncthreads();
    const unsigned char* cur = raw + (it % S) * pl.raw;
    const bf16* rgy = reinterpret_cast<const bf16*>(cur);
    const bf16* ran = reinterpret_cast<const bf16*>(cur + gyb);
    const bf16* rak = reinterpret_cast<const bf16*>(cur + akoff);
    const int p0 = tile * TP, np = min(TP, a.P - p0);

    // prologue, kU rows a thread at a time: their loads all go out before
    // the first store (a store to shared memory may alias a later load as
    // far as the compiler can tell, so it would not hoist them itself)
    if (gr0 < grs)
      for (int pb = gr0; pb < TP; pb += kU * grs) {
        uint32_t gv[kU], av[kU];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int p = min(pb + u * grs, TP - 1);
          gv[u] = *reinterpret_cast<const uint32_t*>(rgy + p * co + gc);
          av[u] = next ? *reinterpret_cast<const uint32_t*>(ran + p * co + gc) : 0u;
        }
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int p = pb + u * grs;
          if (p >= TP) break;
          float2 v = make_float2(0.f, 0.f);
          if (p < np) {
            v = load2<bf16>(reinterpret_cast<const bf16*>(&gv[u]));
            if (next) {
              const float2 x = load2<bf16>(reinterpret_cast<const bf16*>(&av[u]));
              v = make_float2(bn_bwd(v.x, x.x, nb0), bn_bwd(v.y, x.y, nb1));
            }
          }
          store2<bf16>(ga + p * pl.lg + gc, v.x, v.y);
        }
      }
    if (zr0 < zrs)
      for (int pb = zr0; pb < TP; pb += kU * zrs) {
        uint32_t kv[kU];
#pragma unroll
        for (int u = 0; u < kU; ++u)
          kv[u] = *reinterpret_cast<const uint32_t*>(rak + min(pb + u * zrs, TP - 1) * ci + zc);
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int p = pb + u * zrs;
          if (p >= TP) break;
          float2 v = make_float2(0.f, 0.f);
          if (p < np) {
            const float2 x = load2<bf16>(reinterpret_cast<const bf16*>(&kv[u]));
            v = make_float2(act(bn_u(bn_xh(x.x, zb0), zb0), a.relu),
                            act(bn_u(bn_xh(x.y, zb1), zb1), a.relu));
          }
          store2<bf16>(zs + p * pl.lz + zc, v.x, v.y);
        }
      }
    __syncthreads();

    // gz = ga . W (16 x 8 sub-tiles (m, n)), then gy_k and its sums. The
    // fragments of step kt + 1 are loaded before step kt's products (the
    // ldmatrix and mma statements keep their order)
#pragma unroll
    for (int i = 0; i < kS1; ++i) {
      const int n = wn + 4 * i;
      if (n >= NT) break;
      float acc[TP / 64][4];
#pragma unroll
      for (int mi = 0; mi < TP / 64; ++mi) acc[mi][0] = acc[mi][1] = acc[mi][2] = acc[mi][3] = 0.f;
      uint32_t fa[TP / 64][4], fb[2];
      auto frags = [&](int kt, uint32_t (&a4)[TP / 64][4], uint32_t (&b2)[2]) {
        ldsm_x2_trans(b2, ws + (16 * kt + (lane & 7) + (lane & 8)) * pl.lw + 8 * n);
#pragma unroll
        for (int mi = 0; mi < TP / 64; ++mi)
          ldsm_x4(a4[mi], ga + (16 * (wm + 4 * mi) + (lane & 7) + (lane & 8)) * pl.lg + 16 * kt +
                              (lane >> 4) * 8);
      };
      frags(0, fa, fb);
      for (int kt = 0; kt < KT; ++kt) {
        uint32_t na[TP / 64][4], nb[2];
        frags(kt + 1 < KT ? kt + 1 : kt, na, nb);   // the last step reloads its own
#pragma unroll
        for (int mi = 0; mi < TP / 64; ++mi) mma_bf16(acc[mi], fa[mi], fb);
#pragma unroll
        for (int mi = 0; mi < TP / 64; ++mi)
#pragma unroll
          for (int j = 0; j < 4; ++j) fa[mi][j] = na[mi][j];
        fb[0] = nb[0], fb[1] = nb[1];
      }
      const int c = 8 * n + 2 * t;
      if (c >= ci) continue;
      const Bn b0 = kb[c], b1 = kb[c + 1];
      uint32_t xv[2 * (TP / 64)];   // a_k's pairs, all loaded before the first store
#pragma unroll
      for (int hh = 0; hh < 2 * (TP / 64); ++hh)
        xv[hh] = *reinterpret_cast<const uint32_t*>(
            rak + (16 * (wm + 4 * (hh >> 1)) + g + 8 * (hh & 1)) * ci + c);
#pragma unroll
      for (int hh = 0; hh < 2 * (TP / 64); ++hh) {
        const int h = hh & 1, mi = hh >> 1;
        const int p = 16 * (wm + 4 * mi) + g + 8 * h;
        if (p >= np) continue;
        const float2 x = load2<bf16>(reinterpret_cast<const bf16*>(&xv[hh]));
        const float xh0 = bn_xh(x.x, b0), xh1 = bn_xh(x.y, b1);
        const float g0 = acc[mi][2 * h] * act_grad(bn_u(xh0, b0), a.relu);
        const float g1 = acc[mi][2 * h + 1] * act_grad(bn_u(xh1, b1), a.relu);
        store2<bf16>(a.gyk + (size_t)(p0 + p) * ci + c, g0, g1);
        sum[i][0] += g0;
        sum[i][1] += g1;
        sum[i][2] = fmaf(g0, xh0, sum[i][2]);
        sum[i][3] = fmaf(g1, xh1, sum[i][3]);
      }
    }

    // dW += ga^T . z (16 x 8 sub-tiles (mo, nc) dealt round-robin over the
    // warps), K = the tile's pixels; step kt + 1's fragments loaded first
#pragma unroll
    for (int i = 0; i < kS2; ++i) {
      const int sub = warp + kWarps * i;
      if (sub >= KT * NT) break;
      const int mo = sub / NT, nc = sub - mo * NT;
      auto frags = [&](int kt, uint32_t (&a4)[4], uint32_t (&b2)[2]) {
        ldsm_x4_trans(a4, ga + (16 * kt + (lane & 7) + (lane >> 4) * 8) * pl.lg + 16 * mo +
                              (lane & 8));
        ldsm_x2_trans(b2, zs + (16 * kt + (lane & 7) + (lane & 8)) * pl.lz + 8 * nc);
      };
      uint32_t fa[4], fb[2];
      frags(0, fa, fb);
#pragma unroll
      for (int kt = 0; kt < TP / 16; ++kt) {
        uint32_t na[4], nb[2];
        frags(kt + 1 < TP / 16 ? kt + 1 : kt, na, nb);
        mma_bf16(dw[i], fa, fb);
        fa[0] = na[0], fa[1] = na[1], fa[2] = na[2], fa[3] = na[3];
        fb[0] = nb[0], fb[1] = nb[1];
      }
    }
    __syncthreads();
  }
  hop::cp_async_wait<0>();
  __syncthreads();

  // this CTA's partial: dW from the fragments; each sum over its 32
  // contributors (the 4 warps of a column's 8-channel block, 8 lanes each)
  // in a fixed order, through shared memory
  float* mine = a.scratch + (size_t)blockIdx.x * pl.v;
#pragma unroll
  for (int i = 0; i < kS2; ++i) {
    const int sub = warp + kWarps * i;
    if (sub >= KT * NT) break;
    const int mo = sub / NT, nc = sub - mo * NT, c = 8 * nc + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = 16 * mo + g + 8 * h;
      if (o < co && c < ci)
        __stcg(reinterpret_cast<float2*>(mine + o * ci + c), make_float2(dw[i][2 * h], dw[i][2 * h + 1]));
    }
  }
  float* red = reinterpret_cast<float*>(smem);   // [32][ci][2]
#pragma unroll
  for (int i = 0; i < kS1; ++i) {
    const int n = wn + 4 * i, c = 8 * n + 2 * t;
    if (n >= NT) break;
    if (c >= ci) continue;
    float* r = red + ((wm * 8 + g) * ci + c) * 2;
    r[0] = sum[i][0], r[1] = sum[i][2], r[2] = sum[i][1], r[3] = sum[i][3];
  }
  __syncthreads();
  for (int c = tid; c < ci; c += kThreads) {
    float ts = 0.f, tq = 0.f;
#pragma unroll 8
    for (int k = 0; k < 32; ++k) {
      ts += red[(k * ci + c) * 2];
      tq += red[(k * ci + c) * 2 + 1];
    }
    __stcg(mine + co * ci + 2 * c, ts);
    __stcg(mine + co * ci + 2 * c + 1, tq);
  }

  // the partials' sum, in a fixed order: the last CTA of this group adds
  // its CTAs' partials; with more than one group the last group's adder
  // adds the groups' sums. Who adds depends on timing, the order does not.
  const int grp = blockIdx.x / kGroup, b0 = grp * kGroup;
  const int b1 = min((int)gridDim.x, b0 + kGroup), ngroups = pl.groups;
  __threadfence();
  __syncthreads();
  if (tid == 0) *flag = atomicAdd(&a.tickets[grp], 1) == b1 - b0 - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  // a partial is dW (co ci floats, a multiple of 4) then the sums
  const float4* part = reinterpret_cast<const float4*>(a.scratch);
  const int v4 = pl.v / 4, dw4 = co * ci / 4;
  auto out = [&](int v, float4 val) {
    if (v < dw4) reinterpret_cast<float4*>(a.dw)[v] = val;
    else reinterpret_cast<float4*>(a.sums)[v - dw4] = val;
  };
  float4* gsum = reinterpret_cast<float4*>(a.scratch + (size_t)(gridDim.x + grp) * pl.v);
  for (int v = tid; v < v4; v += kThreads) {
    const float4 t = ordered_sum4_cg<kGroup>(part + (size_t)b0 * v4 + v, b1 - b0, v4);
    if (ngroups == 1) out(v, t);
    else __stcg(gsum + v, t);
  }
  if (tid == 0) a.tickets[grp] = 0;
  if (ngroups == 1) return;
  __threadfence();
  __syncthreads();
  if (tid == 0) *flag = atomicAdd(&a.tickets[ngroups], 1) == ngroups - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  for (int v = tid; v < v4; v += kThreads)
    out(v, ordered_sum4_cg<kMaxGroups>(part + (size_t)gridDim.x * v4 + v, ngroups, v4));
  if (tid == 0) a.tickets[ngroups] = 0;
}

template <int TP> cudaError_t launch(const Args& a, const Plan& p, cudaStream_t st) {
  if (ctas_per_sm<pw_bwd_kernel<TP>>(kThreads, p.smem) < 1) return cudaErrorInvalidValue;
  pw_bwd_kernel<TP><<<p.grid, kThreads, p.smem, st>>>(a);
  return cudaGetLastError();
}

cudaError_t run(const Args& a, cudaStream_t st) {
  const Plan p = plan(a.P, a.ci, a.co, a.pn != nullptr);
  if (p.stages < 2) return cudaErrorInvalidValue;
  return p.tp == kTP ? launch<kTP>(a, p, st) : launch<2 * kTP>(a, p, st);
}

}  // namespace nbw

// ---------------------------------------------------------------------------
// 1x1 forward, bfloat16 (namespace npf): y and the next BN's moments in one
// launch on one wave of persistent CTAs (a CTA per SM) that walk tiles of
// kTP pixels. Bound by its bytes (x read, y written once); the product is a
// few FLOPs a byte, which the tensor cores do in the shadow of the copies.
// A tile's x is one contiguous byte range (NHWC), copied 16 bytes at a time
// by cp.async into a ring of 2..4 stages while the tile before is computed.
// Per tile:
//   prologue  h = rounded(act(BN(x))) in bf16, [pixel][channel], once per
//             staged element; a thread keeps its 8 channels' BN constants in
//             registers; K padded to 16 with zeros that stay zero
//   product   y = h . W^T on the tensor cores (mma.sync m16n8k16, ldmatrix:
//             h and W read as stored; W resident for the launch), f32 sums
//   epilogue  the moments of the f32 y at real pixels: summed over a
//             fragment's rows, then across the warp by a fixed butterfly,
//             then over the tile's 16-row blocks in block order by one
//             owner thread per (statistic, channel), in registers across
//             tiles; y rounded to bf16 into a staging tile whose rows are an
//             odd number of 16-byte units apart (no bank conflicts), then
//             stored 16 bytes a lane as the tile's contiguous byte range
// At the end each CTA leaves its (2, co) sums as a partial; the partials
// are summed in the kernel in a fixed order over two levels of integer
// tickets (groups of kGroup CTAs, then the groups), and the last adder
// writes mean and biased variance (common.cuh moments_out). Widths
// divisible by 8 up to kMaxC, Ci x Co up to kMaxCiCo; the plan (ops/stem.py
// bn_pw_fwd_plan mirrors it) depends on the shape alone.
// ---------------------------------------------------------------------------

namespace npf {

using bf16 = __nv_bfloat16;
using nbw::r16;
constexpr int kThreads = nbw::kThreads;   // 16 warps (nbw::copy_range's thread count)
constexpr int kTP = 128;                  // pixels per tile
constexpr int kMB = kTP / 16;             // 16-row blocks of a tile
constexpr int kCtas = 132;                // one wave on an H100, fixed so that the plan and
                                          // the partials' order depend on the shape alone
constexpr int kGroup = 12;
constexpr int kMaxGroups = (kCtas + kGroup - 1) / kGroup;
constexpr int kMaxStages = 4;
constexpr int kSmemMax = 232448;
constexpr int kNG = 4;                    // 8-channel blocks a warp's product step holds
constexpr int kU = 4;                     // prologue rows a thread loads at once

struct Plan {
  int lh;            // row stride (elements) of h [kTP][lh] and W [r16(co)][lh]
  int ly;            // row stride (16-byte units) of the y staging tile: co / 8, made odd
  int raw;           // bytes of a stage (x of kTP pixels)
  int stages, smem, grid, groups;
};
__host__ __device__ inline Plan plan(int P, int ci, int co) {
  Plan p;
  p.lh = r16(ci) + 8;   // an odd number of 16-byte units: ldmatrix without bank conflicts
  p.ly = (co / 8) | 1;
  p.raw = kTP * ci * 2;
  const int fixed = 2 * (kTP + r16(co)) * p.lh + kTP * p.ly * 16 + kMB * 2 * co * 4 + 16;
  const int st = (kSmemMax - fixed) / p.raw;
  p.stages = st < kMaxStages ? st : kMaxStages;
  p.smem = fixed + p.stages * p.raw;
  const int ntiles = (P + kTP - 1) / kTP;
  p.grid = ntiles < kCtas ? ntiles : kCtas;
  p.groups = (p.grid + kGroup - 1) / kGroup;
  return p;
}

struct Args {
  const bf16 *x, *w;      // x (P, ci), w (co, ci)
  const float* bn;        // (ci, 4), null: the identity
  bf16* y;                // (P, co)
  float* scratch;         // (grid + groups, 2, co): the CTAs' and the groups' sums; null: none
  float* moments;         // (2, co): mean and biased variance of y
  int* tickets;           // (groups + 1,): zero between launches
  int P, ci, co, relu;
  float eps, inv_m;       // inv_m = 1 / P in f32
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__global__ void __launch_bounds__(kThreads, 1) bn_pw_fwd_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ci = a.ci, co = a.co;
  const Plan pl = plan(a.P, ci, co);
  const int S = pl.stages;
  const bool mom = a.scratch != nullptr;
  unsigned char* raw = smem;                                    // [S][raw]
  bf16* hs = reinterpret_cast<bf16*>(smem + S * pl.raw);       // [kTP][lh]
  bf16* ws = hs + kTP * pl.lh;                                  // [r16(co)][lh]
  uint4* ys = reinterpret_cast<uint4*>(ws + r16(co) * pl.lh);  // [kTP][ly]
  float* red = reinterpret_cast<float*>(ys + kTP * pl.ly);     // [kMB][2][co]
  int* flag = reinterpret_cast<int*>(red + kMB * 2 * co);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // h and W zero (the padding of the product stays zero), then W
  for (int i = tid; i < (kTP + r16(co)) * pl.lh / 8; i += kThreads)
    reinterpret_cast<uint4*>(hs)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  for (int i = tid; i < co * ci / 8; i += kThreads) {
    const int o = (8 * i) / ci, c = 8 * i - o * ci;
    *reinterpret_cast<uint4*>(ws + o * pl.lh + c) = *reinterpret_cast<const uint4*>(a.w + 8 * i);
  }

  const int ntiles = (a.P + kTP - 1) / kTP;
  auto stage = [&](int tile, unsigned char* dst) {
    const int p0 = tile * kTP, np = min(kTP, a.P - p0);
    nbw::copy_range(dst, reinterpret_cast<const unsigned char*>(a.x + (size_t)p0 * ci), np * ci * 2);
  };
  for (int j = 0; j < S - 1; ++j) {
    const int tile = blockIdx.x + j * gridDim.x;
    if (tile < ntiles) stage(tile, raw + j * pl.raw);
    hop::cp_async_commit();
  }

  // the prologue's fixed 8 channels q8 of every rs-th pixel from r0; their
  // BN constants in registers
  const int q8s = ci / 8, rs = kThreads / q8s, q8 = 8 * (tid % q8s), r0 = tid / q8s;
  Bn bq[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) bq[e] = load_bn(r0 < rs ? a.bn : nullptr, q8 + e, a.eps);

  // the product's warp: 16-row block wm, 8-channel blocks [lo, hi)
  const int NT = co / 8, KT = r16(ci) / 16, nh = (NT + 1) / 2;
  const int wm = warp % kMB, lo = (warp / kMB) * nh, hi = min(NT, lo + nh);
  const int g = lane >> 2, t = lane & 3, pa = 16 * wm + g, pb = pa + 8;
  uint32_t* yw = reinterpret_cast<uint32_t*>(ys);
  float run = 0.f;   // statistic tid (sum y, then sum y^2, of channel tid % co) over the tiles

  int it = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++it) {
    const int pre = tile + (S - 1) * gridDim.x;
    if (pre < ntiles) stage(pre, raw + ((it + S - 1) % S) * pl.raw);
    hop::cp_async_commit();
    nbw::cp_async_wait_n(S - 1);
    __syncthreads();   // this tile's x has landed; the last tile's y and sums are out
    const bf16* rx = reinterpret_cast<const bf16*>(raw + (it % S) * pl.raw);
    const int p0 = tile * kTP, np = min(kTP, a.P - p0);

    // prologue, kU rows a thread at a time: their loads all go out before the
    // first store
    if (r0 < rs)
      for (int pb0 = r0; pb0 < kTP; pb0 += kU * rs) {
        uint4 xv[kU];
#pragma unroll
        for (int u = 0; u < kU; ++u)
          xv[u] = *reinterpret_cast<const uint4*>(rx + min(pb0 + u * rs, kTP - 1) * ci + q8);
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int p = pb0 + u * rs;
          if (p >= kTP) break;
          float v[8];
          load8<bf16>(reinterpret_cast<const bf16*>(&xv[u]), v);
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = p < np ? act(bn_u(bn_xh(v[e], bq[e]), bq[e]), a.relu) : 0.f;
          store8<bf16>(hs + p * pl.lh + q8, v);
        }
      }
    __syncthreads();

    // y = h . W^T, kNG 8-channel blocks at a time; then the moments and the
    // staging of y
    for (int n0 = lo; n0 < hi; n0 += kNG) {
      float acc[kNG][4];
#pragma unroll
      for (int j = 0; j < kNG; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      for (int kt = 0; kt < KT; ++kt) {
        uint32_t fa[4];
        ldsm_x4(fa, hs + (16 * wm + (lane & 15)) * pl.lh + 16 * kt + (lane >> 4) * 8);
#pragma unroll
        for (int jj = 0; jj < kNG / 2; ++jj) {
          const int nb = n0 + 2 * jj;
          if (nb >= hi) break;
          uint32_t fb[4];   // blocks nb, nb + 1: k 0..7, 8..15 each
          ldsm_x4(fb, ws + (8 * (nb + (lane >> 4)) + (lane & 7)) * pl.lh + 16 * kt +
                               ((lane >> 3) & 1) * 8);
          const uint32_t b0[2] = {fb[0], fb[1]}, b1[2] = {fb[2], fb[3]};
          mma_bf16(acc[2 * jj], fa, b0);
          if (nb + 1 < hi) mma_bf16(acc[2 * jj + 1], fa, b1);
        }
      }
#pragma unroll
      for (int j = 0; j < kNG; ++j) {
        const int n = n0 + j;
        if (n >= hi) break;
        const int c = 8 * n + 2 * t;
        yw[pa * 4 * pl.ly + c / 2] = pack_bf16(acc[j][0], acc[j][1]);
        yw[pb * 4 * pl.ly + c / 2] = pack_bf16(acc[j][2], acc[j][3]);
        if (!mom) continue;
        const float ua = pa < np ? 1.f : 0.f, ub = pb < np ? 1.f : 0.f;
        float s0 = __fadd_rn(__fmul_rn(ua, acc[j][0]), __fmul_rn(ub, acc[j][2]));
        float s1 = __fadd_rn(__fmul_rn(ua, acc[j][1]), __fmul_rn(ub, acc[j][3]));
        float q0 = __fadd_rn(__fmul_rn(ua, __fmul_rn(acc[j][0], acc[j][0])),
                             __fmul_rn(ub, __fmul_rn(acc[j][2], acc[j][2])));
        float q1 = __fadd_rn(__fmul_rn(ua, __fmul_rn(acc[j][1], acc[j][1])),
                             __fmul_rn(ub, __fmul_rn(acc[j][3], acc[j][3])));
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          s0 += __shfl_xor_sync(0xffffffffu, s0, off);
          s1 += __shfl_xor_sync(0xffffffffu, s1, off);
          q0 += __shfl_xor_sync(0xffffffffu, q0, off);
          q1 += __shfl_xor_sync(0xffffffffu, q1, off);
        }
        if (g == 0) {
          float* r = red + wm * 2 * co + c;
          r[0] = s0, r[1] = s1, r[co] = q0, r[co + 1] = q1;
        }
      }
    }
    __syncthreads();

    // y out, 16 bytes a lane; the tile's sums into their owners
    const int units = co / 8;
    for (int u = tid; u < np * units; u += kThreads) {
      const int r = u / units, k = u - r * units;
      *reinterpret_cast<uint4*>(a.y + (size_t)(p0 + r) * co + 8 * k) = ys[r * pl.ly + k];
    }
    if (mom && tid < 2 * co) {
      float v = red[tid];
#pragma unroll
      for (int m = 1; m < kMB; ++m) v += red[m * 2 * co + tid];
      run += v;
    }
  }
  hop::cp_async_wait<0>();
  if (!mom) return;   // an eval pass: no moments

  // the partials' sum, in a fixed order: the last CTA of each group adds its
  // CTAs' partials in CTA order; with more than one group the last group's
  // adder adds the groups' sums in group order, and the last adder writes
  // mean and variance. Who adds depends on timing, the order does not.
  const size_t row = 2 * (size_t)co;
  if (tid < 2 * co) __stcg(a.scratch + blockIdx.x * row + tid, run);
  const int grp = blockIdx.x / kGroup, b0 = grp * kGroup;
  const int b1 = min((int)gridDim.x, b0 + kGroup), groups = pl.groups;
  __threadfence();
  __syncthreads();
  if (tid == 0) *flag = atomicAdd(&a.tickets[grp], 1) == b1 - b0 - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  if (groups == 1) {
    for (int c = tid; c < co; c += kThreads)
      moments_out(ordered_sum_cg<kGroup>(a.scratch + c, b1 - b0, row),
                  ordered_sum_cg<kGroup>(a.scratch + co + c, b1 - b0, row), a.inv_m,
                  a.moments + c, a.moments + co + c);
    if (tid == 0) a.tickets[grp] = 0;
    return;
  }
  float* gsum = a.scratch + (gridDim.x + grp) * row;
  for (int e = tid; e < 2 * co; e += kThreads)
    __stcg(gsum + e, ordered_sum_cg<kGroup>(a.scratch + b0 * row + e, b1 - b0, row));
  if (tid == 0) a.tickets[grp] = 0;
  __threadfence();
  __syncthreads();
  if (tid == 0) *flag = atomicAdd(&a.tickets[groups], 1) == groups - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  for (int c = tid; c < co; c += kThreads) {
    const float* p = a.scratch + gridDim.x * row + c;
    moments_out(ordered_sum_cg<kMaxGroups>(p, groups, row),
                ordered_sum_cg<kMaxGroups>(p + co, groups, row), a.inv_m, a.moments + c,
                a.moments + co + c);
  }
  if (tid == 0) a.tickets[groups] = 0;
}

// the widths it takes: divisible by 8 (16-byte copies of x and y) up to
// kMaxC, Ci x Co up to kMaxCiCo (W and the staging fit beside the ring)
inline bool widths_ok(int ci, int co) {
  return ci >= 8 && co >= 8 && ci % 8 == 0 && co % 8 == 0 && ci <= kMaxC && co <= kMaxC &&
         ci * co <= kMaxCiCo;
}

cudaError_t run(const Args& a, cudaStream_t st) {
  const Plan p = plan(a.P, a.ci, a.co);
  if (p.stages < 2 || ctas_per_sm<bn_pw_fwd_kernel>(kThreads, p.smem) < 1)
    return cudaErrorInvalidValue;
  bn_pw_fwd_kernel<<<p.grid, kThreads, p.smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace npf

// ---------------------------------------------------------------------------
// 3x3 depthwise backward, stride S, dilation D, in gather form, on a grid
// sized to the card: each CTA owns a channel slice of cs channels and walks
// kTileH x kTileW tiles of input pixels (every image), dk and the two sums
// in registers across its tiles, one partial at the end. A thread owns 4
// channels (a quad) of the slice and pixel slots slot, slot + slots, ... of
// a tile. Per tile:
//   stage   cp.async, 16 bytes a copy: gy and a_next on the window of
//           outputs the tile's inputs feed (stride 1: the tile plus a D
//           halo; stride 2: kTileH / 2 + 1 rows and columns), a_k on the
//           tile; double-buffered, so the next tile's copies fly while this
//           one is computed
//   B       ga = the next BN's backward of (gy, a_next), once per window
//           element, in f32 in shared memory (zero outside the output)
//   D       per input pixel: xh_k, u_k and z = act(u_k) from the staged a_k,
//           its <= 9 taps of ga give gy_k = sum_tap k * ga * act'(u_k) and
//           dk[tap] += z * ga
// ---------------------------------------------------------------------------

constexpr int kTileH = 8, kTileW = 8, kTile = kTileH * kTileW;
constexpr int kDwSmemLimit = 232448;
static_assert(kTileH % 2 == 0 && kTileW % 2 == 0, "stride-2 windows need even tiles");

__host__ __device__ constexpr int dwb_win(int S, int D, int t) {
  return S == 1 ? t + 2 * D : t / 2 + 1;
}
// dynamic shared memory of a launch: two stages of the raw tiles, ga, the
// taps and BN tables; or the end's reduction over the slots if larger
__host__ __device__ constexpr int dwb_smem(int S, int D, int cs, int esize) {
  const int win = dwb_win(S, D, kTileH) * dwb_win(S, D, kTileW);
  const int tile = 2 * (2 * win + kTile) * cs * esize + 4 * (win + 9 + 9) * cs;
  const int red = 4 * 11 * (kThreads / (cs / 4)) * cs;
  return tile > red ? tile : red;
}

// four adjacent channels (the pointer is 4-element aligned)
template <typename T> __device__ __forceinline__ float4 load4(const T* p);
template <> __device__ __forceinline__ float4 load4<float>(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
template <> __device__ __forceinline__ float4 load4<__nv_bfloat16>(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
template <typename T> __device__ __forceinline__ void store4(T* p, const float (&v)[4]);
template <> __device__ __forceinline__ void store4<float>(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
template <> __device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* p,
                                                                 const float (&v)[4]) {
  uint2 u;
  *reinterpret_cast<__nv_bfloat162*>(&u.x) = __floats2bfloat162_rn(v[0], v[1]);
  *reinterpret_cast<__nv_bfloat162*>(&u.y) = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = u;
}
__device__ __forceinline__ void unpack4(const float4& f, float (&v)[4]) {
  v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
}

template <typename T, int S, int D>
__global__ void __launch_bounds__(kThreads, 2)
dw_bwd_kernel(const T* __restrict__ gy, const T* __restrict__ an,
              const float* __restrict__ pn, const T* __restrict__ ak,
              const float* __restrict__ bnk, const float* __restrict__ k,
              T* __restrict__ gyk, float* __restrict__ psum, float* __restrict__ pk,
              int n, int h, int w, int c, int relu, float eps, int cs) {
  static_assert(S == 1 || D == 1, "stride 2 takes dilation 1");
  constexpr int WH = dwb_win(S, D, kTileH), WW = dwb_win(S, D, kTileW), WIN = WH * WW;
  constexpr int kPer16 = 16 / sizeof(T);   // channels in a 16-byte copy
  constexpr int kRaw = 2 * WIN + kTile;    // pixels of a stage: gy, a_next windows, a_k tile
  extern __shared__ __align__(16) unsigned char smem[];
  T* raw = reinterpret_cast<T*>(smem);     // [2][kRaw][cs]
  float* ga = reinterpret_cast<float*>(raw + 2 * kRaw * cs);   // [WIN][cs]
  float* kt = ga + WIN * cs;               // [9][cs] the taps
  float* tb = kt + 9 * cs;                 // [9][cs] BN_k's mean, inv, gamma, beta and
                                           // the next BN's mean, inv, gi, sgm, sgxm
  const int tid = threadIdx.x, c0 = blockIdx.y * cs;
  const int ho = (h - 1) / S + 1, wo = (w - 1) / S + 1;
  const int tiles_w = (w + kTileW - 1) / kTileW, tiles_img = ((h + kTileH - 1) / kTileH) * tiles_w;
  const int ntiles = n * tiles_img, cpp = cs / kPer16;
  const int quads = cs / 4, slots = kThreads / quads, qd = tid % quads, slot = tid / quads;
  const int ch = 4 * qd;   // this thread's channels c0 + ch .. c0 + ch + 3
  for (int i = tid; i < 9 * cs; i += kThreads) {
    const int tap = i / cs, cl = i - tap * cs;
    kt[i] = k[(size_t)(c0 + cl) * 9 + tap];
  }
  for (int cl = tid; cl < cs; cl += kThreads) {
    const Bn b = load_bn(bnk, c0 + cl, eps);
    const BnBwd q = load_bn_bwd(pn, c0 + cl, eps);
    const float f[9] = {b.mean, b.inv, b.gamma, b.beta, q.mean, q.inv, q.gi, q.sgm, q.sgxm};
#pragma unroll
    for (int j = 0; j < 9; ++j) tb[j * cs + cl] = f[j];
  }

  auto origin = [&](int tile, int& img, int& ih0, int& iw0) {
    img = tile / tiles_img;
    const int r = tile - img * tiles_img;
    ih0 = (r / tiles_w) * kTileH;
    iw0 = (r % tiles_w) * kTileW;
  };
  auto stage = [&](int tile, T* dst) {
    int img, ih0, iw0;
    origin(tile, img, ih0, iw0);
    const int oh0 = S == 1 ? ih0 - D : ih0 / 2, ow0 = S == 1 ? iw0 - D : iw0 / 2;
    for (int i = tid; i < WIN * cpp; i += kThreads) {
      const int pos = i / cpp, part = i - pos * cpp;
      const int oh = oh0 + pos / WW, ow = ow0 + pos % WW;
      if (oh >= 0 && oh < ho && ow >= 0 && ow < wo) {
        const size_t at = ((size_t)(img * ho + oh) * wo + ow) * c + c0 + part * kPer16;
        hop::cp_async16(dst + pos * cs + part * kPer16, gy + at);
        hop::cp_async16(dst + (WIN + pos) * cs + part * kPer16, an + at);
      }
    }
    for (int i = tid; i < kTile * cpp; i += kThreads) {
      const int pos = i / cpp, part = i - pos * cpp;
      const int ih = ih0 + pos / kTileW, iw = iw0 + pos % kTileW;
      if (ih < h && iw < w)
        hop::cp_async16(dst + (2 * WIN + pos) * cs + part * kPer16,
                        ak + ((size_t)(img * h + ih) * w + iw) * c + c0 + part * kPer16);
    }
  };

  float acc[11][4];   // dk[0..8], sum gy_k, sum gy_k * xh_k of channels c0 + ch + e
#pragma unroll
  for (int v = 0; v < 11; ++v)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[v][e] = 0.f;
  __syncthreads();
  Bn bk[4];
  {
    float f[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) unpack4(*reinterpret_cast<const float4*>(tb + j * cs + ch), f[j]);
#pragma unroll
    for (int e = 0; e < 4; ++e) bk[e] = Bn{f[0][e], f[1][e], f[2][e], f[3][e]};
  }

  int cur = 0;
  if ((int)blockIdx.x < ntiles) stage(blockIdx.x, raw);
  hop::cp_async_commit();
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    if (tile + (int)gridDim.x < ntiles) stage(tile + gridDim.x, raw + (cur ^ 1) * kRaw * cs);
    hop::cp_async_commit();
    hop::cp_async_wait<1>();
    __syncthreads();
    const T* rg = raw + cur * kRaw * cs;
    int img, ih0, iw0;
    origin(tile, img, ih0, iw0);
    const int oh0 = S == 1 ? ih0 - D : ih0 / 2, ow0 = S == 1 ? iw0 - D : iw0 / 2;
    // B: ga on the window
    if (slot < slots) {
      float f[5][4];
#pragma unroll
      for (int j = 0; j < 5; ++j)
        unpack4(*reinterpret_cast<const float4*>(tb + (4 + j) * cs + ch), f[j]);
      BnBwd nb[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) nb[e] = BnBwd{f[0][e], f[1][e], f[2][e], f[3][e], f[4][e]};
      for (int pos = slot; pos < WIN; pos += slots) {
        const int oh = oh0 + pos / WW, ow = ow0 + pos % WW;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (oh >= 0 && oh < ho && ow >= 0 && ow < wo) {
          const float4 g4 = load4<T>(rg + pos * cs + ch);
          const float4 a4 = load4<T>(rg + (WIN + pos) * cs + ch);
          v = make_float4(bn_bwd(g4.x, a4.x, nb[0]), bn_bwd(g4.y, a4.y, nb[1]),
                          bn_bwd(g4.z, a4.z, nb[2]), bn_bwd(g4.w, a4.w, nb[3]));
        }
        *reinterpret_cast<float4*>(ga + pos * cs + ch) = v;
      }
    }
    __syncthreads();
    // D: gy_k and dk per input pixel
    if (slot < slots)
      for (int q = slot; q < kTile; q += slots) {
        // stride 2: pixels go by row and column parity (1, 2, 2 or 4 taps),
        // so a warp's slots share their taps
        constexpr int kClass = kTile / 4, kCw = kTileW / 2;
        const int r = S == 1 ? q / kTileW : 2 * ((q % kClass) / kCw) + q / kClass / 2;
        const int cc = S == 1 ? q % kTileW : 2 * ((q % kClass) % kCw) + q / kClass % 2;
        const int ih = ih0 + r, iw = iw0 + cc;
        if (ih >= h || iw >= w) continue;
        float a[4], xh[4], u[4], z[4], gh[4] = {0.f, 0.f, 0.f, 0.f};
        unpack4(load4<T>(rg + (2 * WIN + r * kTileW + cc) * cs + ch), a);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          xh[e] = bn_xh(a[e], bk[e]);
          u[e] = bn_u(xh[e], bk[e]);
          z[e] = act(u[e], relu);
        }
#pragma unroll
        for (int dh = 0; dh < 3; ++dh) {
          // the window row of the output whose tap dh reads input row ih
          if (S == 2 && ((r + 1 - dh) & 1)) continue;
          const int wr = S == 1 ? r + (2 - dh) * D : (r + 1 - dh) / 2;
#pragma unroll
          for (int dw = 0; dw < 3; ++dw) {
            if (S == 2 && ((cc + 1 - dw) & 1)) continue;
            const int wc = S == 1 ? cc + (2 - dw) * D : (cc + 1 - dw) / 2;
            float gv[4], kv[4];
            unpack4(*reinterpret_cast<const float4*>(ga + (wr * WW + wc) * cs + ch), gv);
            unpack4(*reinterpret_cast<const float4*>(kt + (dh * 3 + dw) * cs + ch), kv);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              gh[e] = fmaf(kv[e], gv[e], gh[e]);
              acc[dh * 3 + dw][e] = fmaf(z[e], gv[e], acc[dh * 3 + dw][e]);
            }
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          gh[e] *= act_grad(u[e], relu);
          acc[9][e] += gh[e];
          acc[10][e] = fmaf(gh[e], xh[e], acc[10][e]);
        }
        store4<T>(gyk + ((size_t)(img * h + ih) * w + iw) * c + c0 + ch, gh);
      }
    __syncthreads();
    cur ^= 1;
  }
  hop::cp_async_wait<0>();
  // the CTA's partial: per value and channel, the slots in slot order
  float* red = reinterpret_cast<float*>(smem);   // [11][slots][cs]
  if (slot < slots)
#pragma unroll
    for (int v = 0; v < 11; ++v)
      *reinterpret_cast<float4*>(red + (v * slots + slot) * cs + ch) =
          make_float4(acc[v][0], acc[v][1], acc[v][2], acc[v][3]);
  __syncthreads();
  for (int i = tid; i < 11 * cs; i += kThreads) {
    const int v = i / cs, cl = i - v * cs;
    float tot = 0.f;
    for (int sl = 0; sl < slots; ++sl) tot += red[(v * slots + sl) * cs + cl];
    if (v < 9)
      pk[((size_t)blockIdx.x * 9 + v) * c + c0 + cl] = tot;
    else
      psum[((size_t)blockIdx.x * 2 + (v - 9)) * c + c0 + cl] = tot;
  }
}

// ---------------------------------------------------------------------------
// 3x3 depthwise forward, stride S, dilation D, on one wave of persistent
// CTAs: each owns a channel slice of cs = 4 G channels (G quads; whole
// 16-byte copies, so no idle channel lanes at 728 or 1536) and walks th x
// tile_w output tiles of every image. A thread owns one quad of the slice
// and pixel slots slot, slot + slots, ... (slots = 256 / G). Per tile:
//   stage     cp.async, 16 bytes a copy, of the tile's input window (its D
//             halo; stride 2: 2 th + 1 rows and 2 tile_w + 1 columns) into a
//             ring of kRaw raw buffers, so the next two tiles' copies fly
//             while this one is computed
//   prologue  h = act(BN(x)) once per staged element, in f32, into [pixel]
//             [cs] (a quarter-warp reads 128 contiguous bytes); zero at
//             every window element outside the image (the conv pads h, not
//             x: a zero x is not a zero h)
//   compute   a thread item is a strip of outputs of one row x its quad:
//             each staged h it needs is read once from shared memory and
//             feeds every tap that uses it; taps in registers
// The moments of y (f32, before rounding) stay in registers across tiles;
// at the end each CTA leaves its (2, cs) partial (the slots summed in slot
// order) and the partials are summed in the kernel over two levels of
// integer tickets (groups of kGroup CTAs, then the groups; every level's
// loads issued before its first add, common.cuh ordered_sum_cg); the last
// adder writes mean and biased variance. The grid, the slice and the tile
// depend on the shape alone (ops/stem.py bn_dw_fwd_plan mirrors plan()),
// so the sums' order, and with it every bit, is fixed. What bounds it:
// bytes on paper (x read and y written once); measured on the H100 it runs
// at ~2x that, held by the instruction issue of the prologue (5 f32 ops an
// element) and of the 9 FMAs an output with their shared-memory loads,
// while the copies wait little (PERF.md).
// ---------------------------------------------------------------------------

namespace dwf {

constexpr int kCtas = 264;      // two CTAs on each of the H100's 132 SMs: one wave
constexpr int kSmem = 115712;   // a CTA's shared memory at two CTAs per SM
constexpr int kRaw = 3;         // raw buffers of the copy ring
constexpr int kGroup = 24, kMaxGroups = (kCtas + kGroup - 1) / kGroup;

// a thread item: strip(S) outputs of a row; strips(S) items a tile row
__host__ __device__ constexpr int strip(int S) { return S == 1 ? 8 : 2; }
__host__ __device__ constexpr int strips(int S) { return S == 1 ? 2 : 4; }
__host__ __device__ constexpr int tile_w(int S) { return strips(S) * strip(S); }
__host__ __device__ constexpr int win(int S, int D, int t) { return S == 1 ? t + 2 * D : 2 * t + 1; }
// kRaw raw buffers in the activation dtype and the f32 h of one window; the
// end's reduction over the slots and the adder's flag reuse it (no static
// shared memory: the dynamic limit is raised to all of the 227 KB)
constexpr int kRed = 2 * kThreads * 16;
__host__ __device__ constexpr int smem(int S, int D, int th, int cs, int esize) {
  return win(S, D, th) * win(S, D, tile_w(S)) * cs * (kRaw * esize + 4) > kRed + 16
             ? win(S, D, th) * win(S, D, tile_w(S)) * cs * (kRaw * esize + 4)
             : kRed + 16;
}

struct Plan {
  int cs, th, grid, groups, slices;
};

// the widest slice (G <= 16 quads dividing c / 4, 16-byte copies) whose
// tile fits kSmem at th = the rows whose items the slots hold at once
// (fewer where the window does not fit), and as many CTAs along x as one
// wave holds for the c / cs slices along y (at most one a tile)
inline bool plan(Plan& p, int esize, int S, int D, int n, int h, int w, int c) {
  for (int g = 16; g >= 1; --g) {
    const int cs = 4 * g;
    if ((c / 4) % g || (cs * esize) % 16) continue;
    int th = std::max(1, kThreads / g / strips(S));
    while (th > 1 && smem(S, D, th, cs, esize) > kSmem) --th;
    if (smem(S, D, th, cs, esize) > kSmem) continue;
    const int ho = (h - 1) / S + 1, wo = (w - 1) / S + 1;
    const long long tiles =
        (long long)n * ((ho + th - 1) / th) * ((wo + tile_w(S) - 1) / tile_w(S));
    p.cs = cs, p.th = th, p.slices = c / cs;
    p.grid = (int)std::max(1LL, std::min(tiles, (long long)(kCtas / p.slices)));
    p.groups = (p.grid + kGroup - 1) / kGroup;
    return true;
  }
  return false;
}

template <typename T> struct Args {
  const T* x;          // (n, h, w, c)
  const float* bn;     // (c, 4), null: the identity
  const float* k;      // (c, 9)
  T* y;                // (n, ho, wo, c)
  float* scratch;      // (gridDim.x + groups, 2, c): the CTAs' and the groups' partials;
                       // null: no moments
  float* moments;      // (2, c): mean and biased variance of y
  int* tickets;        // (c / cs, groups + 1): zero between launches
  int n, h, w, c, relu, cs, th;
  float eps, inv_m;    // inv_m = 1 / (n ho wo) in f32
};

template <typename T, int S, int D>
__global__ void __launch_bounds__(kThreads, 2) bn_dw_fwd_kernel(const Args<T> a) {
  static_assert(S == 1 || D == 1, "stride 2 takes dilation 1");
  constexpr int R = strip(S), NS = strips(S), TW = tile_w(S), WW = win(S, D, TW);
  constexpr int NJ = (R - 1) * S + 2 * D + 1;   // window columns of an item
  constexpr int kPer16 = 16 / sizeof(T);        // channels in a 16-byte copy
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int& last = *reinterpret_cast<int*>(smem_raw + kRed);
  const int cs = a.cs, th = a.th, c = a.c, h = a.h, w = a.w;
  const int WH = win(S, D, th), WIN = WH * WW;
  T* raw = reinterpret_cast<T*>(smem_raw);                       // [kRaw][WIN][cs]
  float* hs = reinterpret_cast<float*>(raw + kRaw * WIN * cs);   // [WIN][cs]
  const int tid = threadIdx.x, quads = cs / 4, slots = kThreads / quads;
  const int qd = tid % quads, slot = tid / quads, c0 = blockIdx.y * cs, ch = c0 + 4 * qd;
  const bool active = slot < slots;
  const int ho = (h - 1) / S + 1, wo = (w - 1) / S + 1;
  const int tiles_w = (wo + TW - 1) / TW, tiles_img = ((ho + th - 1) / th) * tiles_w;
  const int ntiles = a.n * tiles_img, cpp = cs / kPer16;

  float kv[9][4];
  Bn bq[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) kv[tap][e] = active ? a.k[(size_t)(ch + e) * 9 + tap] : 0.f;
    bq[e] = load_bn(active ? a.bn : nullptr, ch + e, a.eps);
  }

  auto origin = [&](int tile, int& img, int& oh0, int& ow0) {
    img = tile / tiles_img;
    const int r = tile - img * tiles_img;
    oh0 = (r / tiles_w) * th;
    ow0 = (r % tiles_w) * TW;
  };
  // the window's first input row and column
  auto corner = [&](int oh0, int ow0, int& ih0, int& iw0) {
    ih0 = S == 1 ? oh0 - D : 2 * oh0 - 1;
    iw0 = S == 1 ? ow0 - D : 2 * ow0 - 1;
  };
  auto stage = [&](int tile, T* dst) {
    int img, oh0, ow0, ih0, iw0;
    origin(tile, img, oh0, ow0);
    corner(oh0, ow0, ih0, iw0);
    for (int i = tid; i < WIN * cpp; i += kThreads) {
      const int pos = i / cpp, part = i - pos * cpp;
      const int ih = ih0 + pos / WW, iw = iw0 + pos % WW;
      if (ih >= 0 && ih < h && iw >= 0 && iw < w)
        hop::cp_async16(dst + pos * cs + part * kPer16,
                        a.x + ((size_t)(img * h + ih) * w + iw) * c + c0 + part * kPer16);
    }
  };

  float st[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};   // sum, sum sq
#pragma unroll
  for (int j = 0; j < kRaw - 1; ++j) {
    const int tile = blockIdx.x + j * gridDim.x;
    if (tile < ntiles) stage(tile, raw + j * WIN * cs);
    hop::cp_async_commit();
  }
  int it = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++it) {
    // the buffer this fills was last read by the previous tile's prologue
    const int pre = tile + (kRaw - 1) * gridDim.x;
    if (pre < ntiles) stage(pre, raw + ((it + kRaw - 1) % kRaw) * WIN * cs);
    hop::cp_async_commit();
    hop::cp_async_wait<kRaw - 1>();
    __syncthreads();   // this tile's copies have landed; the last tile's h is read
    int img, oh0, ow0, ih0, iw0;
    origin(tile, img, oh0, ow0);
    corner(oh0, ow0, ih0, iw0);
    const T* rg = raw + (it % kRaw) * WIN * cs;
    if (active)
      for (int pos = slot; pos < WIN; pos += slots) {
        const int ih = ih0 + pos / WW, iw = iw0 + pos % WW;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (ih >= 0 && ih < h && iw >= 0 && iw < w) {
          const float4 x4 = load4<T>(rg + pos * cs + 4 * qd);
          v = make_float4(act(bn_u(bn_xh(x4.x, bq[0]), bq[0]), a.relu),
                          act(bn_u(bn_xh(x4.y, bq[1]), bq[1]), a.relu),
                          act(bn_u(bn_xh(x4.z, bq[2]), bq[2]), a.relu),
                          act(bn_u(bn_xh(x4.w, bq[3]), bq[3]), a.relu));
        }
        *reinterpret_cast<float4*>(hs + pos * cs + 4 * qd) = v;
      }
    __syncthreads();
    if (active)
      for (int item = slot; item < th * NS; item += slots) {
        const int r = item / NS, col0 = (item % NS) * R;
        const int oh = oh0 + r, ow = ow0 + col0;
        if (oh >= ho || ow >= wo) continue;
        float acc[R][4];
#pragma unroll
        for (int t = 0; t < R; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
#pragma unroll
        for (int dh = 0; dh < 3; ++dh) {
          const float* row = hs + ((S == 1 ? r + dh * D : 2 * r + dh) * WW + S * col0) * cs + 4 * qd;
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj) {
            float hv[4];
            unpack4(*reinterpret_cast<const float4*>(row + jj * cs), hv);
#pragma unroll
            for (int dw = 0; dw < 3; ++dw) {
              // output col0 + t reads window column S (col0 + t) + dw D
              const int off = jj - dw * D;
              if (off < 0 || off % S != 0 || off / S >= R) continue;
              const int t = off / S;
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[t][e] = fmaf(kv[dh * 3 + dw][e], hv[e], acc[t][e]);
            }
          }
        }
        T* out = a.y + ((size_t)(img * ho + oh) * wo + ow) * c + ch;
#pragma unroll
        for (int t = 0; t < R; ++t) {
          if (ow + t >= wo) break;
          store4<T>(out + (size_t)t * c, acc[t]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            st[0][e] += acc[t][e];
            st[1][e] = fmaf(acc[t][e], acc[t][e], st[1][e]);
          }
        }
      }
  }
  hop::cp_async_wait<0>();
  if (a.scratch == nullptr) return;   // an eval pass: no moments

  // the CTA's partial: per channel the slots in slot order
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem_raw);   // [2][slots][cs]
  if (active)
#pragma unroll
    for (int v = 0; v < 2; ++v)
      *reinterpret_cast<float4*>(red + (v * slots + slot) * cs + 4 * qd) =
          make_float4(st[v][0], st[v][1], st[v][2], st[v][3]);
  __syncthreads();
  float* mine = a.scratch + (size_t)blockIdx.x * 2 * c + c0;
  for (int i = tid; i < 2 * cs; i += kThreads) {
    const int v = i / cs, cl = i - v * cs;
    float tot = 0.f;
    for (int sl = 0; sl < slots; ++sl) tot += red[(v * slots + sl) * cs + cl];
    __stcg(mine + v * c + cl, tot);
  }
  // the slice's sum over the CTAs along x, in a fixed order over two levels
  // of integer tickets: the CTA that takes the last ticket of its group
  // adds the group's partials in CTA order; with more than one group, the
  // last group's adder adds the groups' sums in group order. Each adder
  // resets its ticket. Who adds depends on timing, the order does not.
  const int gx = gridDim.x, grp = blockIdx.x / kGroup, x0 = grp * kGroup;
  const int x1 = min(gx, x0 + kGroup), groups = (gx + kGroup - 1) / kGroup;
  const size_t row = 2 * (size_t)c;
  int* tk = a.tickets + blockIdx.y * (groups + 1);
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&tk[grp], 1) == x1 - x0 - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (groups == 1) {   // one group: its sums are the moments
    for (int cl = tid; cl < cs; cl += kThreads) {
      const float* p = a.scratch + c0 + cl;
      moments_out(ordered_sum_cg<kGroup>(p, gx, row), ordered_sum_cg<kGroup>(p + c, gx, row),
                  a.inv_m, a.moments + c0 + cl, a.moments + c + c0 + cl);
    }
    if (tid == 0) tk[grp] = 0;
    return;
  }
  float* gsum = a.scratch + (size_t)(gx + grp) * row + c0;
  for (int i = tid; i < 2 * cs; i += kThreads) {
    const int v = i / cs, cl = i - v * cs;
    __stcg(gsum + v * c + cl,
           ordered_sum_cg<kGroup>(a.scratch + x0 * row + v * c + c0 + cl, x1 - x0, row));
  }
  if (tid == 0) tk[grp] = 0;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&tk[groups], 1) == groups - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int cl = tid; cl < cs; cl += kThreads) {
    const float* p = a.scratch + gx * row + c0 + cl;
    moments_out(ordered_sum_cg<kMaxGroups>(p, groups, row),
                ordered_sum_cg<kMaxGroups>(p + c, groups, row), a.inv_m, a.moments + c0 + cl,
                a.moments + c + c0 + cl);
  }
  if (tid == 0) tk[groups] = 0;
}

template <typename T, int S, int D>
cudaError_t launch(const Args<T>& a, const Plan& p, cudaStream_t st) {
  const int bytes = smem(S, D, p.th, p.cs, sizeof(T));
  if (ctas_per_sm<bn_dw_fwd_kernel<T, S, D>>(kThreads, bytes) < 1) return cudaErrorInvalidValue;
  bn_dw_fwd_kernel<T, S, D><<<dim3(p.grid, p.slices), kThreads, bytes, st>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(Args<T> a, const Plan& p, int stride, int dil, cudaStream_t st) {
  a.cs = p.cs, a.th = p.th;
  if (stride == 1 && dil == 1) return launch<T, 1, 1>(a, p, st);
  if (stride == 1 && dil == 2) return launch<T, 1, 2>(a, p, st);
  if (stride == 2 && dil == 1) return launch<T, 2, 1>(a, p, st);
  return cudaErrorInvalidValue;
}

}  // namespace dwf

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename T>
cudaError_t run_pw_fwd(const void* x, const void* bn, const void* w, void* y,
                       void* partial, int P, int ci, int co, int relu, float eps,
                       int grid, int smem, cudaStream_t st) {
  auto kern = bn_pw_fwd_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kern<<<grid, kThreads, smem, st>>>(static_cast<const T*>(x), static_cast<const float*>(bn),
                                     static_cast<const T*>(w), static_cast<T*>(y),
                                     static_cast<float*>(partial), P, ci, co, relu, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_pw_bwd(const void* gy, const void* an, const void* pn, const void* ak,
                       const void* bnk, const void* w, void* gyk, void* psum, void* pw,
                       int P, int ci, int co, int relu, float eps, int grid, int smem,
                       cudaStream_t st) {
  auto kern = pw_bwd_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(gy), static_cast<const T*>(an), static_cast<const float*>(pn),
      static_cast<const T*>(ak), static_cast<const float*>(bnk), static_cast<const T*>(w),
      static_cast<T*>(gyk), static_cast<float*>(psum), static_cast<float*>(pw), P, ci, co,
      relu, eps);
  return cudaGetLastError();
}

struct DwBwdArgs {
  const void *gy, *an, *pn, *ak, *bnk, *k;
  void *gyk, *psum, *pk;
  int n, h, w, c, relu;
  float eps;
};

// a launch's channel slice (cs = 4 G, G <= 16 quads dividing c / 4, whole
// 16-byte copies: no idle channel lanes), its shared memory and its grid:
// the slice that keeps the most channels resident per SM (CTAs per SM x
// cs, the widest on a tie), and as many CTAs along x as the card holds at
// once for the c / cs slices along y (one wave; at most one a tile, at
// least one). The grid depends on the shape and the card only.
struct DwBwdPlan {
  int cs, smem, grid_x;
};

template <typename T, int S, int D>
bool dw_bwd_plan(DwBwdPlan& p, int n, int h, int w, int c) {
  int pick = 0, occ = 0;
  for (int groups = 16; groups >= 1; --groups) {
    const int cs = 4 * groups, smem = dwb_smem(S, D, cs, sizeof(T));
    if ((c / 4) % groups || cs % (16 / (int)sizeof(T)) || smem > kDwSmemLimit) continue;
    const int o = ctas_per_sm<dw_bwd_kernel<T, S, D>>(kThreads, smem);
    if (o >= 1 && o * groups > occ * pick) pick = groups, occ = o;
  }
  if (pick == 0) return false;
  p.cs = 4 * pick;
  p.smem = dwb_smem(S, D, p.cs, sizeof(T));
  const int slices = c / p.cs;
  const int ntiles = n * ((h + kTileH - 1) / kTileH) * ((w + kTileW - 1) / kTileW);
  p.grid_x = std::max(1, std::min(ntiles, occ * sm_count() / slices));   // one wave
  return true;
}

// launches on st with grid `grid` (which must be the plan's), or with
// grid_out set only writes the plan's grid there
template <typename T, int S, int D>
cudaError_t run_dw_bwd(const DwBwdArgs& a, int grid, int* grid_out, cudaStream_t st) {
  DwBwdPlan p;
  if (!dw_bwd_plan<T, S, D>(p, a.n, a.h, a.w, a.c)) return cudaErrorInvalidValue;
  if (grid_out != nullptr) {
    *grid_out = p.grid_x;
    return cudaSuccess;
  }
  if (grid != p.grid_x) return cudaErrorInvalidValue;
  dw_bwd_kernel<T, S, D><<<dim3(p.grid_x, a.c / p.cs), kThreads, p.smem, st>>>(
      static_cast<const T*>(a.gy), static_cast<const T*>(a.an), static_cast<const float*>(a.pn),
      static_cast<const T*>(a.ak), static_cast<const float*>(a.bnk),
      static_cast<const float*>(a.k), static_cast<T*>(a.gyk), static_cast<float*>(a.psum),
      static_cast<float*>(a.pk), a.n, a.h, a.w, a.c, a.relu, a.eps, p.cs);
  return cudaGetLastError();
}

cudaError_t dw_bwd_dispatch(int dtype, int stride, int dil, const DwBwdArgs& a, int grid,
                            int* grid_out, cudaStream_t st) {
  using bf = __nv_bfloat16;
  if (a.c < 8 || a.c % 8 != 0 || !act_ok(a.relu)) return cudaErrorInvalidValue;
#define KDCC_DWB(T, S, D)                                              \
  if (stride == S && dil == D) return run_dw_bwd<T, S, D>(a, grid, grid_out, st)
  if (dtype == 0) {
    KDCC_DWB(float, 1, 1);
    KDCC_DWB(float, 1, 2);
    KDCC_DWB(float, 2, 1);
  }
  if (dtype == 1) {
    KDCC_DWB(bf, 1, 1);
    KDCC_DWB(bf, 1, 2);
    KDCC_DWB(bf, 2, 1);
  }
#undef KDCC_DWB
  return cudaErrorInvalidValue;
}

// channel counts the 1x1 kernels take: even, at most kMaxC (register budgets)
bool channels_ok(int c) { return c >= 2 && c % 2 == 0 && c <= kMaxC; }

}  // namespace

extern "C" {

// 1x1 forward, float32 (the parity variant; bfloat16 is kdcc_bn_pw_fwd_bf16).
// x (P, ci), w (co, ci) in dtype; bn (ci, 4) f32 or null; y (P, co) in
// dtype; partial (grid, 2, co) f32, or null for no moments. smem must be the
// layout's.
int kdcc_bn_pw_fwd(int dtype, const void* x, const void* bn, const void* w, void* y,
                   void* partial, int P, int ci, int co, int relu, float eps, int grid,
                   int smem, void* stream) {
  if (dtype != 0 || smem != 4 * pw_fwd_smem_floats(ci, co) || grid < 1 || !channels_ok(ci) ||
      !channels_ok(co) || !act_ok(relu))
    return (int)cudaErrorInvalidValue;
  return (int)run_pw_fwd<float>(x, bn, w, y, partial, P, ci, co, relu, eps, grid, smem,
                                static_cast<cudaStream_t>(stream));
}

// The bfloat16 1x1 forward's plan for a shape, by `what`: 0 its CTAs, 1 the
// groups of its moments' first-level sum, 2 the f32 scratch its moments
// need ((CTAs + groups) x 2 x co), 3 its ring's stages; -1 for a shape it
// does not take.
int kdcc_bn_pw_fwd_plan(int what, int P, int ci, int co) {
  if (P < 1 || !npf::widths_ok(ci, co)) return -1;
  const npf::Plan p = npf::plan(P, ci, co);
  if (p.stages < 2) return -1;
  if (what == 0) return p.grid;
  if (what == 1) return p.groups;
  if (what == 2) return (p.grid + p.groups) * 2 * co;
  if (what == 3) return p.stages;
  return -1;
}

// 1x1 forward, bfloat16, in one launch. x (P, ci), w (co, ci), y (P, co)
// bf16, 16-byte aligned; bn (ci, 4) f32 or null (the identity). With
// moments: scratch f32 of scratch_floats, moments (2, co) f32 (mean, biased
// variance of y) and tickets int32 (groups + 1,), zero, left zero; without
// (an eval pass) all three null. grid and scratch_floats must be
// kdcc_bn_pw_fwd_plan's.
int kdcc_bn_pw_fwd_bf16(const void* x, const void* bn, const void* w, void* y, void* scratch,
                        void* moments, void* tickets, int P, int ci, int co, int relu, float eps,
                        int grid, int scratch_floats, void* stream) {
  const bool mom = scratch != nullptr;
  const uintptr_t bits = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(y);
  if (x == nullptr || w == nullptr || y == nullptr || bits % 16 || !act_ok(relu) ||
      grid != kdcc_bn_pw_fwd_plan(0, P, ci, co) ||
      (mom && (moments == nullptr || tickets == nullptr ||
               scratch_floats != kdcc_bn_pw_fwd_plan(2, P, ci, co))))
    return (int)cudaErrorInvalidValue;
  npf::Args a{};
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.bn = static_cast<const float*>(bn);
  a.y = static_cast<__nv_bfloat16*>(y);
  a.scratch = static_cast<float*>(scratch);
  a.moments = static_cast<float*>(moments);
  a.tickets = static_cast<int*>(tickets);
  a.P = P, a.ci = ci, a.co = co, a.relu = relu, a.eps = eps;
  a.inv_m = 1.0f / (float)P;
  return (int)npf::run(a, static_cast<cudaStream_t>(stream));
}

// The depthwise forward's plan for a shape (dtype 0 float32, 1 bfloat16),
// by `what`: 0 its CTAs along x, 1 its channel slice, 2 the groups of its
// moments' first-level sum, 3 the f32 scratch its moments need ((CTAs +
// groups) x 2 x c), 4 its tickets (c / slice x (groups + 1)), 5 its tile
// rows; -1 for a shape it does not take.
int kdcc_bn_dw_fwd_plan(int what, int dtype, int n, int h, int w, int c, int stride, int dil) {
  dwf::Plan p;
  if ((dtype != 0 && dtype != 1) || n < 1 || h < 1 || w < 1 || c < 8 || c % 8 != 0 ||
      !((stride == 1 && (dil == 1 || dil == 2)) || (stride == 2 && dil == 1)) ||
      !dwf::plan(p, dtype == 0 ? 4 : 2, stride, dil, n, h, w, c))
    return -1;
  switch (what) {
    case 0: return p.grid;
    case 1: return p.cs;
    case 2: return p.groups;
    case 3: return (p.grid + p.groups) * 2 * c;
    case 4: return p.slices * (p.groups + 1);
    case 5: return p.th;
    default: return -1;
  }
}

// 3x3 depthwise forward, stride 1 at dilation 1 or 2, or stride 2 at
// dilation 1. x (n, h, w, c) and y (n, ho, wo, c) in dtype, 16-byte
// aligned, c % 8 == 0; bn (c, 4) f32 or null (the identity); k (c, 9) f32.
// With moments: scratch f32 of scratch_floats, moments (2, c) f32 (mean,
// biased variance of y) and tickets int32 (kdcc_bn_dw_fwd_plan's 3 and 4),
// the tickets zero, left zero; without (an eval pass) all three null. grid
// and scratch_floats must be the plan's.
int kdcc_bn_dw_fwd(int dtype, const void* x, const void* bn, const void* k, void* y,
                   void* scratch, void* moments, void* tickets, int n, int h, int w, int c,
                   int stride, int dil, int relu, float eps, int grid, int scratch_floats,
                   void* stream) {
  const bool mom = scratch != nullptr;
  if (x == nullptr || y == nullptr || k == nullptr || !act_ok(relu) ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16 ||
      grid != kdcc_bn_dw_fwd_plan(0, dtype, n, h, w, c, stride, dil) ||
      (mom && (moments == nullptr || tickets == nullptr ||
               scratch_floats != kdcc_bn_dw_fwd_plan(3, dtype, n, h, w, c, stride, dil))))
    return (int)cudaErrorInvalidValue;
  dwf::Plan p;
  dwf::plan(p, dtype == 0 ? 4 : 2, stride, dil, n, h, w, c);
  const int ho = (h - 1) / stride + 1, wo = (w - 1) / stride + 1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto fill = [&](auto& a, auto* tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    a.x = static_cast<const T*>(x);
    a.bn = static_cast<const float*>(bn);
    a.k = static_cast<const float*>(k);
    a.y = static_cast<T*>(y);
    a.scratch = static_cast<float*>(scratch);
    a.moments = static_cast<float*>(moments);
    a.tickets = static_cast<int*>(tickets);
    a.n = n, a.h = h, a.w = w, a.c = c, a.relu = relu, a.eps = eps;
    a.inv_m = 1.0f / (float)((long long)n * ho * wo);
  };
  if (dtype == 0) {
    dwf::Args<float> a{};
    fill(a, static_cast<float*>(nullptr));
    return (int)dwf::run<float>(a, p, stride, dil, st);
  }
  dwf::Args<__nv_bfloat16> a{};
  fill(a, static_cast<__nv_bfloat16*>(nullptr));
  return (int)dwf::run<__nv_bfloat16>(a, p, stride, dil, st);
}

// 1x1 backward, float32 (the parity variant; bfloat16 is kdcc_pw_bwd_bf16).
// gy, an (P, co) and ak (P, ci) in dtype; pn (co, 6) f32 or null (then an is
// not read); bnk (ci, 4) f32 or null; w (co, ci) in dtype; gyk (P, ci) in
// dtype; psum (grid, 2, ci) and pw (grid, co, ci) f32.
int kdcc_pw_bwd(int dtype, const void* gy, const void* an, const void* pn, const void* ak,
                const void* bnk, const void* w, void* gyk, void* psum, void* pw, int P,
                int ci, int co, int relu, float eps, int grid, int smem, void* stream) {
  if (dtype != 0 || smem != 4 * pw_bwd_smem_floats(ci, co) || grid < 1 || !channels_ok(ci) ||
      !channels_ok(co) || ci * co > kMaxCiCo || !act_ok(relu))
    return (int)cudaErrorInvalidValue;
  return (int)run_pw_bwd<float>(gy, an, pn, ak, bnk, w, gyk, psum, pw, P, ci, co, relu, eps,
                                grid, smem, static_cast<cudaStream_t>(stream));
}

// The bfloat16 1x1 backward's plan for a shape, by `what`: 0 its CTAs, 1 the
// groups of its partials' sum, 2 the f32 scratch it needs ((CTAs + groups) x
// (co ci + 2 ci)), 3 its ring's stages; -1 for a shape it does not take.
int kdcc_pw_bwd_plan(int what, int P, int ci, int co, int has_pn) {
  if (P < 1 || !channels_ok(ci) || !channels_ok(co) || ci * co > kMaxCiCo ||
      nbw::r8(ci) / 8 > 4 * nbw::kS1 ||
      (nbw::r16(co) / 16) * (nbw::r8(ci) / 8) > nbw::kWarps * nbw::kS2)
    return -1;   // past the warps' sub-tile slots
  const nbw::Plan p = nbw::plan(P, ci, co, has_pn != 0);
  if (p.stages < 2) return -1;
  if (what == 0) return p.grid;
  if (what == 1) return p.groups;
  if (what == 2) return (p.grid + p.groups) * p.v;
  if (what == 3) return p.stages;
  return -1;
}

// 1x1 backward, bfloat16, in one launch. gy, an (P, co), ak (P, ci), w (co,
// ci) bf16 (gy, an, ak 16-byte aligned); pn (co, 6) f32 or null (then an is
// not read); bnk (ci, 4) f32 or null; gyk (P, ci) bf16; dw (co, ci) and
// sums (ci, 2) f32, 16-byte aligned; scratch f32 of scratch_floats
// (kdcc_pw_bwd_plan's); tickets (groups + 1,) int32, zero, left zero.
int kdcc_pw_bwd_bf16(const void* gy, const void* an, const void* pn, const void* ak,
                     const void* bnk, const void* w, void* gyk, void* dw, void* sums,
                     void* scratch, void* tickets, int P, int ci, int co, int relu, float eps,
                     int scratch_floats, void* stream) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(gy) | reinterpret_cast<uintptr_t>(ak) |
                         reinterpret_cast<uintptr_t>(dw) | reinterpret_cast<uintptr_t>(sums) |
                         (pn != nullptr ? reinterpret_cast<uintptr_t>(an) : 0);
  if (!act_ok(relu) || bits % 16 || gy == nullptr || ak == nullptr || w == nullptr ||
      gyk == nullptr || dw == nullptr || sums == nullptr || scratch == nullptr ||
      tickets == nullptr ||
      (pn != nullptr && an == nullptr) ||
      scratch_floats != kdcc_pw_bwd_plan(2, P, ci, co, pn != nullptr))
    return (int)cudaErrorInvalidValue;
  nbw::Args a{};
  a.gy = static_cast<const __nv_bfloat16*>(gy);
  a.an = static_cast<const __nv_bfloat16*>(an);
  a.ak = static_cast<const __nv_bfloat16*>(ak);
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.pn = static_cast<const float*>(pn);
  a.bnk = static_cast<const float*>(bnk);
  a.gyk = static_cast<__nv_bfloat16*>(gyk);
  a.dw = static_cast<float*>(dw);
  a.sums = static_cast<float*>(sums);
  a.scratch = static_cast<float*>(scratch);
  a.tickets = static_cast<int*>(tickets);
  a.P = P, a.ci = ci, a.co = co, a.relu = relu, a.eps = eps;
  return (int)nbw::run(a, static_cast<cudaStream_t>(stream));
}

// The depthwise backward's grid along x for a shape (its partials' first
// dimension), or -1 where the kernel does not take the shape.
int kdcc_dw_bwd_grid(int dtype, int n, int h, int w, int c, int stride, int dil) {
  DwBwdArgs a{};
  a.n = n, a.h = h, a.w = w, a.c = c, a.relu = 0;
  int grid = -1;
  if (n < 1 || h < 1 || w < 1 ||
      dw_bwd_dispatch(dtype, stride, dil, a, 0, &grid, nullptr) != cudaSuccess)
    return -1;
  return grid;
}

// 3x3 depthwise backward. gy, an (n, ho, wo, c) and ak (n, h, w, c) in
// dtype; pn (c, 6) f32; bnk (c, 4) f32 or null (the identity); k (c, 9) f32;
// gyk (n, h, w, c) in dtype; psum (grid, 2, c) and pk (grid, 9, c) f32.
// c % 8 == 0, 16-byte aligned activations; grid must be kdcc_dw_bwd_grid's.
int kdcc_dw_bwd(int dtype, const void* gy, const void* an, const void* pn, const void* ak,
                const void* bnk, const void* k, void* gyk, void* psum, void* pk, int n, int h,
                int w, int c, int stride, int dil, int relu, float eps, int grid, void* stream) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(gy) | reinterpret_cast<uintptr_t>(an) |
                         reinterpret_cast<uintptr_t>(ak) | reinterpret_cast<uintptr_t>(gyk);
  if (bits % 16 || pn == nullptr || k == nullptr || n < 1 || h < 1 || w < 1)
    return (int)cudaErrorInvalidValue;
  const DwBwdArgs a{gy, an, pn, ak, bnk, k, gyk, psum, pk, n, h, w, c, relu, eps};
  return (int)dw_bwd_dispatch(dtype, stride, dil, a, grid, nullptr,
                              static_cast<cudaStream_t>(stream));
}

}  // extern "C"

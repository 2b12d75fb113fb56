// The student's DeepLabV3+ head: the fused separable conv (ASPP branches and,
// in serving, the decoder's fuse conv) and the fused train-mode decoder head
// (sep-conv -> BN -> relu -> 1x1 classifier, forward and backward).
//
// Replaces the Pallas kernels of kd_cheap_conv_tpu/ops/pallas/:
//   _kernel via fused_separable_conv (separable.py:67, :83) -> sep_fwd_kernel<T, bf16>, no moments
//   _k_sep_fwd  (decoder.py:59, pass P1)                  -> sep_fwd_kernel<T, false>, moments
//   _k_head_fwd (decoder.py:83, pass P2)                  -> head_fwd_kernel<T>
//   _k_head_bwd (decoder.py:100, pass B1)                 -> hbw::head_bwd_kernel (bf16,
//                redesigned for the H100: below); head_bwd_kernel<float> (f32)
//   _k_sep_bwd  (decoder.py:138, pass B2)                 -> sbw::sep_bwd_kernel (bf16,
//                redesigned for the H100: below); sep_bwd_kernel<float> (f32)
//
// What they compute (activations NHWC, unpadded; the decoder's input is two
// tensors, low (c0 channels) then up (c1), never concatenated):
// - sep_fwd: t = depthwise k x k, stride 1, dilation d, pad d (k - 1) / 2, in
//   f32 from the f32 taps (k*k, Ci); y = t . pw^T (pw (Co, Ci)), f32 sums, y
//   in the activation dtype; with moments, the per-channel sum and sum of
//   squares of the f32 y (P1's batch moments of a). For bfloat16 the product
//   runs on the tensor cores. With moments (P1) t is rounded to bfloat16 for
//   it: the JAX kernel's `_mm` rounding point. Without (the separable conv)
//   the JAX kernel multiplies the f32 t, so t goes in as two bfloat16 halves,
//   hi = bf16(t) and lo = bf16(t - hi), both multiplied by pw into the same
//   f32 sums: t keeps ~16 bits, and y agrees with an f32 product to its last
//   bit's rounding.
// - head_fwd (P2): z = relu(BN(a)) with the batch moments, rounded to the
//   activation dtype; logits = z . wc^T + bc.
// - head_bwd (B1): gz = g . wc; gu = gz * [u > 0], stored; dWc = g^T z and
//   dbc = sum g; per channel sum gu and sum gu * xhat (f32, before rounding).
// - sep_bwd (B2): ga = train-BN backward of gu (pack (Cm, 6)), formed only at
//   real pixels and rounded; gt = ga . pw (f32); g_low, g_up = the flipped
//   3x3 depthwise of gt (pad 1, dilation 1); dpw = ga^T t with t the
//   depthwise of x recomputed and rounded; dk[tap][c] = sum x_tap * gt.
// The BN arithmetic is rounded as the plain versions' torch ops round it
// (common.cuh), so the relu masks agree with them bit for bit.
//
// Determinism: no float atomics. Sums and weight gradients have one fixed
// owner (a thread, or an mma fragment slot) that accumulates them in a fixed
// order across the CTA's tiles and writes them as the CTA's partial; the
// wrapper sums the partials, or, in B1's and B2's bf16 kernels, the kernel
// does, in a fixed order behind integer tickets. The grid depends on the
// shape only.
//
// What bounds them on an H100, and the design: the 1x1 products (Ci = 304,
// Cm = 256) take 2 x 256 FLOPs per activation element read, below the
// tensor cores' ~295 FLOP/byte, so the kernels are bytes-bound at the
// roofline: the depthwise output t never reaches HBM (P1, the separable
// conv), ga and gt live in shared memory (B2), and the concat of low and up
// is never built. sep_fwd is sep_conv.cuh's tile loop (shared with
// xchain_eval.cu's folded sep conv; products on mma.cuh's `WarpGemm`); the
// head kernels' products are mma.cuh's `gemm`. Both run on shared-memory
// operands staged by synchronous loads: mma.sync m16n8k16 for bfloat16,
// FMAs in the mma fragment's layout for float32 (the f32 path is for
// parity checks). B2 in bfloat16 is namespace sbw: a one-wave kernel whose
// CTAs own a 64-channel chunk of Ci each and walk spatial tiles in step
// with the other chunks' CTAs of their group, so that L2 serves each gu and
// a line to all of them after one HBM read; copies ride a TMA ring, both
// products run on wgmma, and dpw and dk are summed in the kernel (see the
// kernel). B1 in bfloat16 is namespace hbw: a one-wave kernel whose CTAs
// walk 64-pixel tiles that arrive by TMA and bulk copies in a ring, a read
// once, gu stored by TMA from the tile's slot, both products on mma.sync,
// dWc, dbc and the sums summed in the kernel (see the kernel).
//
// The C entry points launch on the caller's stream and return
// cudaGetLastError(); the Python wrapper raises if it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"
#include "sep_conv.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kSmemMax = 232448;   // an H100 CTA's shared memory
constexpr int kTP = 64;            // head_fwd, head_bwd: pixels per tile
constexpr int kMaxCm = 256;        // head kernels, sep_bwd: widest Cm (a thread per channel)
constexpr int kKP = 32;            // head kernels: classes padded (at most 32)
constexpr int kNC = 64;            // sep_bwd (f32): input channels per CTA (gridDim.y chunks)
constexpr int kTW = 14;            // sep_bwd (f32): tile columns; with the halo, 16
constexpr int kBwdRows = 2;        // sep_bwd (f32): tile rows
// CTAs along x at most (each kernel loops over its tiles with that stride):
// 8, 4, 1 and 1 per SM of an H100's 132
constexpr int kSepFwdCtas = 1056, kHeadFwdCtas = 528, kHeadBwdCtas = 132, kSepBwdCtas = 132;

static_assert(kWarps == kMmaWarps, "gemm's slot layout assumes 8 warps");

// ---------------------------------------------------------------------------
// sep_fwd: sep_conv.cuh's tile loop on one or two inputs, no bias, residual
// or activation, y in the activation dtype, with or without moments
// ---------------------------------------------------------------------------

// kSplit: t enters the product as hi + lo halves in T (the separable conv in
// bfloat16); otherwise as t rounded to T
template <typename T, bool kSplit>
__global__ void __launch_bounds__(kThreads, 2) sep_fwd_kernel(const sepconv::Args<T, T, T> a) {
  sepconv::sep_conv<T, T, T, kSplit>(a);
}

// ---------------------------------------------------------------------------
// head_fwd: tiles of kTP pixels; z staged in shared memory, the classifier
// weight once per CTA; the logits written from the fragments
// ---------------------------------------------------------------------------

template <typename T> __host__ __device__ constexpr int head_fwd_smem(int cm) {
  return (kKP + kTP) * ld_of(cm) * (int)sizeof(T) + cm * (int)sizeof(Bn);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
head_fwd_kernel(const T* __restrict__ a, const float* __restrict__ bn, const T* __restrict__ wc,
                const float* __restrict__ bc, T* __restrict__ y, int P, int cm, int nc,
                float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = ld_of(cm), ncp = (nc + 7) / 8 * 8, tid = threadIdx.x;
  T* ws = reinterpret_cast<T*>(smem);                   // [kKP][ld] wc
  T* zs = ws + kKP * ld;                                // [kTP][ld] z
  Bn* bs = reinterpret_cast<Bn*>(zs + kTP * ld);       // [cm]
  for (int i = tid; i < kKP * cm; i += kThreads) {
    const int row = i / cm, c = i - row * cm;
    ws[row * ld + c] = row < nc ? wc[row * cm + c] : from_f<T>(0.f);
  }
  for (int c = tid; c < cm; c += kThreads) bs[c] = load_bn(bn, c, eps);
  __syncthreads();
  const int ntiles = (P + kTP - 1) / kTP;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int p0 = tile * kTP, np = min(kTP, P - p0);
    for (int i = tid; i < kTP * cm; i += kThreads) {
      const int row = i / cm, c = i - row * cm;
      float z = 0.f;
      if (row < np) {
        const Bn b = bs[c];
        z = fmaxf(bn_u(bn_xh(to_f<T>(a[(size_t)(p0 + row) * cm + c]), b), b), 0.f);
      }
      zs[row * ld + c] = from_f<T>(z);
    }
    __syncthreads();
    float acc[(kTP / 16) * (kKP / 8) / kWarps][4];
    zero(acc);
    gemm<T>(acc, zs, ld, ws, ld, kTP / 16, ncp / 8, cm);
#pragma unroll
    for (int i = 0; i < (kTP / 16) * (kKP / 8) / kWarps; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int2 rc = frag_at(i, e, kTP / 16, ncp / 8);
        if (rc.x >= 0 && rc.x < np && rc.y < nc)
          y[(size_t)(p0 + rc.x) * nc + rc.y] = from_f<T>(acc[i][e] + bc[rc.y]);
      }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// head_bwd, float32 (the parity variant): tiles of kTP pixels. gz = g . wc
// (one product per tile, through shared memory to a thread per channel for
// gu and its sums); dWc = g^T z accumulates in fragments across tiles; dbc
// by a thread per class
// ---------------------------------------------------------------------------

template <typename T> __host__ __device__ constexpr int head_bwd_smem(int cm) {
  return kTP * (cm + 4) * 4 +
         (cm * ld_of(kKP) + kTP * ld_of(kKP) + (kKP + cm) * ld_of(kTP)) * (int)sizeof(T) +
         cm * (int)sizeof(Bn);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
head_bwd_kernel(const T* __restrict__ g, const T* __restrict__ a, const float* __restrict__ bn,
                const T* __restrict__ wc, T* __restrict__ gu, float* __restrict__ psum,
                float* __restrict__ pwc, float* __restrict__ pbc, int P, int cm, int nc,
                float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ldg = ld_of(kKP), ldt = ld_of(kTP);
  const int ldc = cm + 4, tid = threadIdx.x;
  float* cs = reinterpret_cast<float*>(smem);           // [kTP][ldc] gz
  T* wts = reinterpret_cast<T*>(cs + kTP * ldc);       // [cm][ldg] wc^T
  T* gs = wts + cm * ldg;                               // [kTP][ldg] g
  T* gts = gs + kTP * ldg;                              // [kKP][ldt] g^T
  T* zts = gts + kKP * ldt;                             // [cm][ldt] z^T
  Bn* bs = reinterpret_cast<Bn*>(zts + cm * ldt);      // [cm]
  for (int i = tid; i < cm * kKP; i += kThreads) {
    const int m = i / kKP, j = i - m * kKP;
    wts[m * ldg + j] = j < nc ? wc[j * cm + m] : from_f<T>(0.f);
  }
  for (int c = tid; c < cm; c += kThreads) bs[c] = load_bn(bn, c, eps);
  __syncthreads();
  constexpr int kS1 = (kTP / 16) * (kMaxCm / 8) / kWarps, kS2 = (kKP / 16) * (kMaxCm / 8) / kWarps;
  float acc2[kS2][4];  // dWc
  zero(acc2);
  float s = 0.f, q = 0.f, db = 0.f;  // channel tid: sum gu, sum gu * xhat; class tid: sum g
  const int ntiles = (P + kTP - 1) / kTP;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int p0 = tile * kTP, np = min(kTP, P - p0);
    for (int i = tid; i < kTP * kKP; i += kThreads) {
      const int row = i / kKP, j = i - row * kKP;
      const T v = (row < np && j < nc) ? g[(size_t)(p0 + row) * nc + j] : from_f<T>(0.f);
      gs[row * ldg + j] = v;
      gts[j * ldt + row] = v;
    }
    if (tid < cm) {
      const Bn b = bs[tid];
      for (int row = 0; row < kTP; ++row) {
        float z = 0.f;
        if (row < np) z = fmaxf(bn_u(bn_xh(to_f<T>(a[(size_t)(p0 + row) * cm + tid]), b), b), 0.f);
        zts[tid * ldt + row] = from_f<T>(z);
      }
    }
    __syncthreads();
    float acc1[kS1][4];
    zero(acc1);
    gemm<T>(acc1, gs, ldg, wts, ldg, kTP / 16, cm / 8, kKP);
    gemm<T>(acc2, gts, ldt, zts, ldt, kKP / 16, cm / 8, kTP);
    if (tid < nc)
      for (int row = 0; row < np; ++row) db += to_f<T>(gs[row * ldg + tid]);
#pragma unroll
    for (int i = 0; i < kS1; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int2 rc = frag_at(i, e, kTP / 16, cm / 8);
        if (rc.x >= 0) cs[rc.x * ldc + rc.y] = acc1[i][e];
      }
    __syncthreads();
    if (tid < cm) {
      const Bn b = bs[tid];
      for (int row = 0; row < np; ++row) {
        const size_t at = (size_t)(p0 + row) * cm + tid;
        const float xh = bn_xh(to_f<T>(a[at]), b);
        const float gv = cs[row * ldc + tid] * (bn_u(xh, b) > 0.f ? 1.f : 0.f);
        gu[at] = from_f<T>(gv);
        s += gv;
        q = fmaf(gv, xh, q);
      }
    }
    __syncthreads();
  }
  if (tid < cm) {
    psum[(size_t)blockIdx.x * 2 * cm + tid] = s;
    psum[((size_t)blockIdx.x * 2 + 1) * cm + tid] = q;
  }
  if (tid < nc) pbc[(size_t)blockIdx.x * nc + tid] = db;
#pragma unroll
  for (int i = 0; i < kS2; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int2 rc = frag_at(i, e, kKP / 16, cm / 8);
      if (rc.x >= 0 && rc.x < nc) pwc[((size_t)blockIdx.x * nc + rc.x) * cm + rc.y] = acc2[i][e];
    }
}

// ---------------------------------------------------------------------------
// sep_bwd, float32 (the parity variant): spatial tiles of kBwdRows x kTW
// pixels of one image, with a one-pixel halo, for one chunk of kNC input
// channels per CTA (gridDim.y). Per tile: ga on the halo (a thread per Cm
// channel), gt = ga . pw on the halo (shared memory), then a thread per
// (channel, pixel group) forms g_x, t and dk from gt and x; dpw = ga^T t
// accumulates in fragments. Synchronous staging; its CTA partials are
// summed by the wrapper.
// ---------------------------------------------------------------------------

struct BwdLayout {
  int pws, gas, gats, tts, xs, gts, dws, nbs, total;
};
template <typename T> __host__ __device__ constexpr BwdLayout sep_bwd_layout(int cm) {
  constexpr int TH = kBwdRows, HP = (TH + 2) * (kTW + 2);
  constexpr int CPP = (TH * kTW + 15) / 16 * 16, es = sizeof(T);
  BwdLayout L{};
  L.pws = 0;
  L.gas = L.pws + kNC * ld_of(cm) * es;
  L.gats = L.gas + HP * ld_of(cm) * es;
  L.tts = L.gats + cm * ld_of(CPP) * es;
  L.xs = L.tts + kNC * ld_of(CPP) * es;
  L.gts = L.xs + HP * ld_of(kNC) * es;
  L.dws = L.gts + HP * (kNC + 4) * 4;
  L.nbs = L.dws + 9 * kNC * 4;
  L.total = L.nbs + cm * (int)sizeof(BnBwd);
  return L;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
sep_bwd_kernel(const T* __restrict__ gu, const T* __restrict__ a, const T* __restrict__ x0,
               const T* __restrict__ x1, const float* __restrict__ pn,
               const float* __restrict__ dwt, const T* __restrict__ pwt, T* __restrict__ gx0,
               T* __restrict__ gx1, float* __restrict__ pdpw, float* __restrict__ pdk, int n,
               int h, int w, int c0, int c1, int cm, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int TH = kBwdRows, HW = kTW + 2, HP = (TH + 2) * HW, CP = TH * kTW;
  constexpr int CPP = (CP + 15) / 16 * 16, ldp = ld_of(CPP), ldx = ld_of(kNC);
  constexpr int ldg = kNC + 4;
  constexpr int kGroups = kThreads / kNC;
  const BwdLayout L = sep_bwd_layout<T>(cm);
  const int ldm = ld_of(cm), tid = threadIdx.x;
  T* pws = reinterpret_cast<T*>(smem + L.pws);      // [kNC][ldm] pw^T chunk
  T* gas = reinterpret_cast<T*>(smem + L.gas);      // [HP][ldm] ga, halo
  T* gats = reinterpret_cast<T*>(smem + L.gats);    // [cm][ldp] ga^T, tile
  T* tts = reinterpret_cast<T*>(smem + L.tts);      // [kNC][ldp] t^T, tile
  T* xs = reinterpret_cast<T*>(smem + L.xs);        // [HP][ldx] x chunk, halo
  float* gts = reinterpret_cast<float*>(smem + L.gts);  // [HP][ldg] gt, halo
  float* dws = reinterpret_cast<float*>(smem + L.dws);  // [9][kNC]
  BnBwd* nbs = reinterpret_cast<BnBwd*>(smem + L.nbs);  // [cm]
  const int ci = c0 + c1, cb = blockIdx.y * kNC, ncv = min(kNC, ci - cb);
  for (int i = tid; i < kNC * cm; i += kThreads) {
    const int row = i / cm, o = i - row * cm;
    pws[row * ldm + o] = row < ncv ? pwt[(size_t)(cb + row) * cm + o] : from_f<T>(0.f);
  }
  for (int i = tid; i < 9 * kNC; i += kThreads) {
    const int c = i % kNC;
    dws[i] = c < ncv ? dwt[(i / kNC) * ci + cb + c] : 0.f;
  }
  for (int o = tid; o < cm; o += kThreads) nbs[o] = load_bn_bwd(pn, o, eps);
  // the padding columns of ga^T and t^T stay zero
  for (int i = tid; i < cm * ldp; i += kThreads) gats[i] = from_f<T>(0.f);
  for (int i = tid; i < kNC * ldp; i += kThreads) tts[i] = from_f<T>(0.f);
  __syncthreads();

  const int c = tid % kNC, grp = tid / kNC;   // this thread's channel and pixel group
  float dk[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) dk[t] = 0.f;
  constexpr int kSW = (kMaxCm / 16) * (kNC / 8) / kWarps, kSG = (HP / 16) * (kNC / 8) / kWarps;
  float accw[kSW][4];  // dpw
  zero(accw);
  const int tiles_y = (h + TH - 1) / TH, tiles_x = (w + kTW - 1) / kTW;
  const int ntiles = n * tiles_y * tiles_x;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int img = tile / (tiles_y * tiles_x), rem = tile - img * tiles_y * tiles_x;
    const int ty0 = (rem / tiles_x) * TH, tx0 = (rem % tiles_x) * kTW;
    // ga on the halo, zero outside the image, 8 channels per access; a
    // warp takes 16 pixels x 2 channel groups (32-byte global sectors), so
    // that its transposed stores into ga^T fall on distinct banks
    const int g8 = cm / 8;
#pragma unroll 2
    for (int i = tid; i < HP * g8; i += kThreads) {
      const int hp = (i >> 1) % HP, o = 8 * (2 * ((i >> 1) / HP) + (i & 1));
      const int hy = hp / HW, hx = hp - hy * HW;
      const int yy = ty0 - 1 + hy, xx = tx0 - 1 + hx;
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (yy >= 0 && yy < h && xx >= 0 && xx < w) {
        const size_t at = ((size_t)(img * h + yy) * w + xx) * cm + o;
        float gv[8], av[8];
        load8<T>(gu + at, gv);
        load8<T>(a + at, av);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = rounded<T>(bn_bwd(gv[e], av[e], nbs[o + e]));
      }
      store8<T>(gas + hp * ldm + o, v);
      if (hy >= 1 && hy <= TH && hx >= 1 && hx <= kTW) {
        const int pc = (hy - 1) * kTW + hx - 1;
#pragma unroll
        for (int e = 0; e < 8; ++e) gats[(o + e) * ldp + pc] = from_f<T>(v[e]);
      }
    }
    // this chunk's x on the halo, zero outside the image and beyond Ci
#pragma unroll 2
    for (int i = tid; i < HP * (kNC / 8); i += kThreads) {
      const int hp = i / (kNC / 8), j = 8 * (i % (kNC / 8)), hy = hp / HW, hx = hp - hy * HW;
      const int yy = ty0 - 1 + hy, xx = tx0 - 1 + hx, cx = cb + j;
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (yy >= 0 && yy < h && xx >= 0 && xx < w && j < ncv) {
        const size_t px = (size_t)(img * h + yy) * w + xx;
        load8<T>(cx < c0 ? x0 + px * c0 + cx : x1 + px * c1 + (cx - c0), v);
      }
      store8<T>(xs + hp * ldx + j, v);
    }
    __syncthreads();
    {
      float acc[kSG][4];
      zero(acc);
      gemm<T>(acc, gas, ldm, pws, ldm, HP / 16, kNC / 8, cm);
#pragma unroll
      for (int i = 0; i < kSG; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int2 rc = frag_at(i, e, HP / 16, kNC / 8);
          if (rc.x >= 0) gts[rc.x * ldg + rc.y] = acc[i][e];
        }
    }
    __syncthreads();
    // g_x (flipped taps of gt), t (taps of x) and dk, channel c
    const int cg = cb + c;
    const bool low = cg < c0;
    const int st = low ? c0 : c1, cc = low ? cg : cg - c0;
    T* dst = low ? gx0 : gx1;
    for (int pc = grp; pc < CP; pc += kGroups) {
      const int py = pc / kTW, px = pc - py * kTW, yy = ty0 + py, xx = tx0 + px;
      float t = 0.f;
      if (yy < h && xx < w && c < ncv) {
        const float gtc = gts[((py + 1) * HW + px + 1) * ldg + c];
        float gx = 0.f;
#pragma unroll
        for (int dh = 0; dh < 3; ++dh)
#pragma unroll
          for (int dw = 0; dw < 3; ++dw) {
            const float kv = dws[(dh * 3 + dw) * kNC + c];
            gx = fmaf(kv, gts[((py + 2 - dh) * HW + px + 2 - dw) * ldg + c], gx);
            const float xv = to_f<T>(xs[((py + dh) * HW + px + dw) * ldx + c]);
            t = fmaf(kv, xv, t);
            dk[dh * 3 + dw] = fmaf(xv, gtc, dk[dh * 3 + dw]);
          }
        dst[((size_t)(img * h + yy) * w + xx) * st + cc] = from_f<T>(gx);
      }
      tts[c * ldp + pc] = from_f<T>(t);
    }
    __syncthreads();
    gemm<T>(accw, gats, ldp, tts, ldp, cm / 16, kNC / 8, CPP);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kSW; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int2 rc = frag_at(i, e, cm / 16, kNC / 8);
      if (rc.x >= 0 && rc.y < ncv)
        pdpw[((size_t)blockIdx.x * cm + rc.x) * ci + cb + rc.y] = accw[i][e];
    }
  // dk: the pixel groups' sums in group order (gt's buffer is free now)
  float* red = gts;
#pragma unroll
  for (int t = 0; t < 9; ++t) red[(grp * 9 + t) * kNC + c] = dk[t];
  __syncthreads();
  if (tid < ncv)
    for (int t = 0; t < 9; ++t) {
      float v = 0.f;
      for (int gi = 0; gi < kGroups; ++gi) v += red[(gi * 9 + t) * kNC + tid];
      pdk[((size_t)blockIdx.x * 9 + t) * ci + cb + tid] = v;
    }
}

// ---------------------------------------------------------------------------
// sep_bwd, bfloat16 (namespace sbw): one launch on one wave. What bounds it:
// its bytes on paper (gu, a, x read and g_x written once: 0.18 ms at config
// #2), but a tile's g_x needs gt = ga . pw on the tile's one-pixel halo, and
// dpw (Cm x Ci f32) cannot stay in one CTA's registers, so a CTA owns a
// chunk of kNC input channels (pw's chunk resident, dpw's chunk in wgmma
// accumulators across its tiles), and every chunk needs all of ga on every
// halo. The chunks' CTAs of one group (blockIdx.x / chunks) walk the same
// tiles in the same order, together, so that L2 serves a tile's gu and a
// to all of them after one HBM read; each forms ga itself. Measured on the
// H100 (PERF.md), the time goes to the CUDA cores' share (issuing copies,
// forming ga, the depthwise taps), not to bytes: the copies of gu and a are
// TMA boxes issued by one thread (zero outside the image), so no other
// thread spends instructions on them. A thread block cluster of the chunks'
// CTAs that shared ga through distributed shared memory measured slower:
// fewer clusters of 5 than 132 / 5 fit the card at once, and pulling ga
// from the other CTAs cost about what forming it does.
// Per tile of kTH x kTW outputs (halo kHP = 8 x 16 = 128 pixels):
//   stages    gu and a on the halo, kSR rows (two image rows) a box, by TMA
//             into a ring of 2..4 slots (an mbarrier each): the next tile's
//             first stages land while this one is computed; x's chunk on the
//             halo by 16-byte cp.async copies into its own buffer
//   prologue  ga = rounded(bn_bwd(gu, a)) at real pixels (zero elsewhere),
//             bf16, into four 64-channel boxes [pixel][64], 128-byte
//             swizzled: wgmma's canonical layout, K-major for gt and
//             MN-major (the transpose immediate) for dpw
//   gt^T      = pw^T . ga^T on wgmma (m64 n32 per warpgroup, K = 256; pw's
//             chunk stored as pw is, MN-major), in two halves of K, each
//             issued before a strip of
//   t         = the depthwise of x on the tile (f32 taps, f32 sums) rounded
//             to bf16 on the CUDA cores, into [pixel][64] swizzled, its halo
//             rows zero
//   dpw       += ga^T . t on wgmma (m64 n64 per warpgroup, K = the 128 halo
//             pixels, t zero on the halo's border), accumulated in registers
//   gt        f32 over ga's space; then a thread per (channel, pixel group)
//             forms g_x = the flipped taps of gt (rounded once) and dk +=
//             x_tap . gt from shared memory, dk in registers. A pixel group
//             takes half an output row (7 outputs) and a piece of 3 or 4 of
//             the last two rows: 11 outputs at most, where whole strips of 7
//             would give half the groups 14 and the other half 7
// At the end each CTA leaves dpw's and dk's chunk as a partial, summed in
// the kernel per chunk in a fixed order over two levels of integer tickets;
// the last adder writes dpw (Cm, Ci) and dk (Ci, 9) as autograd returns
// them. ops/decoder.py sep_bwd_plan mirrors plan().
// ---------------------------------------------------------------------------

namespace sbw {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 512;                        // 4 warpgroups
constexpr int kTH = 6, kTW = 14;                     // a tile's output rows and columns
constexpr int kHW = kTW + 2, kHP = (kTH + 2) * kHW;  // its halo: 8 x 16 = 128 pixels
constexpr int kNC = 64;                              // input channels of a chunk
constexpr int kBox = kHP * 128;                      // a 64-channel box of the halo, 16 KB
constexpr int kSR = 2 * kHW;                         // halo rows of a ring stage (a TMA box)
constexpr int kStages = kHP / kSR;                   // ring stages of a tile
constexpr int kStrip = 7;                            // outputs of a depthwise thread item, at most
constexpr int kPG = kThreads / kNC;                  // threads of a channel (pixel groups)
constexpr int kLdg = kNC + 4;                        // row stride (floats) of gt
constexpr int kCtas = 132;                           // one wave on an H100, fixed so that the
                                                     // plan depends on the shape alone
constexpr int kGroup = 8, kMaxGroups = (kCtas + kGroup - 1) / kGroup;
constexpr int kMaxRing = 4;
constexpr int kSmemMax = 232448;
// shared memory, bytes from a 1024-byte aligned base
constexpr int kPwOff = 0;                            // pw's chunk [kMaxCm][64], swizzled
constexpr int kGaOff = kPwOff + kMaxCm * 128;        // ga [4][kHP][64], swizzled; then gt
                                                     // f32 [kHP][kLdg]; at the end dk's sum
constexpr int kTOff = kGaOff + 4 * kBox;             // t [kHP][64], swizzled
constexpr int kXOff = kTOff + kBox;                  // x's chunk [kHP][kNC]
constexpr int kRingOff = kXOff + kHP * kNC * 2;      // the ring of gu and a stages
static_assert(kHP == 128 && kThreads == 4 * 128 && kMaxCm == 4 * 64, "the warpgroups' tiles");
static_assert(kHP * kLdg * 4 <= 4 * kBox && kPG * 9 * kNC * 4 <= 4 * kBox, "gt, dk in ga's space");
static_assert(kThreads / 64 == 8 && kSR % 8 == 0, "the prologue: 64 channel quads x 8 rows");
static_assert(kPG == 8 && kTH == 6 && kTW == 2 * kStrip, "the depthwise's strips and pieces");

struct Plan {
  int chunks, gx, grid, groups;   // gx: groups of CTAs (a CTA per chunk) along the tiles
  int stage, stages, smem, v;     // v: floats of a partial (dpw's chunk, then dk's)
};
__host__ __device__ inline bool plan(Plan& p, int n, int h, int w, int ci, int cm) {
  p.chunks = (ci + kNC - 1) / kNC;
  const long long tiles = (long long)n * ((h + kTH - 1) / kTH) * ((w + kTW - 1) / kTW);
  const long long per = kCtas / p.chunks;
  p.gx = (int)(tiles < per ? tiles : per);
  p.grid = p.gx * p.chunks;
  p.groups = (p.gx + kGroup - 1) / kGroup;
  p.stage = kSR * cm * 4;   // gu and a, bf16
  const int st = (kSmemMax - 1024 - kRingOff - 8 * kMaxRing - 16) / p.stage;
  p.stages = st < kMaxRing ? st : kMaxRing;
  p.smem = 1024 + kRingOff + p.stages * p.stage + 8 * kMaxRing + 16;
  p.v = (cm + 9) * kNC;
  return p.gx >= 1 && p.stages >= 2;
}

struct Args {
  const bf16 *x0, *x1, *pw;            // x0, x1 (n, h, w, c0), (.., c1) or null; pw (cm, c0 + c1)
  const float *pn, *k;                 // pn (cm, 6); k (c0 + c1, 9)
  bf16 *gx0, *gx1;                     // like x0, x1
  float *dpw, *dk;                     // (cm, c0 + c1), (c0 + c1, 9)
  float* scratch;                      // (grid + chunks groups, v): the CTAs' and groups' sums
  int* tickets;                        // (chunks, groups + 1): zero between launches
  int n, h, w, c0, c1, cm;
  float eps;
};

// byte offset of 16-byte unit u (0..7) of row r in a 128-byte-swizzled box
__device__ __forceinline__ int sw(int r, int u) { return r * 128 + ((u ^ (r & 7)) << 4); }

// two bf16 (the lower channel in the low half) from and to f32, exactly
__device__ __forceinline__ float bf_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// t on a strip of L outputs of output row r from column x0w of the tile
// (x rows r .. r + 2 of the halo), zero outside the image
template <int L>
__device__ __forceinline__ void t_strip(const bf16* xs, unsigned char* tsb, const float (&kv)[9],
                                        int c, int r, int x0w, int yl, int xl) {
  float tv[L];
#pragma unroll
  for (int o = 0; o < L; ++o) tv[o] = 0.f;
#pragma unroll
  for (int dh = 0; dh < 3; ++dh) {
    float xv[L + 2];
#pragma unroll
    for (int jj = 0; jj < L + 2; ++jj) xv[jj] = __bfloat162float(xs[((r + dh) * kHW + x0w + jj) * kNC + c]);
#pragma unroll
    for (int dw = 0; dw < 3; ++dw)
#pragma unroll
      for (int o = 0; o < L; ++o) tv[o] = fmaf(kv[dh * 3 + dw], xv[o + dw], tv[o]);
  }
#pragma unroll
  for (int o = 0; o < L; ++o) {
    const int hr = (r + 1) * kHW + x0w + 1 + o;
    *reinterpret_cast<bf16*>(tsb + sw(hr, c >> 3) + (c & 7) * 2) =
        __float2bfloat16_rn(r < yl && x0w + o < xl ? tv[o] : 0.f);
  }
}

// on the same strip: g_x = the flipped taps of gt (stored where real), and
// dk += x_tap . gt
template <int L>
__device__ __forceinline__ void c_strip(const bf16* xs, const float* gp, const float (&kv)[9],
                                        float (&dk)[9], int r, int x0w, int yl, int xl,
                                        bf16* out, size_t row_stride, size_t px_stride) {
  float gc[L], gx[L];
#pragma unroll
  for (int o = 0; o < L; ++o) {
    gc[o] = gp[((r + 1) * kHW + x0w + 1 + o) * kLdg];
    gx[o] = 0.f;
  }
#pragma unroll
  for (int dh = 0; dh < 3; ++dh) {
    float xv[L + 2], gv[L + 2];
#pragma unroll
    for (int jj = 0; jj < L + 2; ++jj) {
      xv[jj] = __bfloat162float(xs[((r + dh) * kHW + x0w + jj) * kNC]);
      gv[jj] = gp[((r + 2 - dh) * kHW + x0w + jj) * kLdg];
    }
#pragma unroll
    for (int dw = 0; dw < 3; ++dw)
#pragma unroll
      for (int o = 0; o < L; ++o) {
        gx[o] = fmaf(kv[dh * 3 + dw], gv[o + 2 - dw], gx[o]);
        dk[dh * 3 + dw] = fmaf(xv[o + dw], gc[o], dk[dh * 3 + dw]);
      }
  }
  if (out != nullptr && r < yl)
#pragma unroll
    for (int o = 0; o < L; ++o)
      if (x0w + o < xl) out[r * row_stride + (x0w + o) * px_stride] = __float2bfloat16_rn(gx[o]);
}

// gu, a (n, h, w, cm): 4-D tensor maps read in boxes of (cm, kHW, 2, 1)
__global__ void __launch_bounds__(kThreads, 1)
sep_bwd_kernel(const __grid_constant__ CUtensorMap map_gu, const __grid_constant__ CUtensorMap map_a,
               const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int cm = a.cm, c0 = a.c0, ci = c0 + a.c1, h = a.h, w = a.w;
  Plan pl;
  plan(pl, a.n, h, w, ci, cm);
  const int S = pl.stages, chunks = pl.chunks;
  const int chunk = blockIdx.x % chunks, gi = blockIdx.x / chunks;
  const int cb = chunk * kNC, ncv = min(kNC, ci - cb);
  unsigned char* pws = base + kPwOff;
  unsigned char* gab = base + kGaOff;
  float* gts = reinterpret_cast<float*>(base + kGaOff);
  unsigned char* tsb = base + kTOff;
  bf16* xs = reinterpret_cast<bf16*>(base + kXOff);
  unsigned char* ring = base + kRingOff;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * pl.stage);   // [kMaxRing]
  int* flag = reinterpret_cast<int*>(full + kMaxRing);
  const int tid = threadIdx.x, wg = tid / 128, t128 = tid % 128;
  const int tiles_x = (w + kTW - 1) / kTW, tiles_img = ((h + kTH - 1) / kTH) * tiles_x;
  const int ntiles = a.n * tiles_img;
  const int mine = (ntiles - gi + pl.gx - 1) / pl.gx;   // this CTA's tiles (gi < ntiles)
  auto origin = [&](int it, int& img, int& ty0, int& tx0) {
    const int tile = gi + it * pl.gx;
    img = tile / tiles_img;
    const int r = tile - img * tiles_img;
    ty0 = (r / tiles_x) * kTH;
    tx0 = (r % tiles_x) * kTW;
  };
  auto inside = [&](int yy, int xx) { return yy >= 0 && yy < h && xx >= 0 && xx < w; };

  // t zero (its halo rows stay zero: dpw sums over the halo), pw's chunk
  // (rows past cm and channels past the chunk zero), the ring's barriers
  for (int i = tid; i < kBox / 16; i += kThreads)
    reinterpret_cast<uint4*>(tsb)[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < kMaxCm * 8; i += kThreads) {
    const int r = i >> 3, u = i & 7;
    if (r < cm && 8 * u < ncv) hop::cp_async16(pws + sw(r, u), a.pw + (size_t)r * ci + cb + 8 * u);
    else hop::cp_async16_zfill(pws + sw(r, u), a.pw, 0);
  }
  hop::cp_async_commit();
  if (tid == 0) {
    for (int s = 0; s < S; ++s) hop::mbar_init(&full[s], 1);
    hop::mbar_init_fence();
  }
  __syncthreads();

  // the ring's producer, one thread of the last warp (its warps have the
  // lighter share of the depthwise phases): stage j (gu then a, [kSR
  // rows][cm]) is stage j % kStages of this CTA's tile j / kStages, in slot
  // j % S. fill(done) issues every stage up to done + S - 1, `done` stages
  // being consumed by every thread (a barrier after their last reads)
  const bool producer = tid == kThreads - 32;
  const int nstages = mine * kStages;
  int issued = 0;
  auto fill = [&](int done) {
    for (; issued < nstages && issued < done + S; ++issued) {
      const int j = issued, s = j % kStages;
      unsigned char* dst = ring + (j % S) * pl.stage;
      int img, ty0, tx0;
      origin(j / kStages, img, ty0, tx0);
      hop::mbar_expect_tx(&full[j % S], pl.stage);
      hop::tma_load_4d(dst, &map_gu, 0, tx0 - 1, ty0 - 1 + 2 * s, img, &full[j % S]);
      hop::tma_load_4d(dst + pl.stage / 2, &map_a, 0, tx0 - 1, ty0 - 1 + 2 * s, img, &full[j % S]);
    }
  };
  if (producer) {
    hop::tma_prefetch_map(&map_gu);
    hop::tma_prefetch_map(&map_a);
    fill(0);
  }
  // x's chunk on tile it's halo, zero outside the image and past Ci
  auto load_x = [&](int it) {
    int img, ty0, tx0;
    origin(it, img, ty0, tx0);
    for (int i = tid; i < kHP * (kNC / 8); i += kThreads) {
      const int hr = i >> 3, u = i & 7, cx = cb + 8 * u;
      const int yy = ty0 - 1 + hr / kHW, xx = tx0 - 1 + hr % kHW;
      bf16* d = xs + hr * kNC + 8 * u;
      if (inside(yy, xx) && 8 * u < ncv) {
        const size_t px = (size_t)(img * h + yy) * w + xx;
        hop::cp_async16(d, cx < c0 ? a.x0 + px * c0 + cx : a.x1 + px * a.c1 + (cx - c0));
      } else {
        hop::cp_async16_zfill(d, a.x0, 0);
      }
    }
    hop::cp_async_commit();
  };

  // the prologue's fixed Cm channels 4 q .. 4 q + 3 (rows rr, rr + 8, .. of
  // a stage), their BN-backward constants in registers; the depthwise's
  // channel c of the chunk (pixel group pg), its taps in registers, dk its
  // sums over its outputs
  const int q = tid % 64, rr = tid / 64, c = tid % kNC, pg = tid / kNC, cg = cb + c;
  const bool qok = 4 * q < cm, cok = c < ncv;
  BnBwd nb[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) nb[e] = qok ? load_bn_bwd(a.pn, 4 * q + e, a.eps) : BnBwd{0.f, 0.f, 0.f, 0.f, 0.f};
  const int gbox = (q >> 4) * kBox, gunit = (q & 15) >> 1, ghalf = (q & 1) * 8;
  float kv[9], dk[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) kv[i] = cok ? a.k[(size_t)cg * 9 + i] : 0.f, dk[i] = 0.f;
  float dacc[32];   // dpw rows 64 wg .., this chunk's 64 columns
#pragma unroll
  for (int i = 0; i < 32; ++i) dacc[i] = 0.f;

  // the depthwise's strips of pixel group pg: half of output row pg / 2 (7
  // outputs), and piece pg of rows 4 and 5 (4, 3, 4, 3 outputs a row)
  const int pr1 = 4 + (pg >> 2), pc1 = kStrip * ((pg >> 1) & 1) + 4 * (pg & 1);

  int j = 0;
  for (int it = 0; it < mine; ++it) {
    int img, ty0, tx0;
    origin(it, img, ty0, tx0);
    __syncthreads();   // the last tile's depthwise has read gt (ga's space) and x
    load_x(it);
    for (int s = 0; s < kStages; ++s, ++j) {
      if (s == 1 && S < kStages) {   // stage j - 1 is read: refill its slot
        __syncthreads();
        if (producer) fill(j);
      }
      hop::mbar_wait(&full[j % S], (j / S) & 1);
      const unsigned char* st = ring + (j % S) * pl.stage;
      uint2 gv[kSR / 8], av[kSR / 8];
      if (qok)
#pragma unroll
        for (int i = 0; i < kSR / 8; ++i) {
          gv[i] = *reinterpret_cast<const uint2*>(st + (rr + 8 * i) * cm * 2 + 8 * q);
          av[i] = *reinterpret_cast<const uint2*>(st + pl.stage / 2 + (rr + 8 * i) * cm * 2 + 8 * q);
        }
#pragma unroll
      for (int i = 0; i < kSR / 8; ++i) {
        const int hr = kSR * s + rr + 8 * i;
        uint2 pk = make_uint2(0u, 0u);
        if (qok && inside(ty0 - 1 + hr / kHW, tx0 - 1 + hr % kHW)) {
          pk.x = pack_bf16(bn_bwd(bf_lo(gv[i].x), bf_lo(av[i].x), nb[0]),
                           bn_bwd(bf_hi(gv[i].x), bf_hi(av[i].x), nb[1]));
          pk.y = pack_bf16(bn_bwd(bf_lo(gv[i].y), bf_lo(av[i].y), nb[2]),
                           bn_bwd(bf_hi(gv[i].y), bf_hi(av[i].y), nb[3]));
        }
        *reinterpret_cast<uint2*>(gab + gbox + sw(hr, gunit) + ghalf) = pk;
      }
    }
    hop::cp_async_wait<0>();   // x's chunk (and, the first time, pw's)
    hop::fence_proxy_async();
    __syncthreads();           // ga formed; the tile's stages are read

    // gt^T (64 channels x the 32 pixels 32 wg ..) = pw^T . ga^T, K = 256,
    // in two halves of K around the strips of t on the CUDA cores
    float gacc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) gacc[i] = 0.f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      hop::fence_regs(gacc);
      hop::wgmma_fence();
#pragma unroll
      for (int kk = half * kMaxCm / 32; kk < (half + 1) * kMaxCm / 32; ++kk)
        hop::wgmma_m64n32k16<1, 0>(
            gacc, hop::desc_sw128_mn(pws + kk * 2048, kMaxCm * 128),
            hop::desc_sw128(gab + (kk >> 2) * kBox + wg * 32 * 128 + (kk & 3) * 32), 1);
      hop::wgmma_commit();
      hop::fence_regs(gacc);
      if (half == 0 && producer) fill(j);   // the next tile's first stages land meanwhile
      // meanwhile t on the pixel group's strip, then its piece
      if (half == 0) t_strip<kStrip>(xs, tsb, kv, c, pg >> 1, kStrip * (pg & 1), h - ty0, w - tx0);
      else if (pg & 1) t_strip<3>(xs, tsb, kv, c, pr1, pc1, h - ty0, w - tx0);
      else t_strip<4>(xs, tsb, kv, c, pr1, pc1, h - ty0, w - tx0);
    }
    hop::fence_proxy_async();
    __syncthreads();   // t formed

    // dpw (Cm rows 64 wg .., 64 columns) += ga^T . t, K = the halo's pixels
    hop::fence_regs(dacc);
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kHP / 16; ++kk)
      hop::wgmma<64, 1, 1>(dacc, hop::desc_sw128_mn(gab + wg * kBox + kk * 2048, kBox),
                           hop::desc_sw128_mn(tsb + kk * 2048, kBox), 1);
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(gacc);
    hop::fence_regs(dacc);
    __syncthreads();   // both products have read ga: gt goes over it

    // gt (f32) to [pixel][kLdg]
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int ch = 16 * (t128 / 32) + (t128 % 32) / 4 + 8 * ((i / 2) % 2);
      const int px = 32 * wg + 8 * (i / 4) + 2 * (t128 % 4) + (i % 2);
      gts[px * kLdg + ch] = gacc[i];
    }
    __syncthreads();

    // g_x = the flipped taps of gt; dk += x_tap . gt
    {
      bf16* out = nullptr;
      size_t rs = 0, ps = 0;
      if (cok) {
        const size_t px0 = (size_t)(img * h + ty0) * w + tx0;
        out = cg < c0 ? a.gx0 + px0 * c0 + cg : a.gx1 + px0 * a.c1 + (cg - c0);
        ps = cg < c0 ? (size_t)c0 : (size_t)a.c1;
        rs = ps * w;
      }
      c_strip<kStrip>(xs + c, gts + c, kv, dk, pg >> 1, kStrip * (pg & 1), h - ty0, w - tx0, out, rs, ps);
      if (pg & 1) c_strip<3>(xs + c, gts + c, kv, dk, pr1, pc1, h - ty0, w - tx0, out, rs, ps);
      else c_strip<4>(xs + c, gts + c, kv, dk, pr1, pc1, h - ty0, w - tx0, out, rs, ps);
    }
  }
  __syncthreads();

  // this CTA's partial: dpw's chunk from the fragments, then dk, its pixel
  // groups summed in group order (ga's space is free now)
  float* part = a.scratch + (size_t)blockIdx.x * pl.v;
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int row = 64 * wg + 16 * (t128 / 32) + (t128 % 32) / 4 + 8 * ((i / 2) % 2);
    const int col = 8 * (i / 4) + 2 * (t128 % 4);
    if (row < cm) __stcg(reinterpret_cast<float2*>(part + row * kNC + col), make_float2(dacc[i], dacc[i + 1]));
  }
  float* red = reinterpret_cast<float*>(gab);   // [kPG][9][kNC]
#pragma unroll
  for (int i = 0; i < 9; ++i) red[(pg * 9 + i) * kNC + c] = dk[i];
  __syncthreads();
  for (int e = tid; e < 9 * kNC; e += kThreads) {
    float v = red[e];
#pragma unroll
    for (int p = 1; p < kPG; ++p) v += red[p * 9 * kNC + e];
    __stcg(part + cm * kNC + e, v);
  }

  // the chunk's sum over its CTAs, in a fixed order: the last CTA of each
  // group of kGroup adds the group's partials in CTA order; with more than
  // one group the last group's adder adds the groups' sums in group order
  // and writes dpw and dk. Who adds depends on timing, the order does not.
  const int groups = pl.groups, grp = gi / kGroup, g0 = grp * kGroup;
  const int g1 = min(pl.gx, g0 + kGroup), v4 = pl.v / 4;
  int* tk = a.tickets + chunk * (groups + 1);
  auto out = [&](int e4, float4 val) {
    const int e = 4 * e4;
    if (e < cm * kNC) {
      const int row = e / kNC, col = e % kNC;
      if (col < ncv) *reinterpret_cast<float4*>(a.dpw + (size_t)row * ci + cb + col) = val;
    } else {
      const int f = e - cm * kNC, tap = f / kNC, col = f % kNC;
      const float vv[4] = {val.x, val.y, val.z, val.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (col + i < ncv) a.dk[(size_t)(cb + col + i) * 9 + tap] = vv[i];
    }
  };
  __threadfence();
  __syncthreads();
  if (tid == 0) *flag = atomicAdd(&tk[grp], 1) == g1 - g0 - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  const float4* parts = reinterpret_cast<const float4*>(a.scratch) + (size_t)(chunk + g0 * chunks) * v4;
  float4* gsum = reinterpret_cast<float4*>(a.scratch) + (size_t)(pl.grid + chunk * groups + grp) * v4;
  for (int e4 = tid; e4 < v4; e4 += kThreads) {
    const float4 s = ordered_sum4_cg<kGroup>(parts + e4, g1 - g0, (size_t)chunks * v4);
    if (groups == 1) out(e4, s);
    else __stcg(gsum + e4, s);
  }
  if (tid == 0) tk[grp] = 0;
  if (groups == 1) return;
  __threadfence();
  __syncthreads();
  if (tid == 0) *flag = atomicAdd(&tk[groups], 1) == groups - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  const float4* gs = reinterpret_cast<const float4*>(a.scratch) + (size_t)(pl.grid + chunk * groups) * v4;
  for (int e4 = tid; e4 < v4; e4 += kThreads) out(e4, ordered_sum4_cg<kMaxGroups>(gs + e4, groups, v4));
  if (tid == 0) tk[groups] = 0;
}

// a tensor map of gu or a, encoded once per (address, shape): the caching
// allocator hands them the same addresses step after step, and encoding two
// maps a launch would be host time
inline bool act_map(CUtensorMap* map, const void* base, int n, int h, int w, int cm) {
  constexpr int kEntries = 32;
  struct Entry {
    const void* base;
    int n, h, w, cm;
    CUtensorMap map;
  };
  static Entry table[kEntries];
  static int used = 0, next = 0;
  for (int i = 0; i < used; ++i) {
    const Entry& e = table[i];
    if (e.base == base && e.n == n && e.h == h && e.w == w && e.cm == cm) {
      *map = e.map;
      return true;
    }
  }
  const cuuint64_t dims[4] = {(cuuint64_t)cm, (cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)n};
  const cuuint64_t strides[3] = {(cuuint64_t)cm * 2, (cuuint64_t)w * cm * 2,
                                 (cuuint64_t)h * w * cm * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cm, (cuuint32_t)kHW, 2, 1};
  if (!hop::map_bf16(map, base, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE)) return false;
  table[next] = Entry{base, n, h, w, cm, *map};
  next = (next + 1) % kEntries;
  if (used < kEntries) ++used;
  return true;
}

cudaError_t run(const void* gu, const void* ga, const Args& a, cudaStream_t st) {
  Plan p;
  CUtensorMap mg, ma;
  if (!plan(p, a.n, a.h, a.w, a.c0 + a.c1, a.cm) ||
      ctas_per_sm<sep_bwd_kernel>(kThreads, p.smem) < 1 ||
      !act_map(&mg, gu, a.n, a.h, a.w, a.cm) || !act_map(&ma, ga, a.n, a.h, a.w, a.cm))
    return cudaErrorInvalidValue;
  sep_bwd_kernel<<<p.grid, kThreads, p.smem, st>>>(mg, ma, a);
  return cudaGetLastError();
}

}  // namespace sbw

// ---------------------------------------------------------------------------
// head_bwd, bfloat16 (namespace hbw): one launch on one wave. What bounds it:
// its bytes, a read and gu written once (136 MB each at config #2) and g
// read once (11 MB), 0.085 ms; its products, 4 x 32 x Cm FLOPs a pixel with
// the classes padded to 32, take a tenth of that on the tensor cores.
// Persistent CTAs (one an SM, at most kCtas, so that the split depends on
// the shape alone) walk tiles of kTP pixels: CTA b the tiles b, b + grid,
// .. A tile's a is one contiguous run of kTP x Cm bf16 and arrives as Cm /
// 64 TMA boxes (64 pixels x 64 channels, 128-byte swizzled), its g (kTP x
// nc bf16, contiguous) as one bulk copy, both issued by one thread on the
// slot's mbarrier into a ring of 3 or 4 slots. Per tile:
//   g         into [kTP][kLdg] (its classes past nc stay zero; two such
//             buffers, one per tile in turn), and each thread's share of
//             dbc
//   gz        = g . wc on mma.sync (K = 32: nc padded), ldmatrix fragments;
//             a warp owns two 8-channel blocks of all 64 pixels
//   epilogue  per pair of a in the fragment's layout, u and xhat once:
//             gu = gz [u > 0] over a in the slot (an element has one
//             owner), z = rounded(relu(u)) into boxes laid out as a's, the
//             sums of gu and gu xhat per thread and channel
//   dWc       += g^T z on mma.sync (M = 32 classes, K = the tile's
//             pixels), g^T and z by ldmatrix.trans, dWc in registers; a
//             warp reads only the z it wrote
//   store     the slot's boxes, now gu, by TMA from the same thread; the
//             slot is refilled a tile later, once that store has read it
// Two barriers a tile. The swizzle puts a fragment's 8 rows on 8 bank
// groups: the epilogue's reads and writes and z's ldmatrix are free of
// bank conflicts. Measured on the H100 (PERF.md), the ring's waits are a
// small share of a tile: the per-element BN work, not bytes, sets the
// pace, which is why u and xhat are formed once per element. At the end each
// CTA leaves dWc, the sums and dbc as one partial, summed in the kernel in
// a fixed order over two levels of integer tickets; the last adder writes
// dWc (nc, Cm), the sums (Cm, 2) and dbc (nc,), the layouts the backward
// consumes. ops/decoder.py head_bwd_plan mirrors plan().
// ---------------------------------------------------------------------------

namespace hbw {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 512, kWarps = kThreads / 32;
constexpr int kTP = 64;                          // pixels of a tile
constexpr int kBox = kTP * 128;                  // a tile's 64-channel box, 8 KB
constexpr int kLdg = kKP + 8;                    // g's row stride (elements): 80 bytes
constexpr int kCtas = 132;                       // one wave on an H100
constexpr int kGroup = 12, kMaxGroups = (kCtas + kGroup - 1) / kGroup;
constexpr int kMaxStages = 4, kMinStages = 3;
static_assert(kTP == 64 && kWarps == 16 && kKP == 32 && kMaxCm <= 2 * 16 * 8,
              "the warps' sub-tiles: all 4 pixel blocks, 8-channel blocks w and w + 16");

struct Plan {
  int nb;                                   // 64-channel boxes of a tile
  int slot;                                 // bytes of a ring slot: the boxes, then g
  int stages, smem, tiles, grid, groups, v;   // v: floats of a partial
};
__host__ __device__ inline Plan plan(int P, int cm, int nc) {
  Plan p;
  p.nb = (cm + 63) / 64;
  p.slot = p.nb * kBox + (kTP * nc * 2 + 1023) / 1024 * 1024;
  const int fixed = 1024 + p.nb * kBox + 2 * kTP * kLdg * 2 + kKP * (cm + 8) * 2 +
                    cm * (int)sizeof(Bn) + 8 * kMaxStages + 16;
  const int st = (kSmemMax - fixed) / p.slot;
  p.stages = st < kMaxStages ? st : kMaxStages;
  p.smem = fixed + p.stages * p.slot;
  p.tiles = (P + kTP - 1) / kTP;
  p.grid = p.tiles < kCtas ? p.tiles : kCtas;
  p.groups = (p.grid + kGroup - 1) / kGroup;
  p.v = nc * cm + 2 * cm + (nc + 3) / 4 * 4;
  return p;
}

struct Args {
  const bf16 *g, *wc;            // g (P, nc), wc (nc, cm)
  const float* bn;               // (cm, 4)
  float *dwc, *sums, *dbc;       // (nc, cm), (cm, 2), (nc,)
  float* scratch;                // (grid + groups, v): the CTAs' and the groups' partials
  int* tickets;                  // (groups + 1,): zero between launches
  int P, cm, nc;
  float eps;
};

// byte offset of (pixel r, channel c) in a tile's boxes: box c / 64, its
// 16-byte unit (c % 64) / 8 swizzled by r % 8
__device__ __forceinline__ int at(int r, int c) {
  return (c >> 6) * kBox + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4) + (c & 7) * 2;
}

// a and gu (P, cm): 2-D tensor maps in boxes of 64 channels x kTP pixels
__global__ void __launch_bounds__(kThreads, 1)
head_bwd_kernel(const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_gu, const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // 1024-byte aligned (the swizzle's period), offset from smem_raw itself
  // so that the compiler keeps its accesses in the shared space
  unsigned char* base = smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  const int cm = a.cm, nc = a.nc, ldw = cm + 8;
  const Plan pl = plan(a.P, cm, nc);
  const int S = pl.stages;
  unsigned char* ring = base;                                       // [S][slot]
  unsigned char* zs = ring + S * pl.slot;                           // [nb][kTP][128 B]
  bf16* gs = reinterpret_cast<bf16*>(zs + pl.nb * kBox);            // [2][kTP][kLdg]
  bf16* ws = gs + 2 * kTP * kLdg;                                   // [kKP][ldw] wc
  Bn* bs = reinterpret_cast<Bn*>(ws + kKP * ldw);                   // [cm]
  uint64_t* full = reinterpret_cast<uint64_t*>(bs + cm);            // [kMaxStages]
  int* flag = reinterpret_cast<int*>(full + kMaxStages);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g8 = lane / 4, t4 = lane % 4;

  // wc (rows past nc zero), g's padding classes and z zero, the BN table,
  // the ring's barriers
  for (int i = tid; i < kKP * cm / 2; i += kThreads) {
    const int j = 2 * i / cm, c = 2 * i - j * cm;
    *reinterpret_cast<uint32_t*>(ws + j * ldw + c) =
        j < nc ? *reinterpret_cast<const uint32_t*>(a.wc + (size_t)j * cm + c) : 0u;
  }
  for (int i = tid; i < kTP * kLdg; i += kThreads) reinterpret_cast<uint32_t*>(gs)[i] = 0u;
  for (int i = tid; i < pl.nb * kBox / 16; i += kThreads)
    reinterpret_cast<uint4*>(zs)[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int c = tid; c < cm; c += kThreads) bs[c] = load_bn(a.bn, c, a.eps);
  if (tid == 0) {
    for (int s = 0; s < kMaxStages; ++s) hop::mbar_init(&full[s], 1);
    hop::mbar_init_fence();
  }
  __syncthreads();

  // the ring's producer, one thread of the last warp: tile j of this CTA
  // (blockIdx.x + j grid) into slot j % S, its a boxes, then g's bytes
  // rounded down to 16 (all of them but in a ragged last tile, whose rest
  // the g staging below reads from device memory)
  const int mine = (pl.tiles - blockIdx.x + pl.grid - 1) / pl.grid;
  const bool producer = tid == kThreads - 32;
  auto issue = [&](int j) {
    const int p0 = (blockIdx.x + j * pl.grid) * kTP, np = min(kTP, a.P - p0);
    unsigned char* dst = ring + (j % S) * pl.slot;
    const int gb = np * nc * 2 / 16 * 16;
    hop::mbar_expect_tx(&full[j % S], pl.nb * kBox + gb);
    for (int b = 0; b < pl.nb; ++b) hop::tma_load_2d(dst + b * kBox, &map_a, 64 * b, p0, &full[j % S]);
    if (gb > 0) hop::bulk_copy(dst + pl.nb * kBox, a.g + (size_t)p0 * nc, gb, &full[j % S]);
  };
  if (producer) {
    hop::tma_prefetch_map(&map_a);
    hop::tma_prefetch_map(&map_gu);
    for (int j = 0; j < S - 1 && j < mine; ++j) issue(j);
  }

  // g's class gj of pixels gr0, gr0 + 16, ..; the warp's 8-channel blocks
  // w and w + 16 (of cm / 8), for gz, gu, z, the sums and dWc, its channel
  // pair in each 2 t4
  const int gj = tid % 32, gr0 = tid / 32;
  const int nblk = (warp < cm / 8) + (warp + 16 < cm / 8);
  float db = 0.f;            // sum of g over this thread's pixels, class gj
  float sum[2][4];           // block i: sum gu (c, c + 1), sum gu xhat (c, c + 1)
  float dw[2][2][4];         // dWc, block i, class block mo
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) sum[i][e] = dw[i][0][e] = dw[i][1][e] = 0.f;

  for (int it = 0; it < mine; ++it) {
    const int p0 = (blockIdx.x + it * pl.grid) * kTP, np = min(kTP, a.P - p0);
    unsigned char* st = ring + (it % S) * pl.slot;
    bf16* gt = gs + (it & 1) * kTP * kLdg;    // this tile's g (the last tile's dWc reads the other)
    hop::mbar_wait(&full[it % S], (it / S) & 1);

    // g and dbc's share
    if (gj < nc) {
      const bf16* graw = reinterpret_cast<const bf16*>(st + pl.nb * kBox);
      const int gb = np * nc * 2 / 16 * 16;
#pragma unroll
      for (int k = 0; k < kTP / 16; ++k) {
        const int r = gr0 + 16 * k, e = r * nc + gj;
        bf16 v = __float2bfloat16_rn(0.f);
        if (r < np) v = 2 * e < gb ? graw[e] : a.g[(size_t)p0 * nc + e];
        gt[r * kLdg + gj] = v;
        db += __bfloat162float(v);
      }
    }
    __syncthreads();   // g staged; every warp is past the last tile's dWc

    // per block: gz (64 pixels x 8 channels) = g . wc, K = 32; then, from
    // each of a's pairs, u and xhat once: gu over a, z into zs, the sums
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (i >= nblk) break;
      const int n = warp + 16 * i, c = 8 * n + 2 * t4;
      float acc[4][4];
#pragma unroll
      for (int m = 0; m < 4; ++m) acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.f;
#pragma unroll
      for (int kt = 0; kt < kKP / 16; ++kt) {
        uint32_t fb[2], fa[4][4];
        ldsm_x2_trans(fb, ws + (16 * kt + (lane & 7) + (lane & 8)) * ldw + 8 * n);
#pragma unroll
        for (int m = 0; m < 4; ++m)
          ldsm_x4(fa[m], gt + (16 * m + (lane & 7) + (lane & 8)) * kLdg + 16 * kt + (lane >> 4) * 8);
#pragma unroll
        for (int m = 0; m < 4; ++m) mma_bf16(acc[m], fa[m], fb);
      }
      const Bn b0 = bs[c], b1 = bs[c + 1];
      // this thread's pixels g8 + 8 hh share their row's swizzle (p % 8 ==
      // g8): their pair sits at one offset plus 1024 hh
      const int off = at(g8, c);
      uint32_t xv[8];   // a's pairs, all loaded before the first store
#pragma unroll
      for (int hh = 0; hh < 8; ++hh)
        xv[hh] = *reinterpret_cast<const uint32_t*>(st + off + 1024 * hh);
#pragma unroll
      for (int hh = 0; hh < 8; ++hh) {
        const int m = hh >> 1, h = hh & 1, p = g8 + 8 * hh;
        if (p >= np) continue;
        const float2 x = load2<bf16>(reinterpret_cast<const bf16*>(&xv[hh]));
        const float xh0 = bn_xh(x.x, b0), xh1 = bn_xh(x.y, b1);
        const float u0 = bn_u(xh0, b0), u1 = bn_u(xh1, b1);
        const float v0 = u0 > 0.f ? acc[m][2 * h] : 0.f;
        const float v1 = u1 > 0.f ? acc[m][2 * h + 1] : 0.f;
        store2<bf16>(reinterpret_cast<bf16*>(st + off + 1024 * hh), v0, v1);
        store2<bf16>(reinterpret_cast<bf16*>(zs + off + 1024 * hh), fmaxf(u0, 0.f), fmaxf(u1, 0.f));
        sum[i][0] += v0;
        sum[i][1] += v1;
        sum[i][2] = fmaf(v0, xh0, sum[i][2]);
        sum[i][3] = fmaf(v1, xh1, sum[i][3]);
      }
    }
    __syncwarp();   // the warp's z (its own blocks) is what its dWc reads

    // dWc (classes 16 mo .., the warp's blocks) += g^T z, K = the tile's
    // 64 pixels (z's rows past the tile are stale or zero, g's zero); the
    // second class block only where nc > 16
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (i >= nblk) break;
      const int n = warp + 16 * i;
      const int zoff = at((lane & 7) + (lane & 8), 8 * n);   // row k's, plus 2048 kt
#pragma unroll
      for (int kt = 0; kt < kTP / 16; ++kt) {
        uint32_t fb[2], fa[4];
        ldsm_x2_trans(fb, reinterpret_cast<const bf16*>(zs + zoff + 2048 * kt));
        ldsm_x4_trans(fa, gt + (16 * kt + (lane & 7) + (lane >> 4) * 8) * kLdg + (lane & 8));
        mma_bf16(dw[i][0], fa, fb);
        if (nc > 16) {
          ldsm_x4_trans(fa, gt + (16 * kt + (lane & 7) + (lane >> 4) * 8) * kLdg + 16 + (lane & 8));
          mma_bf16(dw[i][1], fa, fb);
        }
      }
    }
    hop::fence_proxy_async();   // gu's writes, before the store reads them
    __syncthreads();            // gu formed
    if (producer) {
      for (int b = 0; b < pl.nb; ++b) hop::tma_store_2d(&map_gu, 64 * b, p0, st + b * kBox);
      hop::bulk_commit();
      // slot (it - 1) % S: its store (the last tile's) has read it -> tile it + S - 1
      hop::bulk_wait_read<1>();
      if (it + S - 1 < mine) issue(it + S - 1);
    }
  }
  if (producer) hop::bulk_wait<0>();
  __syncthreads();

  // this CTA's partial: dWc (nc x cm), the sums (cm x 2), dbc (nc, padded
  // to 4). dWc from the fragments; the sums over the 8 lanes of a column
  // pair (g8) by shuffles in a fixed order; dbc over the 16 pixel groups
  // in order, through shared memory
  float* part = a.scratch + (size_t)blockIdx.x * pl.v;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (i >= nblk) break;
    const int c = 8 * (warp + 16 * i) + 2 * t4;
#pragma unroll
    for (int mo = 0; mo < 2; ++mo)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = 16 * mo + g8 + 8 * h;
        if (o < nc)
          __stcg(reinterpret_cast<float2*>(part + (size_t)o * cm + c),
                 make_float2(dw[i][mo][2 * h], dw[i][mo][2 * h + 1]));
      }
    float4 s = make_float4(sum[i][0], sum[i][2], sum[i][1], sum[i][3]);
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      s.x += __shfl_xor_sync(0xffffffffu, s.x, off);
      s.y += __shfl_xor_sync(0xffffffffu, s.y, off);
      s.z += __shfl_xor_sync(0xffffffffu, s.z, off);
      s.w += __shfl_xor_sync(0xffffffffu, s.w, off);
    }
    if (g8 == 0) __stcg(reinterpret_cast<float4*>(part + nc * cm + 2 * c), s);
  }
  float* red = reinterpret_cast<float*>(gs);   // [16][32]
  red[gr0 * 32 + gj] = db;
  __syncthreads();
  if (tid < (nc + 3) / 4 * 4) {
    float v = 0.f;
    if (tid < nc)
#pragma unroll
      for (int k = 0; k < kThreads / 32; ++k) v += red[k * 32 + tid];
    __stcg(part + nc * cm + 2 * cm + tid, v);
  }

  // the partials' sum, in a fixed order: the last CTA of each group of
  // kGroup adds its group's partials in CTA order; with more than one
  // group the last group's adder adds the groups' sums in group order and
  // writes dWc, the sums and dbc. Who adds depends on timing, the order
  // does not.
  const int grp = blockIdx.x / kGroup, b0 = grp * kGroup;
  const int b1 = min(pl.grid, b0 + kGroup), groups = pl.groups, v4 = pl.v / 4;
  const int dw4 = nc * cm / 4, s4 = dw4 + cm / 2;
  auto out = [&](int e4, float4 val) {
    if (e4 < dw4) {
      reinterpret_cast<float4*>(a.dwc)[e4] = val;
    } else if (e4 < s4) {
      reinterpret_cast<float4*>(a.sums)[e4 - dw4] = val;
    } else {
      const float vv[4] = {val.x, val.y, val.z, val.w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (4 * (e4 - s4) + k < nc) a.dbc[4 * (e4 - s4) + k] = vv[k];
    }
  };
  __threadfence();
  __syncthreads();
  if (tid == 0) *flag = atomicAdd(&a.tickets[grp], 1) == b1 - b0 - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  const float4* parts = reinterpret_cast<const float4*>(a.scratch);
  float4* gsum = reinterpret_cast<float4*>(a.scratch + (size_t)(pl.grid + grp) * pl.v);
  for (int e4 = tid; e4 < v4; e4 += kThreads) {
    const float4 s = ordered_sum4_cg<kGroup>(parts + (size_t)b0 * v4 + e4, b1 - b0, v4);
    if (groups == 1) out(e4, s);
    else __stcg(gsum + e4, s);
  }
  if (tid == 0) a.tickets[grp] = 0;
  if (groups == 1) return;
  __threadfence();
  __syncthreads();
  if (tid == 0) *flag = atomicAdd(&a.tickets[groups], 1) == groups - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  for (int e4 = tid; e4 < v4; e4 += kThreads)
    out(e4, ordered_sum4_cg<kMaxGroups>(parts + (size_t)pl.grid * v4 + e4, groups, v4));
  if (tid == 0) a.tickets[groups] = 0;
}

cudaError_t run(const void* act, void* gu, const Args& a, cudaStream_t st) {
  const Plan p = plan(a.P, a.cm, a.nc);
  const cuuint64_t dims[2] = {(cuuint64_t)a.cm, (cuuint64_t)a.P};
  const cuuint64_t strides[1] = {(cuuint64_t)a.cm * 2};
  const cuuint32_t box[2] = {64, kTP};
  CUtensorMap ma, mg;
  if (p.stages < kMinStages || ctas_per_sm<head_bwd_kernel>(kThreads, p.smem) < 1 ||
      !hop::cached_map(&ma, act, 2, dims, strides, box) ||
      !hop::cached_map(&mg, gu, 2, dims, strides, box))
    return cudaErrorInvalidValue;
  head_bwd_kernel<<<p.grid, kThreads, p.smem, st>>>(ma, mg, a);
  return cudaGetLastError();
}

}  // namespace hbw

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t set_smem(K kern, int bytes) {
  if (bytes > kSmemMax) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T>
cudaError_t run_sep_fwd(const void* x0, const void* x1, const void* dwt, const void* pw,
                        void* y, void* partial, int n, int h, int w, int c0, int c1, int co,
                        int k, int dil, int grid, cudaStream_t st) {
  sepconv::Args<T, T, T> a{};
  a.x0 = static_cast<const T*>(x0);
  a.x1 = static_cast<const T*>(x1);
  a.taps = static_cast<const float*>(dwt);
  a.w = static_cast<const T*>(pw);
  a.y = static_cast<T*>(y);
  a.partial = static_cast<float*>(partial);
  a.n = n, a.h = h, a.w_ = w, a.c0 = c0, a.c1 = c1, a.co = co, a.k = k, a.dil = dil;
  // the separable conv (no moments) in bfloat16 splits t; P1 and float32 do not
  if constexpr (sizeof(T) == 2)
    if (partial == nullptr) return sepconv::launch(sep_fwd_kernel<T, true>, a, grid, st);
  return sepconv::launch(sep_fwd_kernel<T, false>, a, grid, st);
}

template <typename T>
cudaError_t run_head_fwd(const void* a, const void* bn, const void* wc, const void* bc, void* y,
                         int P, int cm, int nc, float eps, int grid, cudaStream_t st) {
  auto kern = head_fwd_kernel<T>;
  const int smem = head_fwd_smem<T>(cm);
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<grid, kThreads, smem, st>>>(static_cast<const T*>(a), static_cast<const float*>(bn),
                                     static_cast<const T*>(wc), static_cast<const float*>(bc),
                                     static_cast<T*>(y), P, cm, nc, eps);
  return cudaGetLastError();
}

cudaError_t run_head_bwd(const void* g, const void* a, const void* bn, const void* wc, void* gu,
                         void* psum, void* pwc, void* pbc, int P, int cm, int nc, float eps,
                         int grid, cudaStream_t st) {
  auto kern = head_bwd_kernel<float>;
  const int smem = head_bwd_smem<float>(cm);
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(g), static_cast<const float*>(a), static_cast<const float*>(bn),
      static_cast<const float*>(wc), static_cast<float*>(gu), static_cast<float*>(psum),
      static_cast<float*>(pwc), static_cast<float*>(pbc), P, cm, nc, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_sep_bwd(const void* gu, const void* a, const void* x0, const void* x1,
                        const void* pn, const void* dwt, const void* pwt, void* gx0, void* gx1,
                        void* pdpw, void* pdk, int n, int h, int w, int c0, int c1, int cm,
                        float eps, int grid, cudaStream_t st) {
  auto kern = sep_bwd_kernel<T>;
  const int smem = sep_bwd_layout<T>(cm).total;
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(grid, (c0 + c1 + kNC - 1) / kNC), kThreads, smem, st>>>(
      static_cast<const T*>(gu), static_cast<const T*>(a), static_cast<const T*>(x0),
      static_cast<const T*>(x1), static_cast<const float*>(pn), static_cast<const float*>(dwt),
      static_cast<const T*>(pwt), static_cast<T*>(gx0), static_cast<T*>(gx1),
      static_cast<float*>(pdpw), static_cast<float*>(pdk), n, h, w, c0, c1, cm, eps);
  return cudaGetLastError();
}

// the two inputs' widths: multiples of 8 (16-byte channel groups), the
// second may be absent (c1 == 0)
bool inputs_ok(int c0, int c1) { return c0 >= 8 && c0 % 8 == 0 && c1 >= 0 && c1 % 8 == 0; }
bool head_ok(int cm, int nc) { return cm >= 16 && cm % 16 == 0 && cm <= kMaxCm && nc >= 1 && nc <= kKP; }

int tiles(long long extent, int tile) { return (int)((extent + tile - 1) / tile); }
int at_most(int a, int b) { return a < b ? a : b; }

}  // namespace

extern "C" {

// The x extent of a launch's grid, by which the caller sizes the CTA
// partials: kernel 0 sep_fwd, 1 head_fwd, 2 head_bwd, 3 sep_bwd (float32
// only: bfloat16 is kdcc_sep_bwd_plan's), on n * h * w pixels in dtype (0
// float32, 1 bfloat16). 0 for an unknown kernel.
int kdcc_head_grid(int kernel, int dtype, int n, int h, int w) {
  const long long p = (long long)n * h * w;
  switch (kernel) {
    case 0: return at_most(tiles(p, sepconv::kTP), kSepFwdCtas);
    case 1: return at_most(tiles(p, kTP), kHeadFwdCtas);
    case 2: return at_most(tiles(p, kTP), kHeadBwdCtas);
    case 3: return dtype == 0 ? at_most(n * tiles(h, kBwdRows) * tiles(w, kTW), kSepBwdCtas) : 0;
  }
  return 0;
}

// Separable conv / P1. x0 (n, h, w, c0), x1 (n, h, w, c1) or null with c1 = 0,
// pw (co, c0 + c1), y (n, h, w, co) in dtype; dwt (k * k, c0 + c1) f32;
// partial (grid, 2, co) f32 or null (no moments). Odd k <= 7, co % 8 == 0.
int kdcc_sep_fwd(int dtype, const void* x0, const void* x1, const void* dwt, const void* pw,
                 void* y, void* partial, int n, int h, int w, int c0, int c1, int co, int k,
                 int dil, int grid, void* stream) {
  if (grid < 1 || !inputs_ok(c0, c1) || (c1 > 0) != (x1 != nullptr) || co < 8 || co % 8 ||
      k < 1 || k % 2 == 0 || k > sepconv::kMaxK || dil < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)run_sep_fwd<float>(x0, x1, dwt, pw, y, partial, n, h, w, c0, c1, co, k, dil,
                                   grid, st);
  if (dtype == 1)
    return (int)run_sep_fwd<__nv_bfloat16>(x0, x1, dwt, pw, y, partial, n, h, w, c0, c1, co, k,
                                           dil, grid, st);
  return (int)cudaErrorInvalidValue;
}

// P2. a (P, cm), wc (nc, cm), y (P, nc) in dtype; bn (cm, 4), bc (nc) f32.
int kdcc_head_fwd(int dtype, const void* a, const void* bn, const void* wc, const void* bc,
                  void* y, int P, int cm, int nc, float eps, int grid, void* stream) {
  if (grid < 1 || !head_ok(cm, nc)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)run_head_fwd<float>(a, bn, wc, bc, y, P, cm, nc, eps, grid, st);
  if (dtype == 1)
    return (int)run_head_fwd<__nv_bfloat16>(a, bn, wc, bc, y, P, cm, nc, eps, grid, st);
  return (int)cudaErrorInvalidValue;
}

// B1, float32 (the parity variant; bfloat16 is kdcc_head_bwd_bf16). g (P,
// nc), a and gu (P, cm), wc (nc, cm); bn (cm, 4); psum (grid, 2, cm), pwc
// (grid, nc, cm), pbc (grid, nc).
int kdcc_head_bwd(int dtype, const void* g, const void* a, const void* bn, const void* wc,
                  void* gu, void* psum, void* pwc, void* pbc, int P, int cm, int nc, float eps,
                  int grid, void* stream) {
  if (dtype != 0 || grid < 1 || !head_ok(cm, nc)) return (int)cudaErrorInvalidValue;
  return (int)run_head_bwd(g, a, bn, wc, gu, psum, pwc, pbc, P, cm, nc, eps, grid,
                           static_cast<cudaStream_t>(stream));
}

// The bfloat16 B1's plan for P pixels of cm channels and nc classes, by
// `what`: 0 its CTAs, 1 the groups of its partials' first-level sum, 2 the
// f32 scratch it needs ((CTAs + groups) x (nc cm + 2 cm + nc rounded up to
// 4)), 3 its tickets (groups + 1), 4 its ring's stages, 5 its dynamic
// shared memory; -1 for a shape it does not take.
int kdcc_head_bwd_plan(int what, int P, int cm, int nc) {
  if (P < 1 || !head_ok(cm, nc)) return -1;
  const hbw::Plan p = hbw::plan(P, cm, nc);
  if (p.stages < hbw::kMinStages) return -1;
  switch (what) {
    case 0: return p.grid;
    case 1: return p.groups;
    case 2: return (p.grid + p.groups) * p.v;
    case 3: return p.groups + 1;
    case 4: return p.stages;
    case 5: return p.smem;
    default: return -1;
  }
}

// B1 in bfloat16, one launch. g (P, nc), a and gu (P, cm), wc (nc, cm) bf16,
// g, a and gu 16-byte aligned; bn (cm, 4) f32; dwc (nc, cm), sums (cm, 2)
// (16-byte aligned) and dbc (nc,) f32; scratch f32 of scratch_floats and
// tickets int32 (kdcc_head_bwd_plan's 2 and 3), the tickets zero, left
// zero. grid and scratch_floats must be the plan's.
int kdcc_head_bwd_bf16(const void* g, const void* a, const void* bn, const void* wc, void* gu,
                       void* dwc, void* sums, void* dbc, void* scratch, void* tickets, int P,
                       int cm, int nc, float eps, int grid, int scratch_floats, void* stream) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(gu) | reinterpret_cast<uintptr_t>(dwc) |
                         reinterpret_cast<uintptr_t>(sums);
  if (g == nullptr || a == nullptr || bn == nullptr || wc == nullptr || gu == nullptr ||
      dwc == nullptr || sums == nullptr || dbc == nullptr || scratch == nullptr ||
      tickets == nullptr || bits % 16 || grid != kdcc_head_bwd_plan(0, P, cm, nc) ||
      scratch_floats != kdcc_head_bwd_plan(2, P, cm, nc))
    return (int)cudaErrorInvalidValue;
  hbw::Args args{};
  args.g = static_cast<const __nv_bfloat16*>(g);
  args.wc = static_cast<const __nv_bfloat16*>(wc);
  args.bn = static_cast<const float*>(bn);
  args.dwc = static_cast<float*>(dwc);
  args.sums = static_cast<float*>(sums);
  args.dbc = static_cast<float*>(dbc);
  args.scratch = static_cast<float*>(scratch);
  args.tickets = static_cast<int*>(tickets);
  args.P = P, args.cm = cm, args.nc = nc, args.eps = eps;
  return (int)hbw::run(a, gu, args, static_cast<cudaStream_t>(stream));
}

// B2 (3x3, pad 1, dilation 1), float32 (the parity variant; bfloat16 is
// kdcc_sep_bwd_bf16). gu, a (n, h, w, cm); x0, gx0 (n, h, w, c0); x1, gx1
// (n, h, w, c1); pwt (c0 + c1, cm); pn (cm, 6), dwt (9, c0 + c1); pdpw
// (grid, cm, c0 + c1), pdk (grid, 9, c0 + c1).
int kdcc_sep_bwd(int dtype, const void* gu, const void* a, const void* x0, const void* x1,
                 const void* pn, const void* dwt, const void* pwt, void* gx0, void* gx1,
                 void* pdpw, void* pdk, int n, int h, int w, int c0, int c1, int cm, float eps,
                 int grid, void* stream) {
  if (dtype != 0 || grid < 1 || !inputs_ok(c0, c1) || (c1 > 0) != (x1 != nullptr) ||
      !head_ok(cm, 1))
    return (int)cudaErrorInvalidValue;
  return (int)run_sep_bwd<float>(gu, a, x0, x1, pn, dwt, pwt, gx0, gx1, pdpw, pdk, n, h, w, c0,
                                 c1, cm, eps, grid, static_cast<cudaStream_t>(stream));
}

// The bfloat16 B2's plan for a shape, by `what`: 0 its CTAs, 1 its chunks
// of 64 input channels, 2 the groups of its partials' first-level sum, 3
// the f32 scratch it needs ((CTAs + chunks x groups) x (cm + 9) x 64), 4
// its tickets (chunks x (groups + 1)), 5 its ring's stages; -1 for a shape
// it does not take.
int kdcc_sep_bwd_plan(int what, int n, int h, int w, int c0, int c1, int cm) {
  sbw::Plan p;
  if (n < 1 || h < 1 || w < 1 || !inputs_ok(c0, c1) || !head_ok(cm, 1) ||
      !sbw::plan(p, n, h, w, c0 + c1, cm))
    return -1;
  switch (what) {
    case 0: return p.grid;
    case 1: return p.chunks;
    case 2: return p.groups;
    case 3: return (p.grid + p.chunks * p.groups) * p.v;
    case 4: return p.chunks * (p.groups + 1);
    case 5: return p.stages;
    default: return -1;
  }
}

// B2 in bfloat16, one launch. gu, a (n, h, w, cm); x0, gx0 (n, h, w, c0);
// x1, gx1 (n, h, w, c1) or null with c1 = 0; pw (cm, c0 + c1), all bf16 and
// 16-byte aligned; pn (cm, 6), k (c0 + c1, 9) f32; dpw (cm, c0 + c1)
// (16-byte aligned) and dk (c0 + c1, 9) f32; scratch f32 of scratch_floats
// and tickets int32 (kdcc_sep_bwd_plan's 3 and 4), the tickets zero, left
// zero. grid and scratch_floats must be the plan's.
int kdcc_sep_bwd_bf16(const void* gu, const void* a, const void* x0, const void* x1,
                      const void* pn, const void* k, const void* pw, void* gx0, void* gx1,
                      void* dpw, void* dk, void* scratch, void* tickets, int n, int h, int w,
                      int c0, int c1, int cm, float eps, int grid, int scratch_floats,
                      void* stream) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(gu) | reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(x0) | reinterpret_cast<uintptr_t>(x1) |
                         reinterpret_cast<uintptr_t>(pw) | reinterpret_cast<uintptr_t>(dpw);
  if (gu == nullptr || a == nullptr || x0 == nullptr || pn == nullptr || k == nullptr ||
      pw == nullptr || gx0 == nullptr || dpw == nullptr || dk == nullptr || scratch == nullptr ||
      tickets == nullptr || bits % 16 || (c1 > 0) != (x1 != nullptr) ||
      (c1 > 0) != (gx1 != nullptr) || grid != kdcc_sep_bwd_plan(0, n, h, w, c0, c1, cm) ||
      scratch_floats != kdcc_sep_bwd_plan(3, n, h, w, c0, c1, cm))
    return (int)cudaErrorInvalidValue;
  sbw::Args args{};
  args.x0 = static_cast<const __nv_bfloat16*>(x0);
  args.x1 = static_cast<const __nv_bfloat16*>(x1);
  args.pw = static_cast<const __nv_bfloat16*>(pw);
  args.pn = static_cast<const float*>(pn);
  args.k = static_cast<const float*>(k);
  args.gx0 = static_cast<__nv_bfloat16*>(gx0);
  args.gx1 = static_cast<__nv_bfloat16*>(gx1);
  args.dpw = static_cast<float*>(dpw);
  args.dk = static_cast<float*>(dk);
  args.scratch = static_cast<float*>(scratch);
  args.tickets = static_cast<int*>(tickets);
  args.n = n, args.h = h, args.w = w, args.c0 = c0, args.c1 = c1, args.cm = cm, args.eps = eps;
  return (int)sbw::run(gu, a, args, static_cast<cudaStream_t>(stream));
}

}  // extern "C"

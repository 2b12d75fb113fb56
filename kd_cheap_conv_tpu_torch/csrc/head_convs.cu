// The student's DeepLabV3+ head: the fused separable conv (ASPP branches and,
// in serving, the decoder's fuse conv) and the fused train-mode decoder head
// (sep-conv -> BN -> relu -> 1x1 classifier, forward and backward).
//
// Replaces the Pallas kernels of kd_cheap_conv_tpu/ops/pallas/:
//   _kernel via fused_separable_conv (separable.py:67, :83) -> sep_fwd_kernel<T, bf16>, no moments
//   _k_sep_fwd  (decoder.py:59, pass P1)                  -> sep_fwd_kernel<T, false>, moments
//   _k_head_fwd (decoder.py:83, pass P2)                  -> head_fwd_kernel<T>
//   _k_head_bwd (decoder.py:100, pass B1)                 -> head_bwd_kernel<T>
//   _k_sep_bwd  (decoder.py:138, pass B2)                 -> sep_bwd_kernel<T>
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
// wrapper sums the partials. The grid depends on the shape only.
//
// What bounds them on an H100, and the design: the 1x1 products (Ci = 304,
// Cm = 256) take 2 x 256 FLOPs per activation element read, below the
// tensor cores' ~295 FLOP/byte, so the kernels are bytes-bound at the
// roofline: the depthwise output t never reaches HBM (P1, the separable
// conv), ga and gt live in shared memory (B2), and the concat of low and up
// is never built. sep_fwd is sep_conv.cuh's tile loop (shared with
// xchain_eval.cu's folded sep conv; products on mma.cuh's `WarpGemm`); the
// head kernels' products are mma.cuh's `gemm`. Both run on shared-memory
// operands: mma.sync m16n8k16 for bfloat16, FMAs in the mma fragment's
// layout for float32 (the f32 path is for parity checks). Operands are
// staged by synchronous loads (no cp.async or TMA pipeline), and B2
// recomputes ga per 64-channel chunk of Ci: later work.
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

namespace {

constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kSmemMax = 232448;   // an H100 CTA's shared memory
constexpr int kTP = 64;            // head_fwd, head_bwd: pixels per tile
constexpr int kMaxCm = 256;        // head kernels, sep_bwd: widest Cm (a thread per channel)
constexpr int kKP = 32;            // head kernels: classes padded (at most 32)
constexpr int kNC = 64;            // sep_bwd: input channels per CTA (gridDim.y chunks)
constexpr int kTW = 14;            // sep_bwd: tile columns; with the halo, 16
// CTAs along x at most (each kernel loops over its tiles with that stride):
// 8, 4, 1 and 1 per SM of an H100's 132
constexpr int kSepFwdCtas = 1056, kHeadFwdCtas = 528, kHeadBwdCtas = 132, kSepBwdCtas = 132;

// sep_bwd: tile rows (the float32 path's operands take twice the space)
template <typename T> __host__ __device__ constexpr int bwd_rows() {
  return sizeof(T) == 2 ? 4 : 2;
}

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
// head_bwd: tiles of kTP pixels. gz = g . wc (one product per tile, through
// shared memory to a thread per channel for gu and its sums); dWc = g^T z
// accumulates in fragments across tiles; dbc by a thread per class
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
// sep_bwd: spatial tiles of TH x kTW pixels of one image, with a one-pixel
// halo ((TH + 2) x 16 pixels), for one chunk of kNC input channels per CTA
// (gridDim.y). Per tile: ga on the halo (a thread per Cm channel), gt = ga .
// pw on the halo (shared memory), then a thread per (channel, pixel group)
// forms g_x, t and dk from gt and x; dpw = ga^T t accumulates in fragments.
// ---------------------------------------------------------------------------

struct BwdLayout {
  int pws, gas, gats, tts, xs, gts, dws, nbs, total;
};
template <typename T> __host__ __device__ constexpr BwdLayout sep_bwd_layout(int cm) {
  constexpr int TH = bwd_rows<T>(), HP = (TH + 2) * (kTW + 2);
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
  constexpr int TH = bwd_rows<T>(), HW = kTW + 2, HP = (TH + 2) * HW, CP = TH * kTW;
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

template <typename T>
cudaError_t run_head_bwd(const void* g, const void* a, const void* bn, const void* wc, void* gu,
                         void* psum, void* pwc, void* pbc, int P, int cm, int nc, float eps,
                         int grid, cudaStream_t st) {
  auto kern = head_bwd_kernel<T>;
  const int smem = head_bwd_smem<T>(cm);
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(g), static_cast<const T*>(a), static_cast<const float*>(bn),
      static_cast<const T*>(wc), static_cast<T*>(gu), static_cast<float*>(psum),
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
// partials: kernel 0 sep_fwd, 1 head_fwd, 2 head_bwd, 3 sep_bwd, on n * h *
// w pixels in dtype (0 float32, 1 bfloat16). 0 for an unknown kernel.
int kdcc_head_grid(int kernel, int dtype, int n, int h, int w) {
  const long long p = (long long)n * h * w;
  switch (kernel) {
    case 0: return at_most(tiles(p, sepconv::kTP), kSepFwdCtas);
    case 1: return at_most(tiles(p, kTP), kHeadFwdCtas);
    case 2: return at_most(tiles(p, kTP), kHeadBwdCtas);
    case 3: {
      const int rows = dtype == 1 ? bwd_rows<__nv_bfloat16>() : bwd_rows<float>();
      return at_most(n * tiles(h, rows) * tiles(w, kTW), kSepBwdCtas);
    }
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

// B1. g (P, nc), a and gu (P, cm), wc (nc, cm) in dtype; bn (cm, 4) f32;
// psum (grid, 2, cm), pwc (grid, nc, cm), pbc (grid, nc) f32.
int kdcc_head_bwd(int dtype, const void* g, const void* a, const void* bn, const void* wc,
                  void* gu, void* psum, void* pwc, void* pbc, int P, int cm, int nc, float eps,
                  int grid, void* stream) {
  if (grid < 1 || !head_ok(cm, nc)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)run_head_bwd<float>(g, a, bn, wc, gu, psum, pwc, pbc, P, cm, nc, eps, grid, st);
  if (dtype == 1)
    return (int)run_head_bwd<__nv_bfloat16>(g, a, bn, wc, gu, psum, pwc, pbc, P, cm, nc, eps,
                                            grid, st);
  return (int)cudaErrorInvalidValue;
}

// B2 (3x3, pad 1, dilation 1). gu, a (n, h, w, cm); x0, gx0 (n, h, w, c0);
// x1, gx1 (n, h, w, c1); pwt (c0 + c1, cm) in dtype; pn (cm, 6), dwt
// (9, c0 + c1) f32; pdpw (grid, cm, c0 + c1), pdk (grid, 9, c0 + c1) f32.
int kdcc_sep_bwd(int dtype, const void* gu, const void* a, const void* x0, const void* x1,
                 const void* pn, const void* dwt, const void* pwt, void* gx0, void* gx1,
                 void* pdpw, void* pdk, int n, int h, int w, int c0, int c1, int cm, float eps,
                 int grid, void* stream) {
  if (grid < 1 || !inputs_ok(c0, c1) || (c1 > 0) != (x1 != nullptr) || !head_ok(cm, 1))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)run_sep_bwd<float>(gu, a, x0, x1, pn, dwt, pwt, gx0, gx1, pdpw, pdk, n, h, w, c0,
                                   c1, cm, eps, grid, st);
  if (dtype == 1)
    return (int)run_sep_bwd<__nv_bfloat16>(gu, a, x0, x1, pn, dwt, pwt, gx0, gx1, pdpw, pdk, n,
                                           h, w, c0, c1, cm, eps, grid, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

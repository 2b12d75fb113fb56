// The wide 1x1 BN-barrier passes of the Xception chains (Ci x Co from
// 64 x 128 up to 1536 x 2048, past what bn_passes.cu's narrow kernels hold
// in shared memory): the forward and, as two kernels, the backward.
//
// Replaces the Pallas kernels of kd_cheap_conv_tpu/ops/pallas/stem.py at the
// widths of kd_cheap_conv_tpu/ops/pallas/xchain.py's train chains:
//   _k_bn_pw  (_run_bn_pw, stem.py:321, :650)   -> xpw_fwd_kernel
//   _k_pw_bwd (_run_pw_bwd, stem.py:776, :1049) -> xpw_dgrad_kernel (gy_k, sums)
//                                                 + xpw_wgrad_kernel (dW)
//
// What they compute (activations NHWC, unpadded, P pixels):
// - fwd: h = act(BN(a)) with the previous BN's batch moments, in f32,
//   rounded to the activation dtype (the JAX kernel's `_mm` operand);
//   y = h . W^T (W (Co, Ci) in the activation dtype, f32 sums), stored in
//   the activation dtype; the per-channel sum and sum of squares of the f32
//   y (the next BN's moments) as CTA partials, none for a null partial
//   pointer (an eval pass). A null BN is the identity.
// - dgrad: ga = the next BN's train backward of gy (pack (Co, 6); a null
//   pack is the exact identity), formed only at real pixels and rounded;
//   gz = ga . W; gy_k = gz * act'(u_k), u_k = BN_k(a_k) recomputed, stored;
//   the per-channel sums [gy_k, gy_k * xhat_k] as CTA partials.
// - wgrad: dW = ga^T . z with z = act(u_k) rounded to the activation dtype,
//   over pixel splits: each CTA one (Co tile, Ci tile, split), written as
//   that split's partial; the wrapper sums the splits in a fixed order.
// The BN arithmetic is common.cuh's (rounded as the plain versions' torch
// ops round it), so the relu masks agree with the plain versions bit for
// bit.
//
// Determinism: no float atomics. Every sum has one fixed owner (a thread,
// or an mma fragment slot) that adds in a fixed order; the grids depend on
// the shape only.
//
// What bounds them on an H100: the products. The middle flow's 1x1 passes
// are 9,604 pixels x 728 x 728 (2 x 728 FLOPs per activation element read,
// above the tensor cores' ~295 FLOP/byte), the exit flow's up to 1536 ->
// 2048. The design: every product is mma.cuh's `WarpGemm` (mma.sync for
// bfloat16; each warp a 4 x 4 block of 16 x 8 sub-tiles, each fragment
// loaded once per 16-deep step) on shared-memory operands; the weight is
// streamed in K chunks of kKC (forward, dgrad) beside the activation chunk,
// with the BN prologue (forward: BN + act; dgrad: the next BN's backward)
// applied while the chunk is staged, and the moment or sum epilogue taken
// from the f32 tile in shared memory. Staging is synchronous and serial
// with the products (no cp.async or TMA pipeline), and fragments are plain
// 32-bit loads (no ldmatrix): later work (PERF.md).
//
// Shared memory (dynamic, checked against kSmemMax in the entry points):
// - fwd:   Ci x 16 (BN constants) + max((kTP + kNT) x ld_of(kKC) x sizeof(T),
//          kTP x (kNT + 4) x 4): at Ci = 1536, 91,136 bytes (bf16 and f32);
// - dgrad: Co x 20 (next-BN constants) + kNT x 16 + the same operand / tile
//          region (which the epilogue's sums reuse): at Co = 2048, 111,616
//          bytes;
// - wgrad: (kWM + kWN) x ld_of(kKP) x sizeof(T) + kWM x 20 + kWN x 16:
//          25,088 bytes (bf16), 45,568 (f32).
//
// The C entry points launch on the caller's stream and return
// cudaGetLastError(); the Python wrapper raises if it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kThreads = 256, kWarps = kThreads / 32;
static_assert(kWarps == kMmaWarps, "the warp grids assume kMmaWarps warps");
constexpr int kSmemMax = 232448;   // an H100 CTA's shared memory
constexpr int kMaxC = 2048;        // widest Ci (fwd) and Co (dgrad): BN constants in smem
constexpr int kTP = 64;            // fwd, dgrad: pixels per tile
constexpr int kKC = 32;            // fwd, dgrad: K chunk (input / output channels)
constexpr int kNT = 256;           // fwd, dgrad: output columns per CTA (gridDim.y chunks)
constexpr int kWM = 128, kWN = 128;  // wgrad: Co x Ci tile per CTA
constexpr int kKP = 32;            // wgrad: pixels per K chunk
// CTAs at most: fwd and dgrad along x x y (4 per SM of an H100's 132), and
// wgrad in all (2 per SM), which sets its pixel splits
constexpr int kFwdCtas = 528, kWgradCtas = 264;

// the warps' blocks of 16 x 8 sub-tiles (WarpGemm): fwd and dgrad, a 1 x 8
// grid of 4 x 4 blocks over kTP x kNT; wgrad, a 2 x 4 grid of 4 x 4 blocks
// over kWM x kWN
constexpr int kMW = 4, kNW = 4, kSlots = kMW * kNW;
constexpr int kTileWN = kNT / 8 / kNW, kWgradWN = kWN / 8 / kNW;
static_assert(kTP / 16 == kMW && kTileWN == kWarps, "fwd / dgrad warp grid");
static_assert((kWM / 16 / kMW) * kWgradWN == kWarps, "wgrad warp grid");

template <typename T> __host__ __device__ constexpr int tile_region() {
  return (kTP * (kNT + 4) * 4 > (kTP + kNT) * ld_of(kKC) * (int)sizeof(T))
             ? kTP * (kNT + 4) * 4
             : (kTP + kNT) * ld_of(kKC) * (int)sizeof(T);
}
template <typename T> __host__ __device__ constexpr int fwd_smem(int ci) {
  return tile_region<T>() + ci * (int)sizeof(Bn);
}
template <typename T> __host__ __device__ constexpr int dgrad_smem(int co) {
  return tile_region<T>() + kNT * (int)sizeof(Bn) + co * (int)sizeof(BnBwd);
}
template <typename T> __host__ __device__ constexpr int wgrad_smem() {
  return (kWM + kWN) * ld_of(kKP) * (int)sizeof(T) + kWM * (int)sizeof(BnBwd) +
         kWN * (int)sizeof(Bn);
}

// the f32 tile (acc fragments) -> cs [kTP][kNT + 4]
__device__ __forceinline__ void tile_to_smem(const float (&acc)[kSlots][4], float* cs) {
  frags_to_smem<kMW, kNW, kTileWN>(acc, cs, kNT + 4);
}

// fwd and dgrad epilogues: a thread owns 8 channels (group tid % kGroups,
// its sums in registers across tiles) and every kGroupRows-th row of a tile
constexpr int kGroups = kNT / 8, kGroupRows = kThreads / kGroups;   // 32, 8

// a thread's sums (s, q per channel of its group) -> the CTA's partial
// (2, c) at columns c0.., summed over the group's kGroupRows threads in
// row order; red is kGroupRows x 2 x kNT floats of free shared memory
__device__ __forceinline__ void group_sums_out(const float (&s)[8], const float (&q)[8],
                                               float* red, float* out, int c, int c0,
                                               int ncols) {
  const int tid = threadIdx.x, eg = tid % kGroups, er = tid / kGroups;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    red[(er * 2) * kNT + 8 * eg + e] = s[e];
    red[(er * 2 + 1) * kNT + 8 * eg + e] = q[e];
  }
  __syncthreads();
  if (tid < ncols) {
    float ts = 0.f, tq = 0.f;
    for (int rr = 0; rr < kGroupRows; ++rr) {
      ts += red[(rr * 2) * kNT + tid];
      tq += red[(rr * 2 + 1) * kNT + tid];
    }
    out[c0 + tid] = ts;
    out[c + c0 + tid] = tq;
  }
}

// ---------------------------------------------------------------------------
// fwd: tiles of kTP pixels x kNT output channels (gridDim.y chunks of Co);
// per K chunk the CTA stages h (a thread per pixel and 8 channels, BN + act
// on the way in) and the W chunk, then multiplies; the epilogue stores y
// and takes the moments as the dgrad's does
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
xpw_fwd_kernel(const T* __restrict__ x, const float* __restrict__ bn, const T* __restrict__ w,
               T* __restrict__ y, float* __restrict__ partial, int P, int ci, int co, int relu,
               float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int lda = ld_of(kKC), ldc = kNT + 4;
  T* as = reinterpret_cast<T*>(smem);                        // [kTP][lda] h chunk
  T* bs = as + kTP * lda;                                     // [kNT][lda] W chunk
  float* cs = reinterpret_cast<float*>(smem);                 // [kTP][ldc] the tile
  Bn* bnp = reinterpret_cast<Bn*>(smem + tile_region<T>());   // [ci]
  const int tid = threadIdx.x;
  for (int c = tid; c < ci; c += kThreads) bnp[c] = load_bn(bn, c, eps);
  const int co0 = blockIdx.y * kNT, ncols = min(kNT, co - co0), nt = ncols / 8;
  const int ntiles = (P + kTP - 1) / kTP;
  const int r = tid / (kKC / 8), j = tid % (kKC / 8);   // staging: pixel, 8 channels
  const int eg = tid % kGroups, er = tid / kGroups;      // epilogue: group, first row
  float s[8], q[8];                                      // moments of co0 + 8 eg ..
#pragma unroll
  for (int e = 0; e < 8; ++e) s[e] = q[e] = 0.f;
  __syncthreads();
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int p0 = tile * kTP, np = min(kTP, P - p0);
    float acc[kSlots][4];
    zero(acc);
    for (int k0 = 0; k0 < ci; k0 += kKC) {
      const int c = k0 + 8 * j;
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (r < np && c < ci) {
        load8<T>(x + (size_t)(p0 + r) * ci + c, v);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const Bn b = bnp[c + e];
          v[e] = rounded<T>(act(bn_u(bn_xh(v[e], b), b), relu));
        }
      }
      store8<T>(as + r * lda + 8 * j, v);
      for (int i = tid; i < kNT * (kKC / 8); i += kThreads) {
        const int row = i / (kKC / 8), cj = k0 + 8 * (i % (kKC / 8));
        float wv[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        if (row < ncols && cj < ci) load8<T>(w + (size_t)(co0 + row) * ci + cj, wv);
        store8<T>(bs + row * lda + (cj - k0), wv);
      }
      __syncthreads();
      WarpGemm<T, kMW, kNW, kTileWN>::run(acc, as, lda, bs, lda, nt, kKC);
      __syncthreads();
    }
    tile_to_smem(acc, cs);
    __syncthreads();
    if (eg < nt)
      for (int row = er; row < np; row += kGroupRows) {
        const float* v = cs + row * ldc + 8 * eg;
        store8<T>(y + (size_t)(p0 + row) * co + co0 + 8 * eg, v);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          s[e] += v[e];
          q[e] = fmaf(v[e], v[e], q[e]);
        }
      }
    __syncthreads();
  }
  if (partial != nullptr)   // null: no moments wanted (an eval pass)
    group_sums_out(s, q, cs, partial + (size_t)blockIdx.x * 2 * co, co, co0, ncols);
}

// ---------------------------------------------------------------------------
// dgrad: tiles of kTP pixels x kNT input channels (gridDim.y chunks of Ci);
// per K chunk of Co the CTA stages ga (the next BN's backward on the way
// in) and W^T's chunk, then multiplies. The epilogue gives each thread 8
// channels (a fixed group, with its sums in registers across tiles) and
// every 8th row of the tile; the groups' sums meet in a fixed order at the
// end.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
xpw_dgrad_kernel(const T* __restrict__ gy, const T* __restrict__ an, const float* __restrict__ pn,
                 const T* __restrict__ ak, const float* __restrict__ bnk,
                 const T* __restrict__ w, T* __restrict__ gyk, float* __restrict__ psum, int P,
                 int ci, int co, int relu, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int lda = ld_of(kKC), ldc = kNT + 4;
  T* as = reinterpret_cast<T*>(smem);                        // [kTP][lda] ga chunk
  T* bs = as + kTP * lda;                                     // [kNT][lda] W^T chunk
  float* cs = reinterpret_cast<float*>(smem);                 // [kTP][ldc] gz tile
  Bn* kb = reinterpret_cast<Bn*>(smem + tile_region<T>());   // [kNT] this CTA's BN_k
  BnBwd* nb = reinterpret_cast<BnBwd*>(kb + kNT);             // [co] the next BN
  const int tid = threadIdx.x;
  const bool next = pn != nullptr;
  const int c0 = blockIdx.y * kNT, ncols = min(kNT, ci - c0), nt = ncols / 8;
  if (next)
    for (int o = tid; o < co; o += kThreads) nb[o] = load_bn_bwd(pn, o, eps);
  if (tid < ncols) kb[tid] = load_bn(bnk, c0 + tid, eps);
  const int ntiles = (P + kTP - 1) / kTP;
  const int r = tid / (kKC / 8), j = tid % (kKC / 8);   // staging: pixel, 8 channels
  const int eg = tid % kGroups, er = tid / kGroups;      // epilogue: group, first row
  float s[8], q[8];                                      // sums of channels c0 + 8 eg ..
#pragma unroll
  for (int e = 0; e < 8; ++e) s[e] = q[e] = 0.f;
  __syncthreads();
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int p0 = tile * kTP, np = min(kTP, P - p0);
    float acc[kSlots][4];
    zero(acc);
    for (int k0 = 0; k0 < co; k0 += kKC) {
      const int o = k0 + 8 * j;
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (r < np && o < co) {
        const size_t at = (size_t)(p0 + r) * co + o;
        load8<T>(gy + at, v);
        if (next) {
          float a[8];
          load8<T>(an + at, a);
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = rounded<T>(bn_bwd(v[e], a[e], nb[o + e]));
        }
      }
      store8<T>(as + r * lda + 8 * j, v);
      // W^T's chunk: bs[c][o'] = W[k0 + o'][c0 + c]; consecutive threads take
      // consecutive rows o' of W, so the transposed stores do not collide
      for (int i = tid; i < kKC * (kNT / 8); i += kThreads) {
        const int oo = i % kKC, cg = 8 * (i / kKC);
        float wv[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        if (k0 + oo < co && cg < ncols) load8<T>(w + (size_t)(k0 + oo) * ci + c0 + cg, wv);
#pragma unroll
        for (int e = 0; e < 8; ++e) bs[(cg + e) * lda + oo] = from_f<T>(wv[e]);
      }
      __syncthreads();
      WarpGemm<T, kMW, kNW, kTileWN>::run(acc, as, lda, bs, lda, nt, kKC);
      __syncthreads();
    }
    tile_to_smem(acc, cs);
    __syncthreads();
    if (eg < nt) {
      Bn b[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) b[e] = kb[8 * eg + e];
      for (int row = er; row < np; row += kGroupRows) {
        const size_t at = (size_t)(p0 + row) * ci + c0 + 8 * eg;
        float a[8], g[8];
        load8<T>(ak + at, a);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float xh = bn_xh(a[e], b[e]);
          g[e] = cs[row * ldc + 8 * eg + e] * act_grad(bn_u(xh, b[e]), relu);
          s[e] += g[e];
          q[e] = fmaf(g[e], xh, q[e]);
        }
        store8<T>(gyk + at, g);
      }
    }
    __syncthreads();
  }
  group_sums_out(s, q, cs, psum + (size_t)blockIdx.x * 2 * ci, ci, c0, ncols);
}

// ---------------------------------------------------------------------------
// wgrad: a CTA per (kWM output x kWN input channel tile, pixel split); per K
// chunk of kKP pixels it stages ga^T and z^T (a thread per pixel and 8
// channels, transposed into rows of channels), then multiplies; the split's
// partial leaves from the fragments
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
xpw_wgrad_kernel(const T* __restrict__ gy, const T* __restrict__ an, const float* __restrict__ pn,
                 const T* __restrict__ ak, const float* __restrict__ bnk,
                 float* __restrict__ part, int P, int ci, int co, int relu, float eps,
                 int chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ld = ld_of(kKP);
  T* gs = reinterpret_cast<T*>(smem);                          // [kWM][ld] ga^T
  T* zs = gs + kWM * ld;                                        // [kWN][ld] z^T
  BnBwd* nb = reinterpret_cast<BnBwd*>(zs + kWN * ld);          // [kWM]
  Bn* kb = reinterpret_cast<Bn*>(nb + kWM);                     // [kWN]
  const int tid = threadIdx.x;
  const bool next = pn != nullptr;
  const int ntn = (ci + kWN - 1) / kWN;
  const int o0 = (blockIdx.x / ntn) * kWM, c0 = (blockIdx.x % ntn) * kWN;
  const int mo = min(kWM, co - o0), nc = min(kWN, ci - c0);
  if (tid < kWM && tid < mo && next) nb[tid] = load_bn_bwd(pn, o0 + tid, eps);
  if (tid < kWN && tid < nc) kb[tid] = load_bn(bnk, c0 + tid, eps);
  const int pbeg = blockIdx.y * chunk, pend = min(P, pbeg + chunk);
  const int pp = tid % kKP, grp = tid / kKP;     // staging: pixel, 8-channel groups
  float acc[kSlots][4];
  zero(acc);
  __syncthreads();
  for (int p0 = pbeg; p0 < pend; p0 += kKP) {
    const int p = p0 + pp;
    // ga^T: kWM / 8 = 16 channel groups, two per thread
    for (int g8 = grp; g8 < kWM / 8; g8 += kThreads / kKP) {
      const int o = 8 * g8;
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (p < pend && o < mo) {
        const size_t at = (size_t)p * co + o0 + o;
        load8<T>(gy + at, v);
        if (next) {
          float a[8];
          load8<T>(an + at, a);
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = rounded<T>(bn_bwd(v[e], a[e], nb[o + e]));
        }
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) gs[(o + e) * ld + pp] = from_f<T>(v[e]);
    }
    // z^T, the same way
    for (int g8 = grp; g8 < kWN / 8; g8 += kThreads / kKP) {
      const int c = 8 * g8;
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (p < pend && c < nc) {
        load8<T>(ak + (size_t)p * ci + c0 + c, v);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const Bn b = kb[c + e];
          v[e] = rounded<T>(act(bn_u(bn_xh(v[e], b), b), relu));
        }
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) zs[(c + e) * ld + pp] = from_f<T>(v[e]);
    }
    __syncthreads();
    WarpGemm<T, kMW, kNW, kWgradWN>::run(acc, gs, ld, zs, ld, kWN / 8, kKP);
    __syncthreads();
  }
  float* out = part + (size_t)blockIdx.y * co * ci;
#pragma unroll
  for (int i = 0; i < kSlots; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int2 rc = warp_frag_at<kMW, kNW, kWgradWN>(i, e);
      if (rc.x < mo && rc.y < nc)
        out[(size_t)(o0 + rc.x) * ci + c0 + rc.y] = acc[i][e];
    }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

bool widths_ok(int ci, int co) {
  return ci >= 8 && co >= 8 && ci % 8 == 0 && co % 8 == 0 && ci <= kMaxC && co <= kMaxC;
}

int fwd_grid_x(int P, int cols) {
  const int ntiles = (P + kTP - 1) / kTP, gy = (cols + kNT - 1) / kNT;
  const int cap = kFwdCtas / gy > 0 ? kFwdCtas / gy : 1;
  return ntiles < cap ? ntiles : cap;
}

int wgrad_splits(int P, int ci, int co) {
  const int tiles = ((co + kWM - 1) / kWM) * ((ci + kWN - 1) / kWN);
  const int want = (kWgradCtas + tiles - 1) / tiles;
  const int most = (P + 16 * kKP - 1) / (16 * kKP);   // at least 16 K chunks a split
  return want < most ? want : (most > 0 ? most : 1);
}

int wgrad_chunk(int P, int splits) {
  const int per = (P + splits - 1) / splits;
  return (per + kKP - 1) / kKP * kKP;
}

cudaError_t set_smem(const void* kern, int bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T>
cudaError_t run_fwd(const void* x, const void* bn, const void* w, void* y, void* partial, int P,
                    int ci, int co, int relu, float eps, int grid, cudaStream_t st) {
  const int smem = fwd_smem<T>(ci);
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  auto kern = xpw_fwd_kernel<T>;
  cudaError_t e = set_smem((const void*)kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(grid, (co + kNT - 1) / kNT), kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(bn), static_cast<const T*>(w),
      static_cast<T*>(y), static_cast<float*>(partial), P, ci, co, relu, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_dgrad(const void* gy, const void* an, const void* pn, const void* ak,
                      const void* bnk, const void* w, void* gyk, void* psum, int P, int ci,
                      int co, int relu, float eps, int grid, cudaStream_t st) {
  const int smem = dgrad_smem<T>(co);
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  auto kern = xpw_dgrad_kernel<T>;
  cudaError_t e = set_smem((const void*)kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(grid, (ci + kNT - 1) / kNT), kThreads, smem, st>>>(
      static_cast<const T*>(gy), static_cast<const T*>(an), static_cast<const float*>(pn),
      static_cast<const T*>(ak), static_cast<const float*>(bnk), static_cast<const T*>(w),
      static_cast<T*>(gyk), static_cast<float*>(psum), P, ci, co, relu, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_wgrad(const void* gy, const void* an, const void* pn, const void* ak,
                      const void* bnk, void* part, int P, int ci, int co, int relu, float eps,
                      int splits, cudaStream_t st) {
  const int smem = wgrad_smem<T>();
  auto kern = xpw_wgrad_kernel<T>;
  cudaError_t e = set_smem((const void*)kern, smem);
  if (e != cudaSuccess) return e;
  const int tiles = ((co + kWM - 1) / kWM) * ((ci + kWN - 1) / kWN);
  kern<<<dim3(tiles, splits), kThreads, smem, st>>>(
      static_cast<const T*>(gy), static_cast<const T*>(an), static_cast<const float*>(pn),
      static_cast<const T*>(ak), static_cast<const float*>(bnk), static_cast<float*>(part), P,
      ci, co, relu, eps, wgrad_chunk(P, splits));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Grid sizes the wrapper allocates partials for: kernel 0 (fwd) and 1
// (dgrad) CTAs along x (the partials' first dimension), kernel 2 (wgrad)
// pixel splits. -1 for a width the kernels do not take.
int kdcc_xpw_grid(int kernel, int dtype, int P, int ci, int co) {
  if (!widths_ok(ci, co) || P < 1 || dtype < 0 || dtype > 1) return -1;
  if (kernel == 0) return fwd_grid_x(P, co);
  if (kernel == 1) return fwd_grid_x(P, ci);
  if (kernel == 2) return wgrad_splits(P, ci, co);
  return -1;
}

// forward. x (P, ci), w (co, ci) in dtype; bn (ci, 4) f32 or null; y (P, co)
// in dtype; partial (grid, 2, co) f32, or null for no moments.
int kdcc_xpw_fwd(int dtype, const void* x, const void* bn, const void* w, void* y,
                 void* partial, int P, int ci, int co, int relu, float eps, int grid,
                 void* stream) {
  if (!widths_ok(ci, co) || P < 1 || grid != fwd_grid_x(P, co) || !act_ok(relu))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)run_fwd<float>(x, bn, w, y, partial, P, ci, co, relu, eps, grid, st);
  if (dtype == 1)
    return (int)run_fwd<__nv_bfloat16>(x, bn, w, y, partial, P, ci, co, relu, eps, grid, st);
  return (int)cudaErrorInvalidValue;
}

// backward, input side. gy, an (P, co), ak (P, ci), w (co, ci) in dtype; pn
// (co, 6) f32 or null (then an is not read); bnk (ci, 4) f32 or null; gyk
// (P, ci) in dtype; psum (grid, 2, ci) f32.
int kdcc_xpw_dgrad(int dtype, const void* gy, const void* an, const void* pn, const void* ak,
                   const void* bnk, const void* w, void* gyk, void* psum, int P, int ci, int co,
                   int relu, float eps, int grid, void* stream) {
  if (!widths_ok(ci, co) || P < 1 || grid != fwd_grid_x(P, ci) || !act_ok(relu))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)run_dgrad<float>(gy, an, pn, ak, bnk, w, gyk, psum, P, ci, co, relu, eps, grid,
                                 st);
  if (dtype == 1)
    return (int)run_dgrad<__nv_bfloat16>(gy, an, pn, ak, bnk, w, gyk, psum, P, ci, co, relu,
                                         eps, grid, st);
  return (int)cudaErrorInvalidValue;
}

// backward, weight side. gy, an, ak, pn, bnk as kdcc_xpw_dgrad; part
// (splits, co, ci) f32, one dW partial per pixel split.
int kdcc_xpw_wgrad(int dtype, const void* gy, const void* an, const void* pn, const void* ak,
                   const void* bnk, void* part, int P, int ci, int co, int relu, float eps,
                   int splits, void* stream) {
  if (!widths_ok(ci, co) || P < 1 || splits != wgrad_splits(P, ci, co) || !act_ok(relu))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)run_wgrad<float>(gy, an, pn, ak, bnk, part, P, ci, co, relu, eps, splits, st);
  if (dtype == 1)
    return (int)run_wgrad<__nv_bfloat16>(gy, an, pn, ak, bnk, part, P, ci, co, relu, eps,
                                         splits, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

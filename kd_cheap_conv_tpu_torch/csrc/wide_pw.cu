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
//   y (the next BN's moments: in bf16 the kernel turns them into the batch
//   mean and biased variance), none for a null partial pointer (an eval
//   pass). A null BN is the identity.
// - dgrad: ga = the next BN's train backward of gy (pack (Co, 6); a null
//   pack is the exact identity), formed only at real pixels and rounded;
//   gz = ga . W; gy_k = gz * act'(u_k), u_k = BN_k(a_k) recomputed, stored;
//   the per-channel sums [gy_k, gy_k * xhat_k] as CTA partials.
// - wgrad: dW = ga^T . z with z = act(u_k) rounded to the activation dtype,
//   over pixel splits (f32: each split's partial written, the wrapper sums
//   them in a fixed order; bf16: summed in the kernel, below).
// The BN arithmetic is common.cuh's (rounded as the plain versions' torch
// ops round it), so the relu masks agree with the plain versions bit for
// bit.
//
// Determinism: no float atomics. Every sum has one fixed owner (a thread,
// a fragment slot, a lane after a fixed shuffle pattern) that adds in a
// fixed order; grids and splits depend on the shape only.
//
// What bounds them on an H100: the products' operand traffic. The middle
// flow's 1x1 passes are 9,604 pixels x 728 x 728 (2 x 728 FLOPs per
// activation element read, above the tensor cores' ~295 FLOP/byte), the
// exit flow's up to 1536 -> 2048; a tiled product re-reads each operand
// once per tile of the other side, and the BN prologue re-forms it there.
// The entry flow's passes at 385² and 193² (64 .. 256 channels) are bound
// by their bytes instead.
//
// bfloat16 (namespace xbw): TMA + wgmma. A CTA is two consumer warpgroups
// and a producer warp that keeps a ring of shared-memory stages full by TMA
// (128-byte swizzled boxes of 64 channels, zeros outside the tensor) behind
// full / empty mbarriers. The consumers apply the BN prologue to each stage
// in place, zero what lies outside the tensor (the prologue maps a zero to
// a per-channel constant), fence the writes to the async proxy and multiply
// with wgmma.mma_async (f32 in registers):
// - fwd: M = 128 pixels (a warpgroup each 64), N = 64/128/256 output
//   channels (the width follows Co), K = 64 input channels; A = x and B = W
//   K-major as stored (no transpose). CTA (x, y) keeps the column block y
//   and walks the pixel tiles x, x + gridDim.x, ... (one wave of 132 CTAs
//   over the column blocks: the CTAs of a tile row run together and read x
//   from L2, and each CTA's moments cover fixed columns). The BN constants
//   of all Ci channels sit in shared memory once per CTA, laid out so the
//   8 lanes of a row read adjacent entries; each warpgroup forms h on its
//   own 64 rows. The epilogue leaves y from the fragments, 16 bytes a lane
//   after a quad gather (shuffles), and takes the moments at real rows and
//   columns: at N 256 each tile's column sums go over the 8 lanes that
//   share a column (a shuffle reduce-scatter) into per-lane running sums,
//   below 256 each thread keeps its columns' sums across tiles and reduces
//   once. The CTAs' partials are summed in the kernel over two levels of
//   integer tickets (groups of 12 CTAs, then the groups), each level's
//   loads issued before its adds, and the last adder writes the mean and
//   variance (no torch op after the launch).
// - wgrad: M = 128 output channels (a warpgroup each 64), N = 64/128/256
//   input channels (the width follows Ci), K = 64-pixel chunks. Both
//   operands are stored channels-contiguous, which is MN-major for this
//   product: the wgmma transpose immediates read the TMA boxes as they
//   arrive (desc_sw128_mn), so the prologue rewrites them in place and
//   nothing is transposed. Each warpgroup forms half the rows of both
//   ga = rounded(bn_bwd(gy, a_next)) and z = rounded(act(BN_k(a_k))), its
//   channels fixed, their constants in registers. Pixel splits, about one
//   wave of CTAs (xbw::wgrad_splits): each leaves its f32 fragments in a
//   scratch, coalesced; the CTA that takes a tile's last ticket (an integer
//   atomicAdd) adds the splits in split order and resets the ticket.
// - dgrad: M = 128 pixels, N = 64/128 input channels, K = 64 output
//   channels; A = ga K-major as stored, B = W read through the transpose
//   immediate (no transposed copy). The producer warp writes each chunk's
//   next-BN constants into its stage (no whole-width table); each
//   warpgroup forms ga on its own 64 rows. Persistent CTAs walk pixel
//   tiles; a tile's a_k arrives by TMA in one of two buffers while its
//   chunks stream. The epilogue takes gz from the fragments, recomputes
//   u_k, stores gy_k and reduces the column sums over the 8 lanes that
//   share a column (a shuffle reduce-scatter) into per-warp running sums.
// The f32 instantiations (parity only) are the mma.sync kernels below
// (mma.cuh's WarpGemm on staged operands, synchronous staging).
//
// Shared memory (dynamic; above 48 KB, raised to 227 KB once per kernel):
// - fwd, f32: Ci x 16 (BN constants) + max((kTP + kNT) x ld_of(kKC) x 4,
//          kTP x (kNT + 4) x 4): at Ci = 1536, 91,136 bytes;
// - dgrad, f32: Co x 20 (next-BN constants) + kNT x 16 + the same operand
//          / tile region: at Co = 2048, 111,616 bytes;
// - wgrad, f32: (kWM + kWN) x ld_of(kKP) x 4 + kWM x 20 + kWN x 16: 45,568;
// - fwd, bf16: stages of x (16 KB) + W (BN x 128 B), 4 at BN 256, 6 below
//          (192 KB at most); the BN table (Ci x 16 B); the moments'
//          reduction reuses the stages: 230,480 bytes at BN 256, Ci 2048;
// - wgrad, bf16: stages of (2 + 2 + BN / 64) boxes of 64 x 64 (gy, a_next,
//          a_k; 8 KB each), 3 of 64 KB at BN = 256, 4 of 48 / 40 KB below:
//          197,696 bytes at BN 256;
// - dgrad, bf16: stages of gy + a_next (16 KB each) + W (BN / 64 x 8 KB) +
//          the chunk's constants (1,280 B), 3 at BN 128 (51,200 each), 4 at
//          64; two a_k buffers (BN x 256 B), the per-warp sums (BN x 64 B),
//          BN_k's constants (BN x 16 B): 230,656 bytes at BN 128.
//
// The C entry points launch on the caller's stream and return
// cudaGetLastError(); the Python wrapper raises if it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"
#include "wgmma.cuh"

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
// bf16 backward: TMA + wgmma (csrc/wgmma.cuh; the design is in the header).
// Warpgroups 0 and 1 consume, warpgroup 2's first warp produces.
// ---------------------------------------------------------------------------

namespace xbw {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 384;
constexpr int kBM = 128;               // wgrad: output channels, dgrad: pixels per tile
constexpr int kBK = 64;                // K chunk: wgrad pixels, dgrad output channels
constexpr int kBox = 64 * 64 * 2;      // a box of 64 channels x 64 rows: 8 KB
constexpr int kCtas = 132;             // one wave of one CTA per SM (an H100), fixed so that
                                       // grids and splits depend on the shape alone
constexpr int kWgBK = 64;              // wgrad: pixels a K chunk
constexpr int kMinChunks = 512 / kWgBK;   // wgrad: at least 512 pixels a split
constexpr int kRingMax = 196608;       // the stages' shared memory at most

// wgrad: dW (co, ci) = ga^T . z over pixel splits. Operands MN-major (both
// stored channels-contiguous, K = pixels along the rows): the transpose
// immediates read the TMA boxes as they arrive, so the prologue rewrites
// them in place and nothing is transposed.
template <int BN> struct Wg {
  static constexpr int kBoxK = 64 * kWgBK * 2;        // 64 channels x kWgBK pixels
  static constexpr int kGy = 2 * kBoxK;                // 128 channels
  static constexpr int kAk = (BN / 64) * kBoxK;        // BN channels
  static constexpr int kStage = 2 * kGy + kAk;         // gy, a_next, a_k
  static constexpr int kStages = kRingMax / kStage < 4 ? kRingMax / kStage : 4;
  static constexpr int kSmem = 1024 + kStages * kStage + 2 * kStages * 8 + 16;
  // the z prologue: a thread's (box, 16-byte group) of BN / 8, every
  // kStep-th row of its warpgroup's half
  static constexpr int kGroups = BN / 8, kStep = 128 / kGroups, kRows = kWgBK / kStep;
};

struct WgradArgs {
  const float* pn;    // (co, 6), null: the identity
  const float* bnk;   // (ci, 4), null: the identity
  float* dw;          // (co, ci)
  float4* scratch;    // (tiles, splits, BN / 8, 256): the splits' fragments
  int* tickets;       // (tiles,): zero between launches
  int P, ci, co, relu, splits, cps;   // cps: K chunks a split
  float eps;
};

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
xpw_wgrad_kernel(const __grid_constant__ CUtensorMap map_gy,
                 const __grid_constant__ CUtensorMap map_an,
                 const __grid_constant__ CUtensorMap map_ak, const WgradArgs a) {
  using C = Wg<BN>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(base + C::kStages * C::kStage);
  uint64_t* empty = full + C::kStages;
  int* last = reinterpret_cast<int*>(empty + C::kStages);
  const int tid = threadIdx.x, wg = tid / 128;
  const bool next = a.pn != nullptr;
  const int ntm = (a.co + kBM - 1) / kBM, tile = blockIdx.x, split = blockIdx.y;
  const int o0 = (tile % ntm) * kBM, c0 = (tile / ntm) * BN;   // Co tiles fastest
  const int kbeg = split * a.cps, kend = min((a.P + kWgBK - 1) / kWgBK, kbeg + a.cps);
  if (tid == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], 2);   // one arrival per consumer warpgroup
    }
    hop::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {   // producer: one thread keeps the ring full
    hop::regs_dec<40>();
    if (tid == 256) {
      hop::tma_prefetch_map(&map_gy);
      hop::tma_prefetch_map(&map_ak);
      if (next) hop::tma_prefetch_map(&map_an);
      const uint32_t bytes = (next ? 2 : 1) * C::kGy + C::kAk;
      int s = 0;
      uint32_t ph = 0;
      for (int k = kbeg; k < kend; ++k) {
        hop::mbar_wait(&empty[s], ph ^ 1);
        hop::mbar_expect_tx(&full[s], bytes);
        unsigned char* st = base + s * C::kStage;
        const int p = k * kWgBK;
        for (int b = 0; b < 2; ++b) {
          hop::tma_load_2d(st + b * C::kBoxK, &map_gy, o0 + 64 * b, p, &full[s]);
          if (next) hop::tma_load_2d(st + C::kGy + b * C::kBoxK, &map_an, o0 + 64 * b, p, &full[s]);
        }
        for (int b = 0; b < BN / 64; ++b)
          hop::tma_load_2d(st + 2 * C::kGy + b * C::kBoxK, &map_ak, c0 + 64 * b, p, &full[s]);
        if (++s == C::kStages) s = 0, ph ^= 1;
      }
    }
    return;
  }

  hop::regs_inc<232>();
  // the prologue: warpgroup wg forms rows 32 wg .. 32 wg + 31 of both
  // operands. A thread's 8 channels of each (16-byte group lc of its box)
  // are fixed, so their BN constants stay in registers: ga's box (t >> 3) & 1,
  // rows t / 16 + 8 i; z's box (t % kGroups) / 8, rows t / kGroups + kStep i
  const int t = tid % 128, lc = t & 7, r0 = 32 * wg;
  const int gbox = (t >> 3) & 1, zbox = (t % C::kGroups) >> 3;
  const int go = o0 + 64 * gbox + 8 * lc, zc = c0 + 64 * zbox + 8 * lc;
  const bool go_ok = go < a.co, zc_ok = zc < a.ci;
  float kg[5][8], kz[4][8];   // ga: mean, inv, gi, sgm, sgxm; z: mean, inv, gamma, beta
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const BnBwd b = next && go_ok ? load_bn_bwd(a.pn, go + e, a.eps) : BnBwd{0.f, 0.f, 0.f, 0.f, 0.f};
    kg[0][e] = b.mean, kg[1][e] = b.inv, kg[2][e] = b.gi, kg[3][e] = b.sgm, kg[4][e] = b.sgxm;
    const Bn c = zc_ok ? load_bn(a.bnk, zc + e, a.eps) : Bn{0.f, 0.f, 0.f, 0.f};
    kz[0][e] = c.mean, kz[1][e] = c.inv, kz[2][e] = c.gamma, kz[3][e] = c.beta;
  }

  float d[BN / 2];
  int s = 0, prev = -1;
  uint32_t ph = 0;
  for (int kc = kbeg; kc < kend; ++kc) {
    hop::mbar_wait(&full[s], ph);
    unsigned char* st = base + s * C::kStage;
    const int p0 = kc * kWgBK;
    if (next) {
      bf16* g = reinterpret_cast<bf16*>(st + gbox * C::kBoxK);
      const bf16* an = reinterpret_cast<const bf16*>(st + C::kGy + gbox * C::kBoxK);
#pragma unroll 2
      for (int i = 0; i < kWgBK / 16; ++i) {
        const int r = r0 + (t >> 4) + 8 * i, off = r * 64 + ((lc ^ (r & 7)) << 3);
        const bool ok = go_ok && p0 + r < a.P;
        float v[8], x[8];
        load8<bf16>(g + off, v);
        load8<bf16>(an + off, x);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = ok ? bn_bwd(v[e], x[e], BnBwd{kg[0][e], kg[1][e], kg[2][e], kg[3][e], kg[4][e]})
                    : 0.f;
        store8<bf16>(g + off, v);
      }
    }
    bf16* z = reinterpret_cast<bf16*>(st + 2 * C::kGy + zbox * C::kBoxK);
#pragma unroll 2
    for (int i = 0; i < C::kRows / 2; ++i) {
      const int r = r0 + t / C::kGroups + C::kStep * i, off = r * 64 + ((lc ^ (r & 7)) << 3);
      const bool ok = zc_ok && p0 + r < a.P;
      float v[8];
      load8<bf16>(z + off, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const Bn b{kz[0][e], kz[1][e], kz[2][e], kz[3][e]};
        v[e] = ok ? act(bn_u(bn_xh(v[e], b), b), a.relu) : 0.f;
      }
      store8<bf16>(z + off, v);
    }
    hop::fence_proxy_async();
    hop::named_sync(1, 256);   // both operands of the stage are formed
    hop::fence_regs(d);
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWgBK / 16; ++kk)
      hop::wgmma<BN, 1, 1>(d, hop::desc_sw128_mn(st + wg * C::kBoxK + kk * 2048, C::kBoxK),
                           hop::desc_sw128_mn(st + 2 * C::kGy + kk * 2048, C::kBoxK),
                           (kc > kbeg) | kk);
    hop::wgmma_commit();
    hop::fence_regs(d);
    hop::wgmma_wait<1>();   // the previous chunk's products are done: free its stage
    if (prev >= 0 && t == 0) hop::mbar_arrive(&empty[prev]);
    prev = s;
    if (++s == C::kStages) s = 0, ph ^= 1;
  }
  hop::wgmma_wait<0>();
  hop::fence_regs(d);

  // the splits' sum: each CTA leaves its fragments in the scratch (float4 q
  // of thread tid at q * 256 + tid: coalesced); the CTA that takes a tile's
  // last ticket adds the splits in split order 0..splits-1 and resets the
  // ticket. Who adds depends on timing, what is added and in which order
  // does not: bit-identical sums.
  bool out = true;
  if (a.splits > 1) {
    float4* mine = a.scratch + (size_t)(tile * a.splits + split) * (BN / 8) * 256 + tid;
#pragma unroll
    for (int q = 0; q < BN / 8; ++q)
      __stcg(mine + q * 256, make_float4(d[4 * q], d[4 * q + 1], d[4 * q + 2], d[4 * q + 3]));
    __threadfence();
    hop::named_sync(1, 256);
    if (tid == 0) *last = atomicAdd(&a.tickets[tile], 1) == a.splits - 1;
    hop::named_sync(1, 256);
    out = *last;
    if (out) {
      __threadfence();
      const float4* all = a.scratch + (size_t)tile * a.splits * (BN / 8) * 256 + tid;
#pragma unroll
      for (int q = 0; q < BN / 8; ++q) {
        const float4 v = __ldcg(all + q * 256);
        d[4 * q] = v.x, d[4 * q + 1] = v.y, d[4 * q + 2] = v.z, d[4 * q + 3] = v.w;
      }
      for (int sp = 1; sp < a.splits; ++sp) {
#pragma unroll
        for (int q = 0; q < BN / 8; ++q) {
          const float4 v = __ldcg(all + (sp * (BN / 8) + q) * 256);
          d[4 * q] += v.x, d[4 * q + 1] += v.y, d[4 * q + 2] += v.z, d[4 * q + 3] += v.w;
        }
      }
      if (tid == 0) a.tickets[tile] = 0;
    }
  }
  if (out) {
    const int lane = t % 32, row = o0 + 64 * wg + 16 * (t / 32) + lane / 4;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = c0 + 8 * j + 2 * (lane % 4);
      if (col >= a.ci) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half)
        if (row + 8 * half < a.co)
          *reinterpret_cast<float2*>(a.dw + (size_t)(row + 8 * half) * a.ci + col) =
              make_float2(d[4 * j + 2 * half], d[4 * j + 2 * half + 1]);
    }
  }
}

// dgrad: gz (P, ci) = ga . W with K = co; gy_k = gz * act'(u_k) and its
// per-channel sums. A = ga, K-major as stored (boxes of 64 output channels
// by 128 pixels); B = W (co, ci) read N = ci by K = co, MN-major as stored,
// through the transpose immediate (no transposed copy of W). The producer
// warp also writes the next BN's constants of each K chunk into its stage
// (64 channels x 5 floats), so no whole-width table sits in shared memory.
// a_k, for the epilogue, is staged by TMA too, in two buffers: a tile's is
// loaded as the tile starts, into the buffer the tile before last freed.
template <int BN> struct Dg {
  static constexpr int kA = kBM * 128;                 // 128 pixels x 64 channels
  static constexpr int kB = (BN / 64) * kBox;          // 64 output x BN input channels
  static constexpr int kCst = 5 * 64 * 4;
  static constexpr int kStage = (2 * kA + kB + kCst + 1023) / 1024 * 1024;
  static constexpr int kAk = BN * kBM * 2;             // a_k: 128 pixels x BN channels
  // a lane's column sums of a tile: BN / 4 columns, of gy_k and gy_k xhat_k
  static constexpr int kVals = BN / 2;
  static constexpr int kSums = 8 * 4 * kVals * 4;      // [warp][value][lane % 4] f32
  static constexpr int kFixed = 1024 + 2 * kAk + kSums + BN * (int)sizeof(Bn) + 256;
  static constexpr int kStages = (232448 - kFixed) / kStage < 4 ? (232448 - kFixed) / kStage : 4;
  static constexpr int kSmem = kFixed + kStages * kStage;
  static_assert(kStages >= 2 && kSmem <= 232448, "an H100 CTA's shared memory");
};

struct DgradArgs {
  const float* pn;    // (co, 6), null: the identity (a_next not read)
  const float* bnk;   // (ci, 4), null: the identity
  bf16* gyk;          // (P, ci)
  float* psum;        // (gridDim.x, 2, ci)
  int P, ci, co, relu;
  float eps;
};

// v (N values, lane-private) summed over the 8 lanes that share lane % 4,
// as a reduce-scatter: each xor step keeps half the values (the lower half
// where the lane's bit is 0) and adds the partner's copy of that half; the
// lane ends with values [N/8 b .. N/8 b + N/8) of the sum, b = lane / 4
// (bit 4 the most significant)
template <int N>
__device__ __forceinline__ void reduce_scatter8(const float (&v)[N], float (&out)[N / 8],
                                                int lane) {
  float h1[N / 2], h2[N / 4];
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float keep = b4 ? v[N / 2 + i] : v[i], send = b4 ? v[i] : v[N / 2 + i];
    h1[i] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
  }
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float keep = b3 ? h1[N / 4 + i] : h1[i], send = b3 ? h1[i] : h1[N / 4 + i];
    h2[i] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
  }
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    const float keep = b2 ? h2[N / 8 + i] : h2[i], send = b2 ? h2[i] : h2[N / 8 + i];
    out[i] = keep + __shfl_xor_sync(0xffffffffu, send, 4);
  }
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
xpw_dgrad_kernel(const __grid_constant__ CUtensorMap map_gy,
                 const __grid_constant__ CUtensorMap map_an,
                 const __grid_constant__ CUtensorMap map_w,
                 const __grid_constant__ CUtensorMap map_ak, const DgradArgs a) {
  using C = Dg<BN>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* aks = base + C::kStages * C::kStage;   // [2][BN / 64][kBM][64] a_k
  float* sums = reinterpret_cast<float*>(aks + 2 * C::kAk);
  Bn* kb = reinterpret_cast<Bn*>(sums + C::kSums / 4);
  uint64_t* full = reinterpret_cast<uint64_t*>(kb + BN);
  uint64_t* empty = full + C::kStages;
  uint64_t* ak_full = empty + C::kStages;   // [2]
  uint64_t* ak_empty = ak_full + 2;         // [2]
  const int tid = threadIdx.x, wg = tid / 128;
  const bool next = a.pn != nullptr;
  const int c0 = blockIdx.y * BN;
  const int ntiles = (a.P + kBM - 1) / kBM, kchunks = (a.co + kBK - 1) / kBK;
  if (tid == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      hop::mbar_init(&full[s], next ? 33 : 1);   // the TMA's arrival, and the constants' warp
      hop::mbar_init(&empty[s], 2);
    }
    for (int b = 0; b < 2; ++b) {
      hop::mbar_init(&ak_full[b], 1);
      hop::mbar_init(&ak_empty[b], 256);   // every consumer thread, after its reads
    }
    hop::mbar_init_fence();
  }
  for (int c = tid; c < BN; c += kThreads)
    kb[c] = c0 + c < a.ci ? load_bn(a.bnk, c0 + c, a.eps) : Bn{0.f, 1.f, 1.f, 0.f};
  for (int i = tid; i < C::kSums / 4; i += kThreads) sums[i] = 0.f;
  __syncthreads();

  if (wg == 2) {
    hop::regs_dec<40>();
    const int lane = tid - 256;
    if (tid < 288 && (lane == 0 || next)) {
      if (lane == 0) {
        hop::tma_prefetch_map(&map_gy);
        hop::tma_prefetch_map(&map_w);
        hop::tma_prefetch_map(&map_ak);
        if (next) hop::tma_prefetch_map(&map_an);
      }
      const uint32_t bytes = (next ? 2 : 1) * C::kA + C::kB;
      // the next BN's raw pack for this lane's channels k kBK + lane, + 32 of
      // the coming chunk, loaded a chunk ahead
      float raw[2][6];
      auto fetch = [&](int k) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int o = k * kBK + lane + 32 * h;
#pragma unroll
          for (int f = 0; f < 6; ++f) raw[h][f] = o < a.co ? __ldg(a.pn + 6 * o + f) : 0.f;
        }
      };
      if (next) fetch(0);
      int s = 0, it = 0;
      uint32_t ph = 0;
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++it) {
        const int p0 = tile * kBM, b = it & 1;
        if (lane == 0) {   // the tile's a_k, into the buffer the tile before last freed
          hop::mbar_wait(&ak_empty[b], ((it >> 1) & 1) ^ 1);
          hop::mbar_expect_tx(&ak_full[b], C::kAk);
          for (int j = 0; j < BN / 64; ++j)
            hop::tma_load_2d(aks + b * C::kAk + j * kBM * 128, &map_ak, c0 + 64 * j, p0,
                             &ak_full[b]);
        }
        for (int k = 0; k < kchunks; ++k) {
          hop::mbar_wait(&empty[s], ph ^ 1);
          unsigned char* st = base + s * C::kStage;
          if (lane == 0) {
            hop::mbar_expect_tx(&full[s], bytes);
            hop::tma_load_2d(st, &map_gy, k * kBK, p0, &full[s]);
            if (next) hop::tma_load_2d(st + C::kA, &map_an, k * kBK, p0, &full[s]);
            for (int j = 0; j < BN / 64; ++j)
              hop::tma_load_2d(st + 2 * C::kA + j * kBox, &map_w, c0 + 64 * j, k * kBK, &full[s]);
          }
          if (next) {   // constants of output channels k kBK .. + 63; zeros past co
            float* cst = reinterpret_cast<float*>(st + 2 * C::kA + C::kB);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int cc = lane + 32 * h;
              const float inv = inv_std(raw[h][1], a.eps), im = raw[h][5];
              cst[cc] = raw[h][0], cst[64 + cc] = inv, cst[128 + cc] = __fmul_rn(raw[h][2], inv);
              cst[192 + cc] = __fmul_rn(raw[h][3], im), cst[256 + cc] = __fmul_rn(raw[h][4], im);
            }
            hop::mbar_arrive(&full[s]);
            fetch(k + 1 < kchunks ? k + 1 : 0);
          }
          if (++s == C::kStages) s = 0, ph ^= 1;
        }
      }
    }
    return;
  }

  hop::regs_inc<232>();
  const int t = tid % 128, warp = t / 32, lane = t % 32, lc = t & 7, q = lane % 4;
  float d[BN / 2];   // gz
  int s = 0, it = 0;
  uint32_t ph = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++it) {
    const int p0 = tile * kBM;
    int prev = -1;
    for (int k = 0; k < kchunks; ++k) {
      hop::mbar_wait(&full[s], ph);
      unsigned char* st = base + s * C::kStage;
      if (next) {   // ga on this warpgroup's 64 rows, in place
        const float* cst = reinterpret_cast<const float*>(st + 2 * C::kA + C::kB) + 8 * lc;
        float kv[5][8];
#pragma unroll
        for (int f = 0; f < 5; ++f) {
          const float4 u = reinterpret_cast<const float4*>(cst + 64 * f)[0];
          const float4 w = reinterpret_cast<const float4*>(cst + 64 * f)[1];
          kv[f][0] = u.x, kv[f][1] = u.y, kv[f][2] = u.z, kv[f][3] = u.w;
          kv[f][4] = w.x, kv[f][5] = w.y, kv[f][6] = w.z, kv[f][7] = w.w;
        }
        bf16* g = reinterpret_cast<bf16*>(st);
        const bf16* an = reinterpret_cast<const bf16*>(st + C::kA);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = 64 * wg + (t >> 3) + 16 * i, off = r * 64 + ((lc ^ (r & 7)) << 3);
          const bool ok = p0 + r < a.P;
          float v[8], x[8];
          load8<bf16>(g + off, v);
          load8<bf16>(an + off, x);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            v[e] = ok ? bn_bwd(v[e], x[e],
                               BnBwd{kv[0][e], kv[1][e], kv[2][e], kv[3][e], kv[4][e]})
                      : 0.f;
          store8<bf16>(g + off, v);
        }
        hop::fence_proxy_async();
        hop::named_sync(1 + wg, 128);   // this warpgroup's A rows are formed
      }
      hop::fence_regs(d);
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        hop::wgmma<BN, 0, 1>(d, hop::desc_sw128(st + wg * 64 * 128 + 32 * kk),
                             hop::desc_sw128_mn(st + 2 * C::kA + kk * 2048, kBox), k | kk);
      hop::wgmma_commit();
      hop::fence_regs(d);
      hop::wgmma_wait<1>();
      if (prev >= 0 && t == 0) hop::mbar_arrive(&empty[prev]);
      prev = s;
      if (++s == C::kStages) s = 0, ph ^= 1;
    }
    hop::wgmma_wait<0>();
    hop::fence_regs(d);
    if (t == 0) hop::mbar_arrive(&empty[prev]);

    // epilogue from the fragments: d[4 j + 2 half + e] is (row r + 8 half,
    // column 8 j + 2 q + e); u_k recomputed from the staged a_k. The tile's
    // column sums, v[2 j + e] of gy_k and v[BN / 4 + 2 j + e] of gy_k xhat_k,
    // go over the 8 lanes that share q (a reduce-scatter) into this warp's
    // running sums: each lane owns kVals / 8 of them, added tile by tile
    const int b = it & 1;
    const bf16* ak = reinterpret_cast<const bf16*>(aks + b * C::kAk);
    hop::mbar_wait(&ak_full[b], (it >> 1) & 1);
    const int r = 64 * wg + 16 * warp + lane / 4;
    float v[C::kVals];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = 8 * j + 2 * q;
      v[2 * j] = v[2 * j + 1] = v[BN / 4 + 2 * j] = v[BN / 4 + 2 * j + 1] = 0.f;
      if (c0 + c >= a.ci) continue;
      const Bn bb[2] = {kb[c], kb[c + 1]};
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int rr = r + 8 * half;
        if (p0 + rr >= a.P) continue;
        const float2 av = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            ak + (c >> 6) * kBM * 64 + rr * 64 + ((((c & 63) >> 3) ^ (rr & 7)) << 3) + (c & 7)));
        const float ax[2] = {av.x, av.y};
        float g[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float xh = bn_xh(ax[e], bb[e]);
          g[e] = d[4 * j + 2 * half + e] * act_grad(bn_u(xh, bb[e]), a.relu);
          v[2 * j + e] += g[e];
          v[BN / 4 + 2 * j + e] = fmaf(g[e], xh, v[BN / 4 + 2 * j + e]);
        }
        store2<bf16>(a.gyk + (size_t)(p0 + rr) * a.ci + c0 + c, g[0], g[1]);
      }
    }
    hop::mbar_arrive(&ak_empty[b]);
    float mine[C::kVals / 8];
    reduce_scatter8<C::kVals>(v, mine, lane);
    float* acc = sums + ((4 * wg + warp) * C::kVals + (lane / 4) * (C::kVals / 8)) * 4 + q;
#pragma unroll
    for (int i = 0; i < C::kVals / 8; ++i) acc[4 * i] += mine[i];
  }

  // the CTA's sums: over the 8 consumer warps in order
  hop::named_sync(3, 256);
  if (tid < BN && c0 + tid < a.ci) {
    const int cv = 2 * (tid / 8) + tid % 2, qq = (tid % 8) / 2;
    float ts = 0.f, tq = 0.f;
    for (int w = 0; w < 8; ++w) {
      ts += sums[(w * C::kVals + cv) * 4 + qq];
      tq += sums[(w * C::kVals + BN / 4 + cv) * 4 + qq];
    }
    float* out = a.psum + (size_t)blockIdx.x * 2 * a.ci;
    out[c0 + tid] = ts;
    out[a.ci + c0 + tid] = tq;
  }
}

// fwd: y (P, co) = h . W^T with h = rounded(act(BN(x))), and the per-channel
// sum and sum of squares of the f32 y. A = x, K-major as stored (boxes of 64
// input channels by 128 pixels); B = W (co, ci), K-major as stored (BN output
// channels by 64 input channels). CTA (x, y) keeps output columns y BN .. of
// every kBM-pixel tile x, x + gridDim.x, ...: the CTAs of one x walk the same
// pixel tiles together, so x is read from L2 after its first read, and each
// CTA's moments cover one fixed column block.
template <int BN> struct Fw {
  static constexpr int kA = kBM * 128;                 // 128 pixels x 64 channels
  static constexpr int kB = BN * 128;                  // BN output x 64 input channels
  static constexpr int kStage = kA + kB;
  static constexpr int kStages = kRingMax / kStage < 6 ? kRingMax / kStage : 6;
  // stages, full and empty barriers, the last-CTA flag, then the BN table
  static constexpr int kTable = kStages * kStage + 2 * kStages * 8 + 16;
  static constexpr int smem(int ci) { return 1024 + kTable + ci * (int)sizeof(Bn); }
};
static_assert(1024 + Fw<256>::kTable + kMaxC * 16 <= 232448 &&
                  1024 + Fw<128>::kTable + kMaxC * 16 <= 232448 &&
                  1024 + Fw<64>::kTable + kMaxC * 16 <= 232448,
              "an H100 CTA's shared memory");

// the moments' sum over the CTAs along x: groups of kSumGroup CTAs, each
// column block's tickets kTicketsPerBlock apart (its groups', then the top)
constexpr int kSumGroup = 12, kMaxGroups = (kCtas + kSumGroup - 1) / kSumGroup;
constexpr int kTicketsPerBlock = 16;
static_assert(kMaxGroups < kTicketsPerBlock, "a column block's tickets");

struct FwdArgs {
  const float* bn;    // (ci, 4), null: the identity
  bf16* y;            // (P, co)
  float* scratch;     // (gridDim.x + groups, 2, co): the CTAs' and the groups' moment
                      // partials; null: no moments
  float* moments;     // (2, co): the batch mean and biased variance of y
  int* tickets;       // (gridDim.y, kTicketsPerBlock): zero between launches
  int P, ci, co, relu;
  float eps, inv_p;   // inv_p = 1 / P in f32
};

// the four bf16 pairs a quad holds at one row, word[j] at columns 8 (jb + j)
// + 2 q, regathered so that lane q holds columns 8 (jb + q) .. + 7: in round
// rot, lane q sends its pair for lane (q - rot) % 4 and receives from lane
// (q + rot) % 4 its pair for columns 8 (jb + q) + 2 ((q + rot) % 4)
__device__ __forceinline__ uint4 quad_gather(const uint32_t (&word)[4], int lane) {
  const int q = lane & 3;
  uint32_t out[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int rot = 0; rot < 4; ++rot) {
    const int send = (q - rot) & 3, from = (q + rot) & 3;
    const uint32_t got = __shfl_sync(0xffffffffu,
                                     send == 0 ? word[0] : send == 1 ? word[1]
                                     : send == 2 ? word[2] : word[3],
                                     (lane & ~3) | from);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (from == j) out[j] = got;
  }
  return make_uint4(out[0], out[1], out[2], out[3]);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
xpw_fwd_kernel(const __grid_constant__ CUtensorMap map_x,
               const __grid_constant__ CUtensorMap map_w, const FwdArgs a) {
  using C = Fw<BN>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(base + C::kStages * C::kStage);
  uint64_t* empty = full + C::kStages;
  int* last = reinterpret_cast<int*>(empty + C::kStages);
  // the BN table, [8][ci / 8]: channel 8 i + e at e ci / 8 + i, so that the
  // 8 lanes of a row (8 channels apart) read 8 adjacent entries
  Bn* tab = reinterpret_cast<Bn*>(base + C::kTable);
  const int g8 = a.ci / 8;
  const int tid = threadIdx.x, wg = tid / 128;
  // the prologue rewrites the x box unless it is the identity (a null BN,
  // no activation: the zeros TMA fills in stay zeros)
  const bool pro = a.bn != nullptr || a.relu != 0;
  const bool moments = a.scratch != nullptr;
  const int n0 = blockIdx.y * BN;
  const int ntm = (a.P + kBM - 1) / kBM, kchunks = (a.ci + 63) / 64;
  if (tid == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], 2);   // one arrival per consumer warpgroup
    }
    hop::mbar_init_fence();
  }
  if (pro)
    for (int c = tid; c < a.ci; c += kThreads) tab[(c % 8) * g8 + c / 8] = load_bn(a.bn, c, a.eps);
  __syncthreads();

  if (wg == 2) {   // producer: one thread keeps the ring full
    hop::regs_dec<40>();
    if (tid == 256) {
      hop::tma_prefetch_map(&map_x);
      hop::tma_prefetch_map(&map_w);
      int s = 0;
      uint32_t ph = 0;
      for (int tile = blockIdx.x; tile < ntm; tile += gridDim.x)
        for (int k = 0; k < kchunks; ++k) {
          hop::mbar_wait(&empty[s], ph ^ 1);
          hop::mbar_expect_tx(&full[s], C::kStage);
          unsigned char* st = base + s * C::kStage;
          hop::tma_load_2d(st, &map_x, 64 * k, tile * kBM, &full[s]);
          hop::tma_load_2d(st + C::kA, &map_w, 64 * k, n0, &full[s]);
          if (++s == C::kStages) s = 0, ph ^= 1;
        }
    }
    return;
  }

  hop::regs_inc<232>();
  const int t = tid % 128, warp = t / 32, lane = t % 32, lc = t & 7;
  float d[BN / 2];
  // the moments, one fixed owner each. At BN 256 (registers are short) each
  // tile's column sums of a 32-column block go over the 8 lanes that share
  // a column (a reduce-scatter) into this lane's two running sums of the
  // block, run[2 (jb / 4) + i]; below 256 the thread keeps its own columns'
  // sums across tiles, col[2 j + e] (y) and col[BN / 4 + 2 j + e] (y^2), and
  // reduces them the same way once, at the end
  constexpr bool kTileReduce = BN == 256;
  float run[BN / 16], col[kTileReduce ? 1 : BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 16; ++i) run[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (kTileReduce ? 1 : BN / 2); ++i) col[i] = 0.f;
  int s = 0;
  uint32_t ph = 0;
  for (int tile = blockIdx.x; tile < ntm; tile += gridDim.x) {
    const int p0 = tile * kBM;
    int prev = -1;
    for (int k = 0; k < kchunks; ++k) {
      hop::mbar_wait(&full[s], ph);
      unsigned char* st = base + s * C::kStage;
      if (pro) {   // h on this warpgroup's 64 rows, in place; zero past P and ci
        const int c = 64 * k + 8 * lc;
        const bool c_ok = c < a.ci;
        Bn b[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) b[e] = c_ok ? tab[e * g8 + c / 8] : Bn{0.f, 0.f, 0.f, 0.f};
        bf16* xs = reinterpret_cast<bf16*>(st);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = 64 * wg + (t >> 3) + 16 * i, off = r * 64 + ((lc ^ (r & 7)) << 3);
          const bool ok = c_ok && p0 + r < a.P;
          float v[8];
          load8<bf16>(xs + off, v);
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = ok ? act(bn_u(bn_xh(v[e], b[e]), b[e]), a.relu) : 0.f;
          store8<bf16>(xs + off, v);
        }
        hop::fence_proxy_async();
        hop::named_sync(1 + wg, 128);   // this warpgroup's A rows are formed
      }
      hop::fence_regs(d);
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hop::wgmma<BN, 0, 0>(d, hop::desc_sw128(st + wg * 64 * 128 + 32 * kk),
                             hop::desc_sw128(st + C::kA + 32 * kk), k | kk);
      hop::wgmma_commit();
      hop::fence_regs(d);
      hop::wgmma_wait<1>();   // the previous chunk's products are done: free its stage
      if (prev >= 0 && t == 0) hop::mbar_arrive(&empty[prev]);
      prev = s;
      if (++s == C::kStages) s = 0, ph ^= 1;
    }
    hop::wgmma_wait<0>();
    hop::fence_regs(d);
    if (t == 0) hop::mbar_arrive(&empty[prev]);

    // epilogue from the fragments: d[4 j + 2 half + e] is (row r + 8 half,
    // column 8 j + 2 q + e). Per block of 32 columns: y leaves 16 bytes a
    // lane after a quad gather; the block's column sums of y and y^2 at real
    // rows, v[2 jj + e] and v[8 + 2 jj + e], go to the moments
    const int r = p0 + 64 * wg + 16 * warp + lane / 4, q = lane & 3;
#pragma unroll
    for (int jb = 0; jb < BN / 8; jb += 4) {
      uint32_t word[2][4];
      float v[16];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = jb + jj;
        const bool c_ok = n0 + 8 * j + 2 * q < a.co;
#pragma unroll
        for (int e = 0; e < 2; ++e) v[2 * jj + e] = v[8 + 2 * jj + e] = 0.f;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float y0 = d[4 * j + 2 * half], y1 = d[4 * j + 2 * half + 1];
          word[half][jj] = pack_bf16x2(y0, y1);
          if (c_ok && r + 8 * half < a.P) {
            v[2 * jj] += y0;
            v[2 * jj + 1] += y1;
            v[8 + 2 * jj] = fmaf(y0, y0, v[8 + 2 * jj]);
            v[8 + 2 * jj + 1] = fmaf(y1, y1, v[8 + 2 * jj + 1]);
          }
        }
      }
      const int col8 = n0 + 8 * (jb + q);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const uint4 out = quad_gather(word[half], lane);
        if (col8 < a.co && r + 8 * half < a.P)
          *reinterpret_cast<uint4*>(a.y + (size_t)(r + 8 * half) * a.co + col8) = out;
      }
      if (moments) {
        if constexpr (kTileReduce) {
          float mine[2];
          reduce_scatter8<16>(v, mine, lane);
          run[jb / 2] += mine[0];
          run[jb / 2 + 1] += mine[1];
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            col[2 * jb + i] += v[i];
            col[BN / 4 + 2 * jb + i] += v[8 + i];
          }
        }
      }
    }
  }
  if (!moments) return;   // an eval pass: no moments
  if constexpr (!kTileReduce) {
#pragma unroll
    for (int jb = 0; jb < BN / 8; jb += 4) {
      float v[16], mine[2];
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = col[2 * jb + i], v[8 + i] = col[BN / 4 + 2 * jb + i];
      reduce_scatter8<16>(v, mine, lane);
      run[jb / 2] = mine[0];
      run[jb / 2 + 1] = mine[1];
    }
  }

  // the CTA's partial: column c of the tile (block jb / 4 = c / 32, jj =
  // (c % 32) / 8, q = (c % 8) / 2, e = c % 2) has its sum at lane 4 jj + q
  // and its square at lane 16 + 4 jj + q, value 2 (c / 32) + e, of each of
  // the 8 consumer warps; added over the warps in order. The stages are free
  // once both warpgroups are past their last products.
  float* red = reinterpret_cast<float*>(base);   // [warp][lane][BN / 16]
  hop::named_sync(3, 256);
#pragma unroll
  for (int i = 0; i < BN / 16; ++i) red[((4 * wg + warp) * 32 + lane) * (BN / 16) + i] = run[i];
  hop::named_sync(3, 256);
  const int ncol = min(BN, a.co - n0);
  float* mine = a.scratch + (size_t)blockIdx.x * 2 * a.co + n0;
  if (tid < ncol) {
    const int c = tid, jj = (c % 32) / 8, q = (c % 8) / 2, i = 2 * (c / 32) + c % 2;
    float ts = 0.f, tq = 0.f;
    for (int w = 0; w < 8; ++w) {
      ts += red[(w * 32 + 4 * jj + q) * (BN / 16) + i];
      tq += red[(w * 32 + 16 + 4 * jj + q) * (BN / 16) + i];
    }
    __stcg(mine + c, ts);
    __stcg(mine + a.co + c, tq);
  }
  // the column block's sum over the CTAs along x, in a fixed order over
  // two levels of integer tickets: the CTA that takes the last ticket of
  // its group of kSumGroup CTAs adds the group's partials in CTA order; with
  // more than one group, the last group's adder adds the groups' sums in
  // group order. Each adder resets its ticket. Who adds depends on timing,
  // the order does not.
  const int gx = gridDim.x, grp = blockIdx.x / kSumGroup, x0 = grp * kSumGroup;
  const int x1 = min(gx, x0 + kSumGroup), groups = (gx + kSumGroup - 1) / kSumGroup;
  int* tk = a.tickets + blockIdx.y * kTicketsPerBlock;
  __threadfence();
  hop::named_sync(3, 256);
  if (tid == 0) *last = atomicAdd(&tk[grp], 1) == x1 - x0 - 1;
  hop::named_sync(3, 256);
  if (!*last) return;
  __threadfence();
  if (groups == 1) {   // one group: its sums are the moments
    for (int c = n0 + tid; c < n0 + ncol; c += 256) {
      const float* p = a.scratch + c;
      moments_out(ordered_sum_cg<kSumGroup>(p, gx, 2 * (size_t)a.co),
                  ordered_sum_cg<kSumGroup>(p + a.co, gx, 2 * (size_t)a.co), a.inv_p,
                  a.moments + c, a.moments + a.co + c);
    }
    if (tid == 0) tk[grp] = 0;
    return;
  }
  float* gsum = a.scratch + (size_t)(gx + grp) * 2 * a.co;
  for (int i = tid; i < 2 * ncol; i += 256) {
    const int stat = i / ncol, c = n0 + i % ncol;
    __stcg(gsum + stat * a.co + c,
           ordered_sum_cg<kSumGroup>(a.scratch + (size_t)(2 * x0 + stat) * a.co + c, x1 - x0,
                                     2 * (size_t)a.co));
  }
  if (tid == 0) tk[grp] = 0;
  __threadfence();
  hop::named_sync(3, 256);
  if (tid == 0) *last = atomicAdd(&tk[kTicketsPerBlock - 1], 1) == groups - 1;
  hop::named_sync(3, 256);
  if (!*last) return;
  __threadfence();
  for (int c = n0 + tid; c < n0 + ncol; c += 256) {
    const float* p = a.scratch + (size_t)2 * gx * a.co + c;
    moments_out(ordered_sum_cg<kMaxGroups>(p, groups, 2 * (size_t)a.co),
                ordered_sum_cg<kMaxGroups>(p + a.co, groups, 2 * (size_t)a.co), a.inv_p,
                a.moments + c, a.moments + a.co + c);
  }
  if (tid == 0) tk[kTicketsPerBlock - 1] = 0;
}

// plans, by shape alone
inline int fwd_bn(int co) { return co <= 64 ? 64 : co <= 128 ? 128 : 256; }
// CTAs along x: one wave over the co / BN column blocks, at most a tile each
inline int fwd_grid(int P, int co) {
  const int ntm = (P + kBM - 1) / kBM, bn = fwd_bn(co), ntn = (co + bn - 1) / bn;
  const int want = kCtas / ntn > 1 ? kCtas / ntn : 1;
  return ntm < want ? ntm : want;
}
inline int wgrad_bn(int ci) { return ci <= 64 ? 64 : ci <= 128 ? 128 : 256; }
inline int wgrad_tiles(int ci, int co) {
  const int bn = wgrad_bn(ci);
  return ((co + kBM - 1) / kBM) * ((ci + bn - 1) / bn);
}
// K chunks a pixel split: one wave of CTAs over the tiles, kMinChunks at least
inline int wgrad_cps(int P, int ci, int co) {
  const int chunks = (P + kWgBK - 1) / kWgBK, tiles = wgrad_tiles(ci, co);
  const int want = kCtas / tiles > 1 ? kCtas / tiles : 1;
  const int cps = (chunks + want - 1) / want;
  return cps > kMinChunks ? cps : kMinChunks;
}
inline int wgrad_splits(int P, int ci, int co) {
  const int chunks = (P + kWgBK - 1) / kWgBK, cps = wgrad_cps(P, ci, co);
  return (chunks + cps - 1) / cps;
}
inline int dgrad_bn(int ci) { return ci <= 64 ? 64 : 128; }
inline int dgrad_grid(int P, int ci) {
  const int ntiles = (P + kBM - 1) / kBM, bn = dgrad_bn(ci);
  const int cblocks = (ci + bn - 1) / bn;
  const int want = kCtas / cblocks > 1 ? kCtas / cblocks : 1;
  return ntiles < want ? ntiles : want;
}

template <int BN>
cudaError_t run_wgrad(const void* gy, const void* an, const void* pn, const void* ak,
                      const void* bnk, void* dw, void* scratch, void* tickets, int P, int ci,
                      int co, int relu, float eps, cudaStream_t st) {
  using C = Wg<BN>;
  CUtensorMap mg, ma, mk;
  if (!hop::map_kmajor_bf16(&mg, gy, P, co, kWgBK) ||
      !hop::map_kmajor_bf16(&mk, ak, P, ci, kWgBK))
    return cudaErrorInvalidValue;
  ma = mg;
  if (pn != nullptr && !hop::map_kmajor_bf16(&ma, an, P, co, kWgBK)) return cudaErrorInvalidValue;
  if (ctas_per_sm<xpw_wgrad_kernel<BN>>(kThreads, C::kSmem) < 1) return cudaErrorInvalidValue;
  WgradArgs a{};
  a.pn = static_cast<const float*>(pn);
  a.bnk = static_cast<const float*>(bnk);
  a.dw = static_cast<float*>(dw);
  a.scratch = static_cast<float4*>(scratch);
  a.tickets = static_cast<int*>(tickets);
  a.P = P, a.ci = ci, a.co = co, a.relu = relu, a.eps = eps;
  a.splits = wgrad_splits(P, ci, co), a.cps = wgrad_cps(P, ci, co);
  xpw_wgrad_kernel<BN><<<dim3(wgrad_tiles(ci, co), a.splits), kThreads, C::kSmem, st>>>(mg, ma,
                                                                                      mk, a);
  return cudaGetLastError();
}

template <int BN>
cudaError_t run_dgrad(const void* gy, const void* an, const void* pn, const void* ak,
                      const void* bnk, const void* w, void* gyk, void* psum, int P, int ci,
                      int co, int relu, float eps, cudaStream_t st) {
  using C = Dg<BN>;
  CUtensorMap mg, ma, mw, mk;
  if (!hop::map_kmajor_bf16(&mg, gy, P, co, kBM) || !hop::map_kmajor_bf16(&mw, w, co, ci, kBK) ||
      !hop::map_kmajor_bf16(&mk, ak, P, ci, kBM))
    return cudaErrorInvalidValue;
  ma = mg;
  if (pn != nullptr && !hop::map_kmajor_bf16(&ma, an, P, co, kBM)) return cudaErrorInvalidValue;
  if (ctas_per_sm<xpw_dgrad_kernel<BN>>(kThreads, C::kSmem) < 1) return cudaErrorInvalidValue;
  DgradArgs a{};
  a.pn = static_cast<const float*>(pn);
  a.bnk = static_cast<const float*>(bnk);
  a.gyk = static_cast<bf16*>(gyk);
  a.psum = static_cast<float*>(psum);
  a.P = P, a.ci = ci, a.co = co, a.relu = relu, a.eps = eps;
  const dim3 grid(dgrad_grid(P, ci), (ci + BN - 1) / BN);
  xpw_dgrad_kernel<BN><<<grid, kThreads, C::kSmem, st>>>(mg, ma, mw, mk, a);
  return cudaGetLastError();
}

template <int BN>
cudaError_t run_fwd(const void* x, const void* bn, const void* w, void* y, void* scratch,
                    void* moments, void* tickets, int P, int ci, int co, int relu, float eps,
                    cudaStream_t st) {
  using C = Fw<BN>;
  CUtensorMap mx, mw;
  if (!hop::map_kmajor_bf16(&mx, x, P, ci, kBM) || !hop::map_kmajor_bf16(&mw, w, co, ci, BN))
    return cudaErrorInvalidValue;
  const int smem = C::smem(ci);
  if (ctas_per_sm<xpw_fwd_kernel<BN>>(kThreads, smem) < 1) return cudaErrorInvalidValue;
  FwdArgs a{};
  a.bn = static_cast<const float*>(bn);
  a.y = static_cast<bf16*>(y);
  a.scratch = static_cast<float*>(scratch);
  a.moments = static_cast<float*>(moments);
  a.tickets = static_cast<int*>(tickets);
  a.P = P, a.ci = ci, a.co = co, a.relu = relu, a.eps = eps;
  a.inv_p = 1.0f / (float)P;
  const dim3 grid(fwd_grid(P, co), (co + BN - 1) / BN);
  xpw_fwd_kernel<BN><<<grid, kThreads, smem, st>>>(mx, mw, a);
  return cudaGetLastError();
}

}  // namespace xbw

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

bool widths_ok(int ci, int co) {
  return ci >= 8 && co >= 8 && ci % 8 == 0 && co % 8 == 0 && ci <= kMaxC && co <= kMaxC;
}

bool aligned16(const void* p) { return p != nullptr && reinterpret_cast<uintptr_t>(p) % 16 == 0; }

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
// pixel splits (in float32 the partials' first dimension; in bfloat16 the
// splits the kernel sums itself, ops/stem.py xpw_wgrad_plan mirrors it).
// -1 for a width the kernels do not take.
int kdcc_xpw_grid(int kernel, int dtype, int P, int ci, int co) {
  if (!widths_ok(ci, co) || P < 1 || dtype < 0 || dtype > 1) return -1;
  if (kernel == 0) return dtype == 1 ? xbw::fwd_grid(P, co) : fwd_grid_x(P, co);
  if (kernel == 1) return dtype == 1 ? xbw::dgrad_grid(P, ci) : fwd_grid_x(P, ci);
  if (kernel == 2) return dtype == 1 ? xbw::wgrad_splits(P, ci, co) : wgrad_splits(P, ci, co);
  return -1;
}

// forward. x (P, ci), w (co, ci) in dtype; bn (ci, 4) f32 or null; y (P, co)
// in dtype. float32: partial (grid, 2, co) f32, the CTAs' moments, or null
// for no moments (sums, tickets unused). bfloat16: the TMA + wgmma kernel
// (16-byte aligned tensors); partial is its f32 scratch ((grid + groups, 2,
// co): ops/stem.py xpw_fwd_scratch_floats), or null for no moments;
// moments (2, co) f32 receives the batch mean and biased variance of y;
// tickets (co / BN x 16) int32, zero, left zero.
int kdcc_xpw_fwd(int dtype, const void* x, const void* bn, const void* w, void* y,
                 void* partial, void* moments, void* tickets, int P, int ci, int co, int relu,
                 float eps, int grid, void* stream) {
  if (!widths_ok(ci, co) || P < 1 || dtype < 0 || dtype > 1 ||
      grid != kdcc_xpw_grid(0, dtype, P, ci, co) || !act_ok(relu))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)run_fwd<float>(x, bn, w, y, partial, P, ci, co, relu, eps, grid, st);
  if (!aligned16(x) || !aligned16(w) || !aligned16(y) ||
      (partial != nullptr && (moments == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  switch (xbw::fwd_bn(co)) {
    case 64:
      return (int)xbw::run_fwd<64>(x, bn, w, y, partial, moments, tickets, P, ci, co, relu, eps, st);
    case 128:
      return (int)xbw::run_fwd<128>(x, bn, w, y, partial, moments, tickets, P, ci, co, relu, eps,
                                    st);
    default:
      return (int)xbw::run_fwd<256>(x, bn, w, y, partial, moments, tickets, P, ci, co, relu, eps,
                                    st);
  }
}

// backward, input side. gy, an (P, co), ak (P, ci), w (co, ci) in dtype; pn
// (co, 6) f32 or null (then an is not read); bnk (ci, 4) f32 or null; gyk
// (P, ci) in dtype; psum (grid, 2, ci) f32. bfloat16: the TMA + wgmma
// kernel (16-byte aligned tensors).
int kdcc_xpw_dgrad(int dtype, const void* gy, const void* an, const void* pn, const void* ak,
                   const void* bnk, const void* w, void* gyk, void* psum, int P, int ci, int co,
                   int relu, float eps, int grid, void* stream) {
  if (!widths_ok(ci, co) || P < 1 || !act_ok(relu) || dtype < 0 || dtype > 1 ||
      grid != kdcc_xpw_grid(1, dtype, P, ci, co))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)run_dgrad<float>(gy, an, pn, ak, bnk, w, gyk, psum, P, ci, co, relu, eps, grid,
                                 st);
  if (!aligned16(gy) || !aligned16(ak) || !aligned16(w) || !aligned16(gyk) ||
      (pn != nullptr && !aligned16(an)))
    return (int)cudaErrorInvalidValue;
  if (xbw::dgrad_bn(ci) == 64)
    return (int)xbw::run_dgrad<64>(gy, an, pn, ak, bnk, w, gyk, psum, P, ci, co, relu, eps, st);
  return (int)xbw::run_dgrad<128>(gy, an, pn, ak, bnk, w, gyk, psum, P, ci, co, relu, eps, st);
}

// backward, weight side. gy, an, ak, pn, bnk as kdcc_xpw_dgrad. float32:
// out (splits, co, ci), one dW partial per pixel split (scratch, tickets
// unused). bfloat16: out = dW (co, ci) f32, summed in the kernel; scratch
// (tiles, splits, 128, BN) f32 when splits > 1 (xpw_wgrad_plan), tickets
// (tiles,) int32, zero, left zero.
int kdcc_xpw_wgrad(int dtype, const void* gy, const void* an, const void* pn, const void* ak,
                   const void* bnk, void* out, void* scratch, void* tickets, int P, int ci,
                   int co, int relu, float eps, int splits, void* stream) {
  if (!widths_ok(ci, co) || P < 1 || !act_ok(relu) || dtype < 0 || dtype > 1 ||
      splits != kdcc_xpw_grid(2, dtype, P, ci, co))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)run_wgrad<float>(gy, an, pn, ak, bnk, out, P, ci, co, relu, eps, splits, st);
  if (!aligned16(gy) || !aligned16(ak) || (pn != nullptr && !aligned16(an)) || out == nullptr ||
      (splits > 1 && (scratch == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  switch (xbw::wgrad_bn(ci)) {
    case 64:
      return (int)xbw::run_wgrad<64>(gy, an, pn, ak, bnk, out, scratch, tickets, P, ci, co, relu,
                                     eps, st);
    case 128:
      return (int)xbw::run_wgrad<128>(gy, an, pn, ak, bnk, out, scratch, tickets, P, ci, co,
                                      relu, eps, st);
    default:
      return (int)xbw::run_wgrad<256>(gy, an, pn, ak, bnk, out, scratch, tickets, P, ci, co,
                                      relu, eps, st);
  }
}

}  // extern "C"

// The Xception eval chains' separable conv with every BN folded in: one
// sep conv of an eval-mode Xception block (the config-#3 teacher's middle
// and exit flow, Xception serving) is two launches in bfloat16, a
// depthwise pass and a product:
//   xsep_dw_kernel   t = round_bf16(dw3x3(act(x), taps, dilation d))
//   xsep_mm_kernel   y = b + t . W^T [+ x0 | + bsk + x0 . Wsk^T] [relu]
// and one launch of xsep_eval_kernel (sep_conv.cuh's tile loop) in float32,
// the parity variant.
//
// Replaces the Pallas kernels of kd_cheap_conv_tpu/ops/pallas/xchain.py:
//   _k_block_eval (:99; fused_x_middle_eval :152)           3 sep convs a block
//   _k_seg_eval   (:746; _run_seg_eval :798, fused_x_tail_eval :840)
//                                                           3 sep convs a segment
// The TPU kernels keep a whole block (three sep convs) in VMEM with a
// 3-conv halo. At 728-2048 channels that halo does not fit an H100 CTA's
// 227 KB, so here a block's two intermediates go through device memory, in
// f32 as the TPU kernels keep them.
//
// What it computes (NHWC, P = N * H * W pixels, d the dilation):
//   t[p, c] = sum_tap k[tap, c] * act(x)[p + d * (tap - centre), c]
//             (zero outside each image; act = relu or none)
//   y[p, o] = b[o] + sum_c W[o, c] * round_T(t[p, c])
//             [+ x0[p, o]]                               (identity residual)
//             [+ bsk[o] + sum_c Wsk[o, c] * x0[p, c]]    (1x1 skip)
//   y       = relu(y) if final_relu, stored as Tout
// Rounding points, the JAX kernels': act(x) and the tap sums in f32 (fmaf,
// tap order), t rounded to the activation dtype T (the operand `_mm`
// rounds), W and Wsk in T, f32 sums; a block's first two convs store f32
// (Tout = float), the third rounds once to T. Splitting the bf16 sep conv
// at t changes no operand bit: t is rounded to bf16 before the product in
// both designs.
//
// What bounds it on an H100, and the design:
// - xsep_dw_kernel is bound by bytes (x in, t out; ~112 MB over a middle
//   block's three convs). A CTA owns a channel slice (8 channels a thread,
//   16-byte loads and stores) and walks 2-D pixel tiles; each tile with its
//   d-halo is staged in shared memory by cp.async, double-buffered (the
//   next tile's copies fly while this one is computed; f32 input in a
//   bank-conflict-free two-plane layout); the slice's taps sit in
//   registers. t is formed once per pixel and channel.
// - xsep_mm_kernel is the 1x1 product, above the ~295 FLOP/byte ridge at
//   these widths: a persistent, warp-specialised TMA + wgmma GEMM. One
//   producer warp keeps a 4-stage ring of (128 x 64) t and (256 x 64) W
//   tiles in flight (TMA, 128-byte swizzle, mbarriers; the ragged P, Ci and
//   Co edges arrive as zeros); two consumer warpgroups run
//   wgmma.m64n256k16 on them with f32 sums in registers, and apply bias,
//   residual and relu on the way out (masked stores). The skip is a second
//   K loop over (x0, Wsk) into the same sums. Output tiles go n-fastest so
//   the CTAs that share a t row block run together and t is read from L2.
// Every output has one owner and a fixed K order: both kernels are
// deterministic.
//
// The C entry points launch on the caller's stream and return
// cudaGetLastError(); the Python wrapper raises if it is not 0.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "sep_conv.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// float32: sep_conv.cuh's tile loop, the parity variant
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(sepconv::kThreads, 2)
xsep_eval_kernel(const sepconv::Args<float, float, float> a) {
  sepconv::sep_conv<float, float, float>(a);
}

// ---------------------------------------------------------------------------
// the depthwise pass
// ---------------------------------------------------------------------------

namespace xdw {

constexpr int kThreads = 256;
constexpr int kSmemLimit = 232448;

// a launch's tiling: th x tw output pixels a tile, cs channels a CTA
// (cs / 8 channel groups of 8, a thread each, times 256 / (cs / 8) pixel
// slots), gridDim (grid_x, c / cs)
struct Plan {
  int th, tw, cs, grid_x, smem;
};

// A staged pixel's channels: bfloat16 in channel order (a thread's 8
// channels are one 16-byte chunk); float32 in two planes, channels
// 8 g .. 8 g + 3 at 4 g and 8 g + 4 .. 8 g + 7 at cs / 2 + 4 g, a pixel every
// pixel_stride floats, so that the 8 lanes of a quarter-warp reading their
// 8 channels of consecutive (g, pixel) slots touch 8 distinct bank groups.
__host__ __device__ constexpr int pixel_stride(int cs, int esize) {
  return esize == 4 ? cs + (64 - cs / 2) % 32 : cs;
}
__host__ __device__ constexpr int halo_smem(int th, int tw, int dil, int cs, int esize) {
  return 2 * (th + 2 * dil) * (tw + 2 * dil) * pixel_stride(cs, esize) * esize;
}

template <typename Tin>
__global__ void __launch_bounds__(kThreads, 2)
xsep_dw_kernel(const Tin* __restrict__ x, const float* __restrict__ taps, bf16* __restrict__ t,
               int n, int h, int w, int ci, int dil, int pre_relu, int th, int tw, int cs) {
  extern __shared__ __align__(16) unsigned char smem[];
  Tin* buf[2];
  const int hh = th + 2 * dil, ww = tw + 2 * dil, ps = pixel_stride(cs, sizeof(Tin));
  buf[0] = reinterpret_cast<Tin*>(smem);
  buf[1] = buf[0] + hh * ww * ps;
  const int groups = cs / 8, slots = kThreads / groups;
  const int tid = threadIdx.x, g = tid % groups, slot = tid / groups;
  const int c0 = blockIdx.y * cs;
  const int tiles_w = (w + tw - 1) / tw, tiles_img = ((h + th - 1) / th) * tiles_w;
  const int ntiles = n * tiles_img;
  constexpr int kPer16 = 16 / sizeof(Tin);   // channels in a 16-byte copy
  const int cpp = cs / kPer16;               // copies per pixel

  float kv[9][8];
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) load8<float>(taps + (size_t)tap * ci + c0 + 8 * g, kv[tap]);

  auto stage = [&](int tile, Tin* dst) {
    const int img = tile / tiles_img, r = tile - img * tiles_img;
    const int y0 = (r / tiles_w) * th - dil, x0 = (r % tiles_w) * tw - dil;
    for (int i = tid; i < hh * ww * cpp; i += kThreads) {
      const int pix = i / cpp, part = i - pix * cpp;
      const int yy = y0 + pix / ww, xx = x0 + pix % ww;
      // float32: copy `part` holds channels 4 part .. 4 part + 3, a plane's quad
      const int at = sizeof(Tin) == 4 ? (part & 1) * (cs / 2) + 4 * (part >> 1) : part * kPer16;
      if (yy >= 0 && yy < h && xx >= 0 && xx < w)
        hop::cp_async16(dst + pix * ps + at,
                        x + ((size_t)(img * h + yy) * w + xx) * ci + c0 + part * kPer16);
    }
  };

  int tile = blockIdx.x, cur = 0;
  if (tile < ntiles) stage(tile, buf[0]);
  hop::cp_async_commit();
  for (; tile < ntiles; tile += gridDim.x) {
    if (tile + (int)gridDim.x < ntiles) stage(tile + gridDim.x, buf[cur ^ 1]);
    hop::cp_async_commit();
    hop::cp_async_wait<1>();
    __syncthreads();
    const int img = tile / tiles_img, r = tile - img * tiles_img;
    const int y0 = (r / tiles_w) * th, x0 = (r % tiles_w) * tw;
    const Tin* src = buf[cur];
    if (slot < slots)
      for (int q = slot; q < th * tw; q += slots) {
        const int qy = q / tw, qx = q - qy * tw, oy = y0 + qy, ox = x0 + qx;
        if (oy >= h || ox >= w) continue;
        float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int ti = 0; ti < 3; ++ti) {
          const int yy = oy + (ti - 1) * dil;
          if (yy < 0 || yy >= h) continue;
#pragma unroll
          for (int tj = 0; tj < 3; ++tj) {
            const int xx = ox + (tj - 1) * dil;
            if (xx < 0 || xx >= w) continue;
            float xv[8];
            const Tin* px = src + ((qy + ti * dil) * ww + qx + tj * dil) * ps;
            if constexpr (sizeof(Tin) == 4) {
              const float4 lo = *reinterpret_cast<const float4*>(px + 4 * g);
              const float4 hi = *reinterpret_cast<const float4*>(px + cs / 2 + 4 * g);
              xv[0] = lo.x, xv[1] = lo.y, xv[2] = lo.z, xv[3] = lo.w;
              xv[4] = hi.x, xv[5] = hi.y, xv[6] = hi.z, xv[7] = hi.w;
            } else {
              load8<Tin>(px + 8 * g, xv);
            }
#pragma unroll
            for (int e = 0; e < 8; ++e)
              v[e] = fmaf(kv[ti * 3 + tj][e], pre_relu ? fmaxf(xv[e], 0.f) : xv[e], v[e]);
          }
        }
        store8<bf16>(t + ((size_t)(img * h + oy) * w + ox) * ci + c0 + 8 * g, v);
      }
    __syncthreads();
    cur ^= 1;
  }
  hop::cp_async_wait<0>();
}

// the largest channel slice of at most 8 groups that divides ci, a tile of
// about 8 x 16 pixels cut evenly over the image (halved while its halo does
// not fit), and a grid of at most the CTAs the card holds at once
template <typename Tin> bool plan(Plan& p, int n, int h, int w, int ci, int dil) {
  int groups = 8;
  while ((ci / 8) % groups) --groups;
  p.cs = 8 * groups;
  p.th = (h + (h + 7) / 8 - 1) / ((h + 7) / 8);
  p.tw = (w + (w + 15) / 16 - 1) / ((w + 15) / 16);
  while (halo_smem(p.th, p.tw, dil, p.cs, sizeof(Tin)) > kSmemLimit && (p.th > 1 || p.tw > 1)) {
    if (p.th >= p.tw) p.th = (p.th + 1) / 2;
    else p.tw = (p.tw + 1) / 2;
  }
  p.smem = halo_smem(p.th, p.tw, dil, p.cs, sizeof(Tin));
  if (p.smem > kSmemLimit) return false;
  const int per_sm = ctas_per_sm<xsep_dw_kernel<Tin>>(kThreads, p.smem);
  if (per_sm < 1) return false;
  const int slices = ci / p.cs;
  const int ntiles = n * ((h + p.th - 1) / p.th) * ((w + p.tw - 1) / p.tw);
  const int want = per_sm * sm_count() / slices;   // one wave: every CTA resident
  p.grid_x = std::max(1, std::min(ntiles, want));
  return true;
}

template <typename Tin>
cudaError_t run(const void* x, const void* taps, void* t, int n, int h, int w, int ci, int dil,
                int pre_relu, cudaStream_t st) {
  Plan p;
  if (!plan<Tin>(p, n, h, w, ci, dil)) return cudaErrorInvalidValue;
  xsep_dw_kernel<Tin><<<dim3(p.grid_x, ci / p.cs), kThreads, p.smem, st>>>(
      static_cast<const Tin*>(x), static_cast<const float*>(taps), static_cast<bf16*>(t), n, h,
      w, ci, dil, pre_relu, p.th, p.tw, p.cs);
  return cudaGetLastError();
}

}  // namespace xdw

// ---------------------------------------------------------------------------
// the product
// ---------------------------------------------------------------------------

namespace xmm {

constexpr int kBM = 128, kBN = 256, kBK = 64, kStages = 4;
constexpr int kThreads = 384;   // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int kABytes = kBM * kBK * 2, kBBytes = kBN * kBK * 2;
constexpr int kSmem = 1024 + kStages * (kABytes + kBBytes) + 2 * kStages * 8;
static_assert(kSmem <= 232448, "an H100 CTA's shared memory");

template <typename Tout> struct Args {
  const float* b;     // (co,)
  const bf16* res;    // residual 1: (P, co)
  const float* bsk;   // residual 2: (co,)
  Tout* y;            // (P, co)
  int P, co, kc, kc2, residual, final_relu;   // kc, kc2: K chunks of t and of the skip
};

template <typename Tout>
__global__ void __launch_bounds__(kThreads, 1)
xsep_mm_kernel(const __grid_constant__ CUtensorMap map_t, const __grid_constant__ CUtensorMap map_w,
               const __grid_constant__ CUtensorMap map_x0, const __grid_constant__ CUtensorMap map_wsk,
               const Args<Tout> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* sa = reinterpret_cast<bf16*>(base);                            // [stage][kBM][kBK]
  bf16* sb = reinterpret_cast<bf16*>(base + kStages * kABytes);        // [stage][kBN][kBK]
  uint64_t* full = reinterpret_cast<uint64_t*>(base + kStages * (kABytes + kBBytes));
  uint64_t* empty = full + kStages;
  const int tid = threadIdx.x, wg = tid / 128;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], 2);   // one arrival per consumer warpgroup
    }
    hop::mbar_init_fence();
  }
  __syncthreads();
  const int ntn = (a.co + kBN - 1) / kBN, tiles = ((a.P + kBM - 1) / kBM) * ntn;
  const int chunks = a.kc + a.kc2;

  if (wg == 2) {   // producer: one thread keeps the ring full
    hop::regs_dec<40>();
    if (tid == 256) {
      hop::tma_prefetch_map(&map_t);
      hop::tma_prefetch_map(&map_w);
      if (a.kc2) {
        hop::tma_prefetch_map(&map_x0);
        hop::tma_prefetch_map(&map_wsk);
      }
      int s = 0;
      uint32_t ph = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / ntn) * kBM, n0 = (tile % ntn) * kBN;
        for (int k = 0; k < chunks; ++k) {
          hop::mbar_wait(&empty[s], ph ^ 1);
          hop::mbar_expect_tx(&full[s], kABytes + kBBytes);
          const bool skip = k >= a.kc;
          const int kk = (skip ? k - a.kc : k) * kBK;
          hop::tma_load_2d(sa + s * kBM * kBK, skip ? &map_x0 : &map_t, kk, m0, &full[s]);
          hop::tma_load_2d(sb + s * kBN * kBK, skip ? &map_wsk : &map_w, kk, n0, &full[s]);
          if (++s == kStages) s = 0, ph ^= 1;
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg multiplies rows 64 wg .. 64 wg + 63 of a tile
  hop::regs_inc<232>();
  float d[128];
  int s = 0;
  uint32_t ph = 0;
  const int warp = (tid % 128) / 32, lane = tid % 32;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile / ntn) * kBM, n0 = (tile % ntn) * kBN;
    int prev = -1;
    for (int k = 0; k < chunks; ++k) {
      hop::mbar_wait(&full[s], ph);
      const bf16* as = sa + s * kBM * kBK + wg * 64 * kBK;
      const bf16* bs = sb + s * kBN * kBK;
      hop::fence_regs(d);
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        hop::wgmma_m64n256k16<0, 0>(d, hop::desc_sw128(as + 16 * kk),
                                    hop::desc_sw128(bs + 16 * kk), (k | kk) != 0);
      hop::wgmma_commit();
      hop::fence_regs(d);
      hop::wgmma_wait<1>();   // the previous chunk's products are done: free its stage
      if (prev >= 0 && tid % 128 == 0) hop::mbar_arrive(&empty[prev]);
      prev = s;
      if (++s == kStages) s = 0, ph ^= 1;
    }
    hop::wgmma_wait<0>();
    hop::fence_regs(d);
    if (tid % 128 == 0) hop::mbar_arrive(&empty[prev]);
    // epilogue: d[4 j + 2 half + e] is (row r0 + 8 half, column 8 j + 2 q + e),
    // q = lane % 4. Per block of 4 j (32 columns) and row, each lane of a
    // quad loads 16 bytes of the residual, columns 8 (jb + q) .. + 7 (the
    // quad reads 64 contiguous bytes), and four shuffles hand each lane its
    // bf16 pair of every j. A block's loads (the biases through the
    // read-only path too) all go out before its arithmetic.
    const int r0 = m0 + wg * 64 + warp * 16 + lane / 4, q = lane % 4;
#pragma unroll
    for (int jb = 0; jb < kBN / 8; jb += 4) {
      uint32_t add[2][4] = {{0u, 0u, 0u, 0u}, {0u, 0u, 0u, 0u}};   // bf16 pairs, by j - jb
      float2 bias[4], bsk[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + 8 * (jb + j) + 2 * q;
        bias[j] = bsk[j] = make_float2(0.f, 0.f);
        if (col >= a.co) continue;
        bias[j] = __ldg(reinterpret_cast<const float2*>(a.b + col));
        if (a.residual == 2) bsk[j] = __ldg(reinterpret_cast<const float2*>(a.bsk + col));
      }
      if (a.residual == 1) {
        const int col8 = n0 + 8 * (jb + q);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          uint4 v = make_uint4(0u, 0u, 0u, 0u);
          if (col8 < a.co && r0 + 8 * half < a.P)
            v = __ldg(reinterpret_cast<const uint4*>(a.res + (size_t)(r0 + 8 * half) * a.co + col8));
          const uint32_t word[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int rot = 0; rot < 4; ++rot) {
            // lane q sends its pair for the receiver (q - rot) % 4 and
            // receives from lane (q + rot) % 4 its pair for column 2 q
            const int send = (q - rot) & 3, from = (q + rot) & 3;
            const uint32_t got = __shfl_sync(0xffffffffu,
                                             send == 0 ? word[0] : send == 1 ? word[1]
                                             : send == 2 ? word[2] : word[3],
                                             (lane & ~3) | from);
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (from == j) add[half][j] = got;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + 8 * (jb + j) + 2 * q;
        if (col >= a.co) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = r0 + 8 * half;
          if (row >= a.P) continue;
          const int i = 4 * (jb + j) + 2 * half;
          const float2 res = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&add[half][j]));
          float v0 = d[i] + bias[j].x, v1 = d[i + 1] + bias[j].y;
          v0 += res.x + bsk[j].x;   // one of the two is zero
          v1 += res.y + bsk[j].y;
          if (a.final_relu) {
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
          }
          store2<Tout>(a.y + (size_t)row * a.co + col, v0, v1);
        }
      }
    }
  }
}

template <typename Tout>
cudaError_t run(const void* t, const void* w, const void* b, const void* x0, const void* wsk,
                const void* bsk, void* y, int P, int ci, int co, int c0, int residual,
                int final_relu, cudaStream_t st) {
  CUtensorMap mt, mw, mx, mk;
  if (!hop::map_kmajor_bf16(&mt, t, P, ci, kBM) || !hop::map_kmajor_bf16(&mw, w, co, ci, kBN))
    return cudaErrorInvalidValue;
  mx = mt, mk = mw;
  if (residual == 2 &&
      (!hop::map_kmajor_bf16(&mx, x0, P, c0, kBM) || !hop::map_kmajor_bf16(&mk, wsk, co, c0, kBN)))
    return cudaErrorInvalidValue;
  Args<Tout> a{};
  a.b = static_cast<const float*>(b);
  a.res = static_cast<const bf16*>(x0);
  a.bsk = static_cast<const float*>(bsk);
  a.y = static_cast<Tout*>(y);
  a.P = P, a.co = co, a.kc = (ci + kBK - 1) / kBK;
  a.kc2 = residual == 2 ? (c0 + kBK - 1) / kBK : 0;
  a.residual = residual, a.final_relu = final_relu;
  if (ctas_per_sm<xsep_mm_kernel<Tout>>(kThreads, kSmem) < 1) return cudaErrorInvalidValue;
  const int tiles = ((P + kBM - 1) / kBM) * ((co + kBN - 1) / kBN);
  xsep_mm_kernel<Tout><<<std::min(tiles, sm_count()), kThreads, kSmem, st>>>(mt, mw, mx, mk, a);
  return cudaGetLastError();
}

}  // namespace xmm

bool width_ok(int c) { return c >= 8 && c % 8 == 0; }

bool aligned16(const void* p) { return p != nullptr && reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// The float32 folded separable conv in one launch (the parity variant).
// x (P, ci), taps (9, ci), w (co, ci), b (co), y (P, co), all f32.
// residual 0: none; 1: x0 (P, co) added; 2: the 1x1 skip, x0 (P, c0), wsk
// (co, c0), bsk (co).
int kdcc_xsep_eval(const void* x, const void* taps, const void* w, const void* b, const void* x0,
                   const void* wsk, const void* bsk, void* y, int n, int h, int wd, int ci,
                   int co, int c0, int dil, int pre_relu, int residual, int final_relu,
                   void* stream) {
  if (!width_ok(ci) || !width_ok(co) || n < 1 || h < 1 || wd < 1 || dil < 1 ||
      residual < 0 || residual > 2 || (residual >= 1 && x0 == nullptr) ||
      (residual == 2 && (!width_ok(c0) || wsk == nullptr || bsk == nullptr)))
    return (int)cudaErrorInvalidValue;
  sepconv::Args<float, float, float> a{};
  a.x0 = static_cast<const float*>(x);
  a.taps = static_cast<const float*>(taps);
  a.w = static_cast<const float*>(w);
  a.b = static_cast<const float*>(b);
  a.res = static_cast<const float*>(x0);
  a.wsk = static_cast<const float*>(wsk);
  a.bsk = static_cast<const float*>(bsk);
  a.y = static_cast<float*>(y);
  a.n = n, a.h = h, a.w_ = wd, a.c0 = ci, a.co = co, a.cs = c0, a.k = 3, a.dil = dil;
  a.pre_relu = pre_relu, a.residual = residual, a.final_relu = final_relu;
  const int tiles = (n * h * wd + sepconv::kTP - 1) / sepconv::kTP;   // one a CTA
  return (int)sepconv::launch(xsep_eval_kernel, a, tiles, static_cast<cudaStream_t>(stream));
}

// The bfloat16 sep conv's depthwise pass: t (P, ci) bf16 from x (n, h, wd,
// ci) in float32 (in_dt 0) or bfloat16 (in_dt 1) and taps (9, ci) f32.
int kdcc_xsep_dw(int in_dt, const void* x, const void* taps, void* t, int n, int h, int wd,
                 int ci, int dil, int pre_relu, void* stream) {
  if (!width_ok(ci) || n < 1 || h < 1 || wd < 1 || dil < 1 || !aligned16(x) ||
      !aligned16(taps) || !aligned16(t))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_dt == 0) return (int)xdw::run<float>(x, taps, t, n, h, wd, ci, dil, pre_relu, st);
  if (in_dt == 1) return (int)xdw::run<bf16>(x, taps, t, n, h, wd, ci, dil, pre_relu, st);
  return (int)cudaErrorInvalidValue;
}

// The bfloat16 sep conv's product: y (P, co) in float32 (out_dt 0) or
// bfloat16 (out_dt 1) from t (P, ci), w (co, ci) bf16 and b (co) f32;
// residual 0: none; 1: x0 (P, co) bf16 added; 2: the 1x1 skip, x0 (P, c0),
// wsk (co, c0) bf16, bsk (co) f32.
int kdcc_xsep_mm(int out_dt, const void* t, const void* w, const void* b, const void* x0,
                 const void* wsk, const void* bsk, void* y, int P, int ci, int co, int c0,
                 int residual, int final_relu, void* stream) {
  if (!width_ok(ci) || !width_ok(co) || P < 1 || residual < 0 || residual > 2 ||
      !aligned16(t) || !aligned16(w) || b == nullptr || (residual >= 1 && x0 == nullptr) ||
      (residual == 2 && (!width_ok(c0) || !aligned16(x0) || !aligned16(wsk) || bsk == nullptr)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_dt == 0)
    return (int)xmm::run<float>(t, w, b, x0, wsk, bsk, y, P, ci, co, c0, residual, final_relu,
                                st);
  if (out_dt == 1)
    return (int)xmm::run<bf16>(t, w, b, x0, wsk, bsk, y, P, ci, co, c0, residual, final_relu,
                               st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

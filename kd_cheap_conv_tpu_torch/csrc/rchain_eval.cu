// Eval-mode ResNet bottleneck, every BN folded into its conv, one launch per
// block (the teacher's layer1 and layer2[1:]).
//
// Replaces the Pallas kernels of kd_cheap_conv_tpu/ops/pallas/:
//   rchain.py      fused_resnet_blocks_eval      (_k_bneck_eval, one call per block)
//   rchain_hwnc.py fused_resnet_stage_eval_hwnc  (_k_stage, one call per run of blocks)
// Both compute the same function in two TPU layouts; here it is one launch
// per block, of bnk::bneck_eval_kernel<NP> in bfloat16 and of
// bneck_eval_kernel<float> in float32 (the parity variant):
//   h1 = relu(x . W1 + b1)             1x1, C -> Cm; 0 outside the image
//   h2 = relu(conv3x3(h1, W2) + b2)    stride 1, dilation 1, zero pad 1
//   y  = relu(h2 . W3 + b3 + skip)     skip = x, or x . Wd + bd (1x1 / s1)
// with the JAX kernels' rounding points: products of operands in the
// activation dtype summed in f32, h1 and h2 rounded to the activation dtype
// as the next product's operand, the skip added in f32, y rounded once.
// Weights arrive folded (the wrapper scales each conv by its BN's
// gamma * rsqrt(var + eps) in f32 and casts); biases are f32.
//
// What bounds it on an H100: bytes, barely. At config #2 (16 x 129² x 64/256
// -> 256 with Cm 64, 16 x 65² x 512 -> 512 with Cm 128, bf16) the six blocks
// move 1.131 GB (0.338 ms at 3.35 TB/s) for 2.26e11 FLOPs (0.229 ms at 989
// TFLOP/s): ~200 FLOP per byte, near the ridge, so the products must run on
// the tensor cores at a good share of their rate, and h1 and h2 must stay
// out of device memory. The bf16 design (bnk):
// - a persistent grid of one CTA per SM walks output tiles of th x tw
//   pixels (ops/rchain.py plan_bf16: at 129² and 65², 5 x 22); one producer
//   warp keeps a ring of 2..4 stages full by TMA (the x halo box as a 4-D
//   box of the NHWC tensor, zeros outside the image; the weight chunks as
//   128-byte-swizzled boxes), so copies overlap the products, and the
//   weights stream from L2 once per tile of ~110 outputs;
// - two consumer warpgroups run every product on wgmma with f32 sums in
//   registers. Phase 1 multiplies the halo box directly (its zero fill is
//   not h1's zero: the epilogue writes 0 at pixels outside the image);
//   h1 goes to shared memory as [channel group of 8][row][8], the layout
//   of a K-major operand without swizzle, whose descriptor may start at
//   any row. The computed rows of a tile are r (tw + 2) + c, the halo
//   width (the 2 extra columns a row are computed and discarded), so each
//   3x3 tap's A is one contiguous row range of h1, read in place. h2 stays
//   in registers: the phase-2 accumulators are the layout of phase 3's A
//   fragments (wgmma with A from registers);
// - phase 3 runs in passes of 128 output channels; the downsample's x box
//   of the output pixels and Wd go into the same sums; bias, skip, relu and
//   one rounding on the way out.
// The float32 variant (parity checks) runs a CTA per th x tw tile, stages
// 64-channel K chunks synchronously and runs the products on FMAs in the
// mma fragment's layout (no TF32), so its results stay exact to f32
// rounding.
//
// Determinism: no cross-CTA sums; each output is one thread's fixed-order
// sum, so the result is bit-identical from run to run.
//
// The C entry point launches on the caller's stream and returns
// cudaGetLastError(); the Python wrapper raises if it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kKC = 64;                   // K chunk of every streamed operand
constexpr int kNW = 8;                    // 16x8 output tiles of a warp unit (64 channels)
constexpr int kS1 = 3, kS2 = 2, kS3 = 2;  // units per warp in phases 1, 2, 3
constexpr int kSmemMax = 232448;          // an H100 CTA's shared memory

struct Geom {
  int n, h, w, c, cm, co, ds;  // image, widths, has the downsample
  int th, tw, tiles_w;         // output tile
  int nc;                      // phase 3: output channels per pass
};

__host__ __device__ inline int r16(int v) { return (v + 15) / 16 * 16; }
__host__ __device__ inline size_t round16(size_t b) { return (b + 15) / 16 * 16; }

// Shared-memory layout (element offsets of T; each part starts 16-byte
// aligned). ops/rchain.py `smem_bytes` computes the same total and the
// launcher checks that the two agree.
struct Smem {
  int hw, hp, hpp, op, opp;  // halo width, halo and output pixels (and padded to 16)
  int cmp, ld1, ldk;         // Cm padded to 16; row strides of h1/h2 and of staged chunks
  size_t h1, h2, xa, wb, total_bytes;
};

__host__ __device__ inline Smem smem_layout(const Geom& g, int esize) {
  Smem s;
  s.hw = g.tw + 2;
  s.hp = (g.th + 2) * s.hw;
  s.hpp = r16(s.hp);
  s.op = g.th * g.tw;
  s.opp = r16(s.op);
  s.cmp = r16(g.cm);
  s.ld1 = s.cmp + 8;   // +8 elements: fragment loads stay off one bank
  s.ldk = kKC + 8;
  const int rows_a = s.hpp > s.opp ? s.hpp : s.opp;
  const int rows_b = g.cm > g.nc ? g.cm : g.nc;
  size_t o = 0;
  s.h1 = o; o += round16((size_t)s.hpp * s.ld1 * esize);
  s.h2 = o; o += round16((size_t)s.opp * s.ld1 * esize);
  s.xa = o; o += round16((size_t)rows_a * s.ldk * esize);
  s.wb = o; o += round16((size_t)rows_b * s.ldk * esize);
  s.total_bytes = o;
  s.h1 /= esize; s.h2 /= esize; s.xa /= esize; s.wb /= esize;
  return s;
}

__host__ __device__ inline int units(int mt, int nt) { return mt * ((nt + kNW - 1) / kNW); }

// ---------------------------------------------------------------------------
// float32: the products on FMAs in mma.m16n8k16's fragment layout. A warp
// unit is 16 rows (one m-tile) x up to kNW n-tiles. The A
// operand is given as one row pointer per fragment row (rows g and g + 8 of
// the m-tile, g = lane / 4), so shifted or gathered rows cost nothing; B is
// Bt[n][k] (row-major, K contiguous) in shared memory. Value e of tile j is
// D[g + 8 (e / 2)][8 j + 2 t + e % 2], t = lane % 4: PTX mma.m16n8k16's
// fragment layout.
// ---------------------------------------------------------------------------

template <typename T> struct Frag;
template <> struct Frag<float> {
  const float* r0;
  const float* r1;
  __device__ __forceinline__ void load(const float* p0, const float* p1, int) {
    r0 = p0;
    r1 = p1;
  }
  __device__ __forceinline__ void mma(float d[4], const float* bt, int ldb, int lane) const {
    const int t = lane & 3;
    const float *b0 = bt + 2 * t * ldb, *b1 = bt + (2 * t + 1) * ldb;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      d[0] = fmaf(r0[k], b0[k], d[0]);
      d[1] = fmaf(r0[k], b1[k], d[1]);
      d[2] = fmaf(r1[k], b0[k], d[2]);
      d[3] = fmaf(r1[k], b1[k], d[3]);
    }
  }
};

template <int S> __device__ __forceinline__ void zero(float (&acc)[S][kNW][4]) {
#pragma unroll
  for (int i = 0; i < S; ++i)
#pragma unroll
    for (int j = 0; j < kNW; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
}

// acc += A (mt m-tiles, rows from `rows(r)` at column 0) . Bt^T (nt n-tiles),
// K (a multiple of 16) deep
template <typename T, int S, typename Rows>
__device__ __forceinline__ void gemm(float (&acc)[S][kNW][4], const Rows& rows, const T* bt,
                                     int ldb, int mt, int nt, int K) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2;
  const int groups = (nt + kNW - 1) / kNW;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const int u = warp + i * kWarps;
    if (u < mt * groups) {
      const int m = u / groups, n0 = (u - m * groups) * kNW;
      const T* r0 = rows(m * 16 + g);
      const T* r1 = rows(m * 16 + g + 8);
      for (int k0 = 0; k0 < K; k0 += 16) {
        Frag<T> f;
        f.load(r0 + k0, r1 + k0, lane & 3);
#pragma unroll
        for (int j = 0; j < kNW; ++j)
          if (n0 + j < nt) f.mma(acc[i][j], bt + (size_t)(n0 + j) * 8 * ldb + k0, ldb, lane);
      }
    }
  }
}

// fn(row, col, v0, v1) for each pair of adjacent columns a thread holds
template <int S, typename Fn>
__device__ __forceinline__ void for_each(float (&acc)[S][kNW][4], int mt, int nt,
                                         const Fn& fn) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int groups = (nt + kNW - 1) / kNW;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const int u = warp + i * kWarps;
    if (u < mt * groups) {
      const int m = u / groups, n0 = (u - m * groups) * kNW;
#pragma unroll
      for (int j = 0; j < kNW; ++j)
        if (n0 + j < nt)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            fn(m * 16 + (lane >> 2) + 8 * hh, (n0 + j) * 8 + 2 * (lane & 3),
               acc[i][j][2 * hh], acc[i][j][2 * hh + 1]);
    }
  }
}

// 8 adjacent elements (16-byte aligned for bfloat16, 32 for float)
template <typename T> __device__ __forceinline__ void copy8(T* dst, const T* src) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int i = 0; i < (int)(8 * sizeof(T) / 16); ++i) d[i] = s[i];
}
template <typename T> __device__ __forceinline__ void zero8(T* dst) {
  uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int i = 0; i < (int)(8 * sizeof(T) / 16); ++i) d[i] = make_uint4(0, 0, 0, 0);
}

// rows [0, nrows) x columns [0, kp) of dst (stride ld) from src row r (stride
// lds) at columns k0 + [0, kw); zero where !have(r) and in columns [kw, kp)
template <typename T, typename Have>
__device__ __forceinline__ void stage(T* dst, int ld, int nrows, int kp, int kw,
                                      const Have& src_row) {
  const int per = kp / 8;
  for (int i = threadIdx.x; i < nrows * per; i += kThreads) {
    const int r = i / per, k = (i - r * per) * 8;
    const T* s = k < kw ? src_row(r) : nullptr;
    if (s != nullptr) copy8(dst + r * ld + k, s + k);
    else zero8(dst + r * ld + k);
  }
}

// x (n, h, w, c), y (n, h, w, co) in T; w1 (cm, c), w2 (9, cm, cm) [tap][out][in],
// w3 (co, cm), wd (co, c) in T; b1, b2 (cm), b3, bd (co) f32
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
bneck_eval_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                  const float* __restrict__ b1, const T* __restrict__ w2,
                  const float* __restrict__ b2, const T* __restrict__ w3,
                  const float* __restrict__ b3, const T* __restrict__ wd,
                  const float* __restrict__ bd, T* __restrict__ y, Geom g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const Smem L = smem_layout(g, sizeof(T));
  T* h1s = smem + L.h1;
  T* h2s = smem + L.h2;
  T* xa = smem + L.xa;
  T* wb = smem + L.wb;
  const int img = blockIdx.y;
  const int oy0 = (blockIdx.x / g.tiles_w) * g.th, ox0 = (blockIdx.x % g.tiles_w) * g.tw;
  const T* ximg = x + (size_t)img * g.h * g.w * g.c;
  T* yimg = y + (size_t)img * g.h * g.w * g.co;
  const int mt1 = L.hpp / 16, mt2 = L.opp / 16;

  // 1. h1 on the halo tile, in K chunks of x and W1
  {
    float acc[kS1][kNW][4];
    zero(acc);
    for (int k0 = 0; k0 < g.c; k0 += kKC) {
      const int kw = min(kKC, g.c - k0), kp = r16(kw);
      __syncthreads();
      stage(xa, L.ldk, L.hpp, kp, kw, [&](int p) -> const T* {
        const int iy = oy0 - 1 + p / L.hw, ix = ox0 - 1 + p % L.hw;
        return (p < L.hp && iy >= 0 && iy < g.h && ix >= 0 && ix < g.w)
                   ? ximg + ((size_t)iy * g.w + ix) * g.c + k0
                   : nullptr;
      });
      stage(wb, L.ldk, g.cm, kp, kw, [&](int r) { return w1 + (size_t)r * g.c + k0; });
      __syncthreads();
      gemm(acc, [&](int p) { return xa + p * L.ldk; }, wb, L.ldk, mt1, g.cm / 8, kp);
    }
    for_each(acc, mt1, g.cm / 8, [&](int p, int col, float v0, float v1) {
      const int iy = oy0 - 1 + p / L.hw, ix = ox0 - 1 + p % L.hw;
      const bool in = p < L.hp && iy >= 0 && iy < g.h && ix >= 0 && ix < g.w;
      store2<T>(h1s + p * L.ld1 + col, in ? fmaxf(v0 + b1[col], 0.f) : 0.f,
                in ? fmaxf(v1 + b1[col + 1], 0.f) : 0.f);
    });
    // the K padding of h1 and h2 (Cm not a multiple of 16) is zero
    for (int i = threadIdx.x; i < (L.hpp + L.opp) * (L.cmp - g.cm); i += kThreads) {
      const int r = i / (L.cmp - g.cm), k = g.cm + i % (L.cmp - g.cm);
      (r < L.hpp ? h1s + r * L.ld1 : h2s + (r - L.hpp) * L.ld1)[k] = from_f<T>(0.f);
    }
  }

  // 2. h2 = the 3x3 over h1: tap (dy, dx) reads the h1 row of halo pixel
  //    (qy + dy, qx + dx) for output pixel q = (qy, qx)
  {
    float acc[kS2][kNW][4];
    zero(acc);
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap - 3 * dy;
      for (int k0 = 0; k0 < g.cm; k0 += kKC) {
        const int kw = min(kKC, g.cm - k0), kp = r16(kw);
        __syncthreads();
        stage(wb, L.ldk, g.cm, kp, kw,
              [&](int r) { return w2 + ((size_t)tap * g.cm + r) * g.cm + k0; });
        __syncthreads();
        gemm(acc,
             [&](int q) {
               q = q < L.op ? q : 0;   // padding rows: any row, discarded
               const int qy = q / g.tw, qx = q - qy * g.tw;
               return h1s + ((qy + dy) * L.hw + qx + dx) * L.ld1 + k0;
             },
             wb, L.ldk, mt2, g.cm / 8, kp);
      }
    }
    for_each(acc, mt2, g.cm / 8, [&](int q, int col, float v0, float v1) {
      store2<T>(h2s + q * L.ld1 + col, fmaxf(v0 + b2[col], 0.f), fmaxf(v1 + b2[col + 1], 0.f));
    });
  }

  // 3. y = relu(h2 . W3 + b3 + skip), nc output channels per pass
  for (int n0 = 0; n0 < g.co; n0 += g.nc) {
    const int ncw = min(g.nc, g.co - n0);
    float acc[kS3][kNW][4];
    zero(acc);
    for (int k0 = 0; k0 < g.cm; k0 += kKC) {
      const int kw = min(kKC, g.cm - k0), kp = r16(kw);
      __syncthreads();   // h2 written; the previous readers of wb are done
      stage(wb, L.ldk, ncw, kp, kw, [&](int r) { return w3 + (size_t)(n0 + r) * g.cm + k0; });
      __syncthreads();
      gemm(acc, [&](int q) { return h2s + q * L.ld1 + k0; }, wb, L.ldk, mt2, ncw / 8, kp);
    }
    if (g.ds) {
      for (int k0 = 0; k0 < g.c; k0 += kKC) {
        const int kw = min(kKC, g.c - k0), kp = r16(kw);
        __syncthreads();
        stage(xa, L.ldk, L.opp, kp, kw, [&](int q) -> const T* {
          const int oy = oy0 + q / g.tw, ox = ox0 + q % g.tw;
          return (q < L.op && oy < g.h && ox < g.w) ? ximg + ((size_t)oy * g.w + ox) * g.c + k0
                                                    : nullptr;
        });
        stage(wb, L.ldk, ncw, kp, kw, [&](int r) { return wd + (size_t)(n0 + r) * g.c + k0; });
        __syncthreads();
        gemm(acc, [&](int q) { return xa + q * L.ldk; }, wb, L.ldk, mt2, ncw / 8, kp);
      }
    }
    for_each(acc, mt2, ncw / 8, [&](int q, int col, float v0, float v1) {
      const int oy = oy0 + q / g.tw, ox = ox0 + q % g.tw, o = n0 + col;
      if (q >= L.op || oy >= g.h || ox >= g.w) return;
      const size_t pix = (size_t)oy * g.w + ox;
      v0 += b3[o];
      v1 += b3[o + 1];
      if (g.ds) {
        v0 += bd[o];
        v1 += bd[o + 1];
      } else {
        const float2 s = load2<T>(ximg + pix * g.c + o);
        v0 += s.x;
        v1 += s.y;
      }
      store2<T>(yimg + pix * g.co + o, fmaxf(v0, 0.f), fmaxf(v1, 0.f));
    });
  }
}

template <typename T>
int launch(const Geom& g, const void* x, const void* w1, const void* b1, const void* w2,
           const void* b2, const void* w3, const void* b3, const void* wd, const void* bd,
           void* y, int smem, cudaStream_t stream) {
  const Smem L = smem_layout(g, sizeof(T));
  if ((size_t)smem != L.total_bytes || smem > kSmemMax) return (int)cudaErrorInvalidValue;
  if (units(L.hpp / 16, g.cm / 8) > kWarps * kS1 || units(L.opp / 16, g.cm / 8) > kWarps * kS2 ||
      units(L.opp / 16, g.nc / 8) > kWarps * kS3)
    return (int)cudaErrorInvalidValue;
  auto k = bneck_eval_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(((g.h + g.th - 1) / g.th) * g.tiles_w, g.n);
  k<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), static_cast<const float*>(b1),
      static_cast<const T*>(w2), static_cast<const float*>(b2), static_cast<const T*>(w3),
      static_cast<const float*>(b3), static_cast<const T*>(wd), static_cast<const float*>(bd),
      static_cast<T*>(y), g);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: a persistent, warp-specialised TMA + wgmma kernel
// ---------------------------------------------------------------------------

namespace bnk {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 384;        // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int kPassN = 128;          // phase 3: output channels a pass
constexpr int kMaxRows = 128;        // computed rows of a tile: one m64 block a consumer
constexpr int kMaxHalo = 192;        // halo rows of a tile: 3 m64 blocks
constexpr int kMaxStages = 4;
constexpr int kBBytes = 256 * 128;   // a streaming stage's weight region: 256 rows x 64 bf16
constexpr int kSmemLimit = 232448;
constexpr int kStg = 72;             // row stride (elements) of the output staging blocks

__host__ __device__ constexpr int rup(int v, int m) { return (v + m - 1) / m * m; }

// A launch's tiling and shared memory, from the tile th x tw and the widths
// (ops/rchain.py bf16_layout mirrors it): the halo width hw = tw + 2; the
// computed rows m2 = th hw (output pixel (r, c) is row r hw + c; columns c
// >= tw are computed and discarded, so that each 3x3 tap's operand is one
// contiguous row range of h1); the halo rows hp = (th + 2) hw; h1's rows
// h1r (every row a tap of a computed m64 block reads; phase 3 stages the
// output in h1's space). Where every folded
// weight fits beside h1 and two stages of x (res: layer1's blocks), the
// weights are loaded once per CTA and the ring carries only x; else
// (layer2's) each stage also carries a 256-row weight region, and the
// weights stream from L2 once per tile.
struct Layout {
  int hw, m2, hp, h1r, a_bytes, stage_bytes, stages, w_bytes, b_floats, bytes, res;
};
__host__ __device__ inline Layout layout(int th, int tw, int np, int c, int co, int ds) {
  Layout l;
  l.hw = tw + 2;
  l.m2 = th * l.hw;
  l.hp = (th + 2) * l.hw;
  // (at least 144: phase 3 stages two 64 x kStg output blocks there)
  const int reach = kMaxRows + 2 * l.hw + 2 > 144 ? kMaxRows + 2 * l.hw + 2 : 144;
  l.h1r = rup(rup(l.hp, 64) > reach ? rup(l.hp, 64) : reach, 8);
  l.a_bytes = rup(l.hp > kMaxRows ? l.hp : kMaxRows, 64) * 128;
  const int kc1 = (c + 63) / 64, kn = np / 64, passes = (co + kPassN - 1) / kPassN;
  l.w_bytes = (kc1 + 9 * kn) * np * 128 + passes * (kn + ds * kc1) * kPassN * 128;
  // the biases b1, b2 (np each), b3, bd (passes x kPassN each), zero padded
  l.b_floats = 2 * np + 2 * passes * kPassN;
  const int h1b = np / 8 * l.h1r * 16 + 4 * l.b_floats;
  l.stages = 0;
  l.res = 1;
  l.stage_bytes = l.a_bytes;
  for (int s = kMaxStages; s >= 2 && l.stages == 0; --s)
    if (1024 + l.w_bytes + h1b + s * (l.stage_bytes + 16) + 16 <= kSmemLimit) l.stages = s;
  if (l.stages == 0) {
    l.res = 0;
    l.w_bytes = 0;
    l.stage_bytes = l.a_bytes + kBBytes;
    for (int s = kMaxStages; s >= 2 && l.stages == 0; --s)
      if (1024 + h1b + s * (l.stage_bytes + 16) + 16 <= kSmemLimit) l.stages = s;
  }
  l.bytes = 1024 + l.w_bytes + h1b + l.stages * (l.stage_bytes + 16) + 16;
  return l;
}

struct Args {
  const float *b1, *b2, *b3, *bd;   // (cm), (cm), (co), (co); bd null without the downsample
  const bf16* x;                    // (n, h, w, c): the identity skip
  bf16* y;                          // (n, h, w, co)
  int n, h, w, c, cm, co, ds, th, tw;
  int tiles_w, tiles_img, tiles;
  int kc1, kn, passes, bps, steps2;   // K chunks of x and of h1 / h2; phase-3 passes; W2
                                      // boxes a streamed phase-2 step and those steps
};

// One tile's work, in the order the producer fills the ring and the
// consumers drain it:
//   phase 1  kc1 steps: the x halo box (hp rows x 64 channels, zeros outside
//            the image) [and W1's chunk]; h1 = relu(x . W1 + b1) on the halo
//            rows, each consumer half of h1's columns on every m64 block,
//            written to shared memory in bf16, 0 at pixels outside the
//            image (the 3x3 pads h1, not x: relu(b1) must not leak in)
//   phase 2  [steps2 steps of bps (tap, K chunk) boxes of W2]; each
//            consumer its m64 block of computed rows; tap (dy, dx)'s
//            operand is h1's rows from 64 w + dy hw + dx, read through a
//            descriptor without swizzle (h1 is stored [channel group of
//            8][row][8]); h2 = relu(. + b2) stays in registers as the next
//            product's A
//   phase 3  per pass of 128 output channels: [kn steps of W3's chunk]
//            (A from registers), with the downsample kc1 steps of the x box
//            of the output pixels [and Wd's chunk] into the same sums; then
//            y = relu(. + b3 [+ bd] [+ x]) for the tile's real pixels
// [bracketed: streamed per tile unless the weights are resident (kRes)]
template <int NP, bool kRes>
__global__ void __launch_bounds__(kThreads, 1)
bneck_eval_kernel(const __grid_constant__ CUtensorMap map_xh, const __grid_constant__ CUtensorMap map_xo,
                  const __grid_constant__ CUtensorMap map_w1, const __grid_constant__ CUtensorMap map_w2,
                  const __grid_constant__ CUtensorMap map_w3, const __grid_constant__ CUtensorMap map_wd,
                  const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const Layout L = layout(a.th, a.tw, NP, a.c, a.co, a.ds);
  const int kc1 = a.kc1, nboxes = 9 * a.kn;
  unsigned char* ring = base;                                           // [stages][A | B]
  bf16* w1s = reinterpret_cast<bf16*>(base + L.stages * L.stage_bytes);   // resident weights
  bf16* w2s = w1s + kc1 * NP * 64;
  bf16* w3s = w2s + nboxes * NP * 64;
  bf16* wds = w3s + a.passes * a.kn * kPassN * 64;
  bf16* h1 = reinterpret_cast<bf16*>(base + L.stages * L.stage_bytes + L.w_bytes);   // [NP / 8][h1r][8]
  float* b1s = reinterpret_cast<float*>(h1 + NP * L.h1r);   // the biases, zero padded
  float* b2s = b1s + NP;
  float* b3s = b2s + NP;
  float* bds = b3s + a.passes * kPassN;
  uint64_t* full = reinterpret_cast<uint64_t*>(b1s + L.b_floats);
  uint64_t* empty = full + L.stages;
  uint64_t* wbar = empty + L.stages;
  const int tid = threadIdx.x, wg = tid / 128;
  if (tid == 0) {
    for (int s = 0; s < L.stages; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], 2);   // one arrival per consumer warpgroup
    }
    hop::mbar_init(wbar, 1);
    hop::mbar_init_fence();
  }
  __syncthreads();
  auto stage_a = [&](int s) { return reinterpret_cast<bf16*>(ring + s * L.stage_bytes); };
  auto stage_b = [&](int s) {
    return reinterpret_cast<bf16*>(ring + s * L.stage_bytes + L.a_bytes);
  };
  auto origin = [&](int tile, int& img, int& oy0, int& ox0) {
    img = tile / a.tiles_img;
    const int r = tile - img * a.tiles_img;
    oy0 = (r / a.tiles_w) * a.th;
    ox0 = (r % a.tiles_w) * a.tw;
  };

  if (wg == 2) {   // producer: one thread keeps the ring full
    hop::regs_dec<40>();
    if (tid == 256) {
      hop::tma_prefetch_map(&map_xh);
      if (a.ds) hop::tma_prefetch_map(&map_xo);
      if (kRes) {   // every weight box once
        hop::mbar_expect_tx(wbar, L.w_bytes);
        for (int kc = 0; kc < kc1; ++kc)
          hop::tma_load_2d(w1s + kc * NP * 64, &map_w1, 64 * kc, 0, wbar);
        for (int b = 0; b < nboxes; ++b)
          hop::tma_load_3d(w2s + b * NP * 64, &map_w2, 64 * (b % a.kn), 0, b / a.kn, wbar);
        for (int pass = 0; pass < a.passes; ++pass) {
          for (int kc = 0; kc < a.kn; ++kc)
            hop::tma_load_2d(w3s + (pass * a.kn + kc) * kPassN * 64, &map_w3, 64 * kc,
                             kPassN * pass, wbar);
          for (int kc = 0; kc < (a.ds ? kc1 : 0); ++kc)
            hop::tma_load_2d(wds + (pass * kc1 + kc) * kPassN * 64, &map_wd, 64 * kc,
                             kPassN * pass, wbar);
        }
      }
      int s = 0;
      uint32_t ph = 0;
      auto acquire = [&](uint32_t bytes) {
        hop::mbar_wait(&empty[s], ph ^ 1);
        hop::mbar_expect_tx(&full[s], bytes);
      };
      auto advance = [&]() {
        if (++s == L.stages) s = 0, ph ^= 1;
      };
      for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
        int img, oy0, ox0;
        origin(tile, img, oy0, ox0);
        for (int kc = 0; kc < kc1; ++kc) {
          acquire((L.hp + (kRes ? 0 : NP)) * 128);
          hop::tma_load_4d(stage_a(s), &map_xh, 64 * kc, ox0 - 1, oy0 - 1, img, &full[s]);
          if (!kRes) hop::tma_load_2d(stage_b(s), &map_w1, 64 * kc, 0, &full[s]);
          advance();
        }
        if (!kRes)
          for (int st = 0; st < a.steps2; ++st) {
            const int b0 = st * a.bps, nb = min(a.bps, nboxes - b0);
            acquire(nb * NP * 128);
            for (int b = 0; b < nb; ++b)
              hop::tma_load_3d(stage_b(s) + b * NP * 64, &map_w2, 64 * ((b0 + b) % a.kn), 0,
                               (b0 + b) / a.kn, &full[s]);
            advance();
          }
        for (int pass = 0; pass < a.passes; ++pass) {
          if (!kRes) {   // a pass's W3 chunks in one step
            acquire(a.kn * kPassN * 128);
            for (int kc = 0; kc < a.kn; ++kc)
              hop::tma_load_2d(stage_b(s) + kc * kPassN * 64, &map_w3, 64 * kc, kPassN * pass,
                               &full[s]);
            advance();
          }
          for (int kc = 0; kc < (a.ds ? kc1 : 0); ++kc) {
            acquire((L.m2 + (kRes ? 0 : kPassN)) * 128);
            hop::tma_load_4d(stage_a(s), &map_xo, 64 * kc, ox0, oy0, img, &full[s]);
            if (!kRes) hop::tma_load_2d(stage_b(s), &map_wd, 64 * kc, kPassN * pass, &full[s]);
            advance();
          }
        }
      }
    }
    return;
  }

  // consumers
  hop::regs_inc<232>();
  const int t = tid % 128, warp = t / 32, lane = t % 32, g = lane / 4, q = lane % 4;
  // h1 starts zero: rows no phase-1 block writes are read only by discarded
  // outputs, and must hold no NaN bit pattern
  for (int i = tid; i < NP * L.h1r / 8; i += 256)
    reinterpret_cast<uint4*>(h1)[i] = make_uint4(0u, 0u, 0u, 0u);
  // the bias tables (read after the first named barrier)
  for (int i = tid; i < L.b_floats; i += 256) {
    const int pn = a.passes * kPassN;
    float v = 0.f;
    if (i < NP) v = i < a.cm ? a.b1[i] : 0.f;
    else if (i < 2 * NP) v = i - NP < a.cm ? a.b2[i - NP] : 0.f;
    else if (i < 2 * NP + pn) v = i - 2 * NP < a.co ? a.b3[i - 2 * NP] : 0.f;
    else if (a.ds) v = i - 2 * NP - pn < a.co ? a.bd[i - 2 * NP - pn] : 0.f;
    b1s[i] = v;
  }
  if (kRes) hop::mbar_wait(wbar, 0);
  const int nb1 = (L.hp + 63) / 64;
  int s = 0;
  uint32_t ph = 0;
  // a ring step's products are issued: wait for them and free its stage
  auto retire = [&]() {
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    if (t == 0) hop::mbar_arrive(&empty[s]);
    if (++s == L.stages) s = 0, ph ^= 1;
  };

  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    int img, oy0, ox0;
    origin(tile, img, oy0, ox0);

    // phase 1: h1 on the halo rows; warpgroup wg computes its NP / 2
    // columns of all three m64 blocks (past the last block it repeats it:
    // no branch around the products, which a divergent path would
    // serialise; its epilogue skips the repeat)
    {
      constexpr int N1 = NP / 2;
      float acc[3][N1 / 2];
      for (int kc = 0; kc < kc1; ++kc) {
        hop::mbar_wait(&full[s], ph);
        const bf16* as = stage_a(s);
        const bf16* bs = (kRes ? w1s + kc * NP * 64 : stage_b(s)) + wg * N1 * 64;
#pragma unroll
        for (int i = 0; i < 3; ++i) hop::fence_regs(acc[i]);
        hop::wgmma_fence();
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const int blk = min(i, nb1 - 1);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            hop::wgmma<N1, 0, 0>(acc[i], hop::desc_sw128(as + blk * 64 * 64 + 16 * kk),
                                 hop::desc_sw128(bs + 16 * kk), (kc | kk) != 0);
        }
        retire();
#pragma unroll
        for (int i = 0; i < 3; ++i) hop::fence_regs(acc[i]);
      }
      hop::named_sync(1, 256);   // both warpgroups are done with the last tile's h1
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        if (i >= nb1) break;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int p = 64 * i + 16 * warp + g + 8 * hh;
          const int iy = oy0 - 1 + p / L.hw, ix = ox0 - 1 + p % L.hw;
          const bool in = p < L.hp && iy >= 0 && iy < a.h && ix >= 0 && ix < a.w;
#pragma unroll
          for (int j = 0; j < N1 / 8; ++j) {
            const int col = wg * N1 + 8 * j + 2 * q;
            float v0 = 0.f, v1 = 0.f;
            if (in && col < a.cm) {
              const float2 b = *reinterpret_cast<const float2*>(b1s + col);
              v0 = fmaxf(acc[i][4 * j + 2 * hh] + b.x, 0.f);
              v1 = fmaxf(acc[i][4 * j + 2 * hh + 1] + b.y, 0.f);
            }
            store2<bf16>(h1 + ((size_t)(wg * N1 / 8 + j) * L.h1r + p) * 8 + 2 * q, v0, v1);
          }
        }
      }
      hop::fence_proxy_async();   // h1 is read by wgmma (the async proxy)
      hop::named_sync(1, 256);
    }

    // phase 2: the 3x3 over h1, h2 into registers as bf16 A fragments
    uint32_t af[NP / 16][4];
    {
      float acc[NP / 2];
      // box idx = (tap, K chunk): tap (dy, dx)'s A is h1's rows from
      // 64 wg + dy hw + dx, its K chunk 8 channel groups on
#define KDCC_BNK_TAPS(BS, IDX)                                                                \
  {                                                                                           \
    const int tap = (IDX) / a.kn, kc = (IDX) % a.kn;                                          \
    const bf16* hr = h1 + ((size_t)8 * kc * L.h1r + 64 * wg + (tap / 3) * L.hw + tap % 3) * 8; \
    _Pragma("unroll") for (int kk = 0; kk < 4; ++kk)                                          \
      hop::wgmma<NP, 0, 0>(acc, hop::desc_plain(hr + (size_t)2 * kk * L.h1r * 8, L.h1r * 16, 128), \
                           hop::desc_sw128((BS) + 16 * kk), ((IDX) + kk) != 0);               \
  }
      if (kRes) {
        hop::fence_regs(acc);
        hop::wgmma_fence();
        for (int idx = 0; idx < nboxes; ++idx) KDCC_BNK_TAPS(w2s + idx * NP * 64, idx)
        hop::wgmma_commit();
        hop::wgmma_wait<0>();
      } else {
        for (int st = 0; st < a.steps2; ++st) {
          hop::mbar_wait(&full[s], ph);
          const bf16* bs = stage_b(s);
          const int b0 = st * a.bps, nb = min(a.bps, nboxes - b0);
          hop::fence_regs(acc);
          hop::wgmma_fence();
          for (int b = 0; b < nb; ++b) KDCC_BNK_TAPS(bs + b * NP * 64, b0 + b)
          retire();
        }
      }
#undef KDCC_BNK_TAPS
      hop::fence_regs(acc);
#pragma unroll
      for (int kb = 0; kb < NP / 16; ++kb)
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          // f: (row half f % 2, column half f / 2) of the 16-column block kb
          const int i = 8 * kb + 4 * (f / 2) + 2 * (f % 2), col = 16 * kb + 8 * (f / 2) + 2 * q;
          float v0 = 0.f, v1 = 0.f;
          if (col < a.cm) {
            const float2 b = *reinterpret_cast<const float2*>(b2s + col);
            v0 = fmaxf(acc[i] + b.x, 0.f);
            v1 = fmaxf(acc[i + 1] + b.y, 0.f);
          }
          const __nv_bfloat162 hv = __floats2bfloat162_rn(v0, v1);
          af[kb][f] = *reinterpret_cast<const uint32_t*>(&hv);
        }
    }

    // phase 3: y, 128 output channels a pass. The identity skip's x is
    // loaded (read-only path) before the products, so its latency hides
    // under them. h1's space is free once both warpgroups are past phase 2:
    // it stages the output
    hop::named_sync(1, 256);
    bf16* stg = h1 + wg * 64 * kStg;
    // the staged rows this thread stores: t / 8 + 16 i, its 16 bytes t % 8
    size_t opix[4];
    bool olive[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = 64 * wg + t / 8 + 16 * i, r = qr / L.hw, c = qr % L.hw;
      const int oy = oy0 + r, ox = ox0 + c;
      olive[i] = qr < L.m2 && c < a.tw && oy < a.h && ox < a.w;
      opix[i] = ((size_t)img * a.h + oy) * a.w + ox;
    }
    const int qrow = 64 * wg + 16 * warp + g;
    size_t pix[2];
    bool live[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int qr = qrow + 8 * hh, r = qr / L.hw, c = qr % L.hw;
      const int oy = oy0 + r, ox = ox0 + c;
      live[hh] = qr < L.m2 && c < a.tw && oy < a.h && ox < a.w;
      pix[hh] = live[hh] ? ((size_t)img * a.h + oy) * a.w + ox : 0;
    }
    for (int pass = 0; pass < a.passes; ++pass) {
      uint32_t skip[2][kPassN / 8];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int j = 0; j < kPassN / 8; ++j) {
          const int o = kPassN * pass + 8 * j + 2 * q;
          skip[hh][j] = !a.ds && live[hh] && o < a.co
                            ? __ldg(reinterpret_cast<const unsigned int*>(a.x + pix[hh] * a.c + o))
                            : 0u;
        }
      float acc[kPassN / 2];
      {   // h2 . W3, A from registers
        const bf16* bs = w3s + pass * a.kn * kPassN * 64;
        if (!kRes) {
          hop::mbar_wait(&full[s], ph);
          bs = stage_b(s);
        }
        hop::fence_regs(acc);
        hop::wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < NP / 64; ++kc)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            hop::wgmma_m64n128k16_rs<0>(acc, af[4 * kc + kk],
                                        hop::desc_sw128(bs + kc * kPassN * 64 + 16 * kk),
                                        (kc | kk) != 0);
        if (kRes) {
          hop::wgmma_commit();
          hop::wgmma_wait<0>();
        } else {
          retire();
        }
        hop::fence_regs(acc);
      }
      for (int kc = 0; kc < (a.ds ? kc1 : 0); ++kc) {   // x . Wd
        hop::mbar_wait(&full[s], ph);
        const bf16* as = stage_a(s) + wg * 64 * 64;
        const bf16* bs = kRes ? wds + (pass * kc1 + kc) * kPassN * 64 : stage_b(s);
        hop::fence_regs(acc);
        hop::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hop::wgmma<kPassN, 0, 0>(acc, hop::desc_sw128(as + 16 * kk),
                                   hop::desc_sw128(bs + 16 * kk), 1);
        retire();
        hop::fence_regs(acc);
      }
      // y through shared memory, 64 columns at a time: acc[4 j + 2 hh + e]
      // (computed row qrow + 8 hh, column 128 pass + 8 j + 2 q + e) is
      // finished and stored as bf16 into this warpgroup's [64][72] block;
      // then each row's 128 bytes go out as 16-byte stores, one pixel per 8
      // lanes
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int j = 8 * hf + jj, o = kPassN * pass + 8 * j + 2 * q;
          const float2 b = *reinterpret_cast<const float2*>(b3s + o);
          const float2 bd = *reinterpret_cast<const float2*>(bds + o);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const float2 sk =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&skip[hh][j]));
            const float v0 = acc[4 * j + 2 * hh] + b.x + (a.ds ? bd.x : sk.x);
            const float v1 = acc[4 * j + 2 * hh + 1] + b.y + (a.ds ? bd.y : sk.y);
            store2<bf16>(stg + (16 * warp + g + 8 * hh) * kStg + 8 * jj + 2 * q, fmaxf(v0, 0.f),
                         fmaxf(v1, 0.f));
          }
        }
        hop::named_sync(2 + wg, 128);
        const int o = kPassN * pass + 64 * hf + 8 * (t % 8);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint4 v = *reinterpret_cast<const uint4*>(stg + (t / 8 + 16 * i) * kStg + 8 * (t % 8));
          if (olive[i] && o < a.co) *reinterpret_cast<uint4*>(a.y + opix[i] * a.co + o) = v;
        }
        hop::named_sync(2 + wg, 128);
      }
    }
  }
}

template <int NP, bool kRes>
cudaError_t launch(const Args& a, const CUtensorMap* maps, const Layout& L, cudaStream_t st) {
  if (ctas_per_sm<bneck_eval_kernel<NP, kRes>>(kThreads, L.bytes) < 1)
    return cudaErrorInvalidValue;
  const int grid = a.tiles < sm_count() ? a.tiles : sm_count();
  bneck_eval_kernel<NP, kRes><<<grid, kThreads, L.bytes, st>>>(maps[0], maps[1], maps[2],
                                                               maps[3], maps[4], maps[5], a);
  return cudaGetLastError();
}

// x, y NHWC; w1 (cm, c), w2 (9, cm, cm), w3 (co, cm), wd (co, c) bf16
int run(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
        const void* w3, const void* b3, const void* wd, const void* bd, void* y, int n, int h,
        int w, int c, int cm, int co, int th, int tw, int smem, cudaStream_t st) {
  const int ds = wd != nullptr, np = cm <= 64 ? 64 : 128;
  if (cm > 128 || th < 1 || tw < 1) return (int)cudaErrorInvalidValue;
  const Layout L = layout(th, tw, np, c, co, ds);
  if (L.m2 > kMaxRows || L.hp > kMaxHalo || L.stages < 2 || smem != L.bytes)
    return (int)cudaErrorInvalidValue;
  using u64 = cuuint64_t;
  using u32 = cuuint32_t;
  CUtensorMap maps[6];
  const u64 xd[4] = {(u64)c, (u64)w, (u64)h, (u64)n};
  const u64 xs[3] = {(u64)c * 2, (u64)w * c * 2, (u64)h * w * c * 2};
  const u32 bxh[4] = {64, (u32)L.hw, (u32)(th + 2), 1}, bxo[4] = {64, (u32)L.hw, (u32)th, 1};
  const u64 w1d[2] = {(u64)c, (u64)cm}, w1s[1] = {(u64)c * 2};
  const u64 w2d[3] = {(u64)cm, (u64)cm, 9}, w2s[2] = {(u64)cm * 2, (u64)cm * cm * 2};
  const u64 w3d[2] = {(u64)cm, (u64)co}, w3s[1] = {(u64)cm * 2};
  const u64 wdd[2] = {(u64)c, (u64)co};
  const u32 bw1[2] = {64, (u32)np}, bw2[3] = {64, (u32)np, 1}, bw3[2] = {64, (u32)kPassN};
  if (!hop::cached_map(&maps[0], x, 4, xd, xs, bxh) ||
      !hop::cached_map(&maps[2], w1, 2, w1d, w1s, bw1) ||
      !hop::cached_map(&maps[3], w2, 3, w2d, w2s, bw2) ||
      !hop::cached_map(&maps[4], w3, 2, w3d, w3s, bw3))
    return (int)cudaErrorInvalidValue;
  maps[1] = maps[0], maps[5] = maps[4];
  if (ds && (!hop::cached_map(&maps[1], x, 4, xd, xs, bxo) ||
             !hop::cached_map(&maps[5], wd, 2, wdd, w1s, bw3)))
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.b1 = static_cast<const float*>(b1);
  a.b2 = static_cast<const float*>(b2);
  a.b3 = static_cast<const float*>(b3);
  a.bd = static_cast<const float*>(bd);
  a.x = static_cast<const bf16*>(x);
  a.y = static_cast<bf16*>(y);
  a.n = n, a.h = h, a.w = w, a.c = c, a.cm = cm, a.co = co, a.ds = ds, a.th = th, a.tw = tw;
  a.tiles_w = (w + tw - 1) / tw;
  a.tiles_img = ((h + th - 1) / th) * a.tiles_w;
  a.tiles = n * a.tiles_img;
  a.kc1 = (c + 63) / 64;
  a.kn = np / 64;
  a.passes = (co + kPassN - 1) / kPassN;
  a.bps = kBBytes / (np * 128);
  a.steps2 = (9 * a.kn + a.bps - 1) / a.bps;
  if (np == 64) return (int)(L.res ? launch<64, true>(a, maps, L, st) : launch<64, false>(a, maps, L, st));
  return (int)(L.res ? launch<128, true>(a, maps, L, st) : launch<128, false>(a, maps, L, st));
}

}  // namespace bnk

}  // namespace

extern "C" {

// dtype: 0 float32 (FMA), 1 bfloat16 (TMA + wgmma). x (n, h, w, c) and y
// (n, h, w, co) NHWC; wd and bd null without a downsample (then c == co).
// Widths divisible by 8 (bfloat16: Cm at most 128); th x tw the output
// tile, nc the phase-3 channel pass (float32: a multiple of 8; bfloat16:
// 128), smem the layout's bytes (ops/rchain.py plans all four). Pointers
// 16-byte aligned. Returns a cudaError_t value (0 = success).
int kdcc_bneck_eval(int dtype, const void* x, const void* w1, const void* b1, const void* w2,
                    const void* b2, const void* w3, const void* b3, const void* wd,
                    const void* bd, void* y, int n, int h, int w, int c, int cm, int co, int th,
                    int tw, int nc, int smem, void* stream) {
  const int ds = wd != nullptr;
  if (c % 8 || cm % 8 || co % 8 || nc % 8 || nc < 8 || th < 1 || tw < 1 || n < 1 || h < 1 ||
      w < 1 || (ds != (bd != nullptr)) || (!ds && c != co) ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w1) |
       reinterpret_cast<uintptr_t>(w2) | reinterpret_cast<uintptr_t>(w3) |
       reinterpret_cast<uintptr_t>(wd) | reinterpret_cast<uintptr_t>(y)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return nc != bnk::kPassN ? (int)cudaErrorInvalidValue
                             : bnk::run(x, w1, b1, w2, b2, w3, b3, wd, bd, y, n, h, w, c, cm, co,
                                        th, tw, smem, s);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  Geom g;
  g.n = n; g.h = h; g.w = w; g.c = c; g.cm = cm; g.co = co; g.ds = ds;
  g.th = th; g.tw = tw; g.tiles_w = (w + tw - 1) / tw; g.nc = nc;
  return launch<float>(g, x, w1, b1, w2, b2, w3, b3, wd, bd, y, smem, s);
}

}  // extern "C"

// Eval-mode ResNet bottleneck, every BN folded into its conv, one launch per
// block (the teacher's layer1 and layer2[1:]).
//
// Replaces the Pallas kernels of kd_cheap_conv_tpu/ops/pallas/:
//   rchain.py      fused_resnet_blocks_eval      (_k_bneck_eval, one call per block)
//   rchain_hwnc.py fused_resnet_stage_eval_hwnc  (_k_stage, one call per run of blocks)
// Both compute the same function in two TPU layouts; here it is one kernel,
// bneck_eval_kernel<T>, launched once per block:
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
// the tensor cores. The design keeps h1 and h2 out of device memory: a CTA
// owns a th x tw output tile of one image and
//   1. streams the (th + 2) x (tw + 2) input halo in K chunks of 64 channels
//      with W1's matching chunk, and multiplies them (mma.sync m16n8k16,
//      f32 sums in registers); h1 goes to shared memory in the activation
//      dtype, 0 at halo pixels outside the image (those must not become
//      relu(b1): the 3x3 pads h1, not x);
//   2. runs the 3x3 as nine tap products: the A operand of tap (dy, dx) is
//      the h1 rows of the shifted output pixels, W2 streamed by tap and K
//      chunk; h2 goes to shared memory;
//   3. per chunk of output channels, h2 . W3 (and x's centre pixels . Wd,
//      restaged in K chunks) into one f32 accumulator, then bias, skip,
//      relu and one rounding in the epilogue.
// No weight tensor has to fit in shared memory whole (at layer2 W2 alone is
// 288 KB in bf16). A warp owns units of one 16-row tile x 64 output
// channels and loads its A fragment once per K step for 8 products, which
// bounds its accumulators (at most 3 units of 8 16x8 tiles). float32 runs
// the same schedule on FMAs in the mma fragment's layout, so its results
// stay exact to f32 rounding (no TF32); it is for parity checks. Staging is
// synchronous (no cp.async, TMA or wgmma pipeline): later work.
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
// products: a warp unit is 16 rows (one m-tile) x up to kNW n-tiles. The A
// operand is given as one row pointer per fragment row (rows g and g + 8 of
// the m-tile, g = lane / 4), so shifted or gathered rows cost nothing; B is
// Bt[n][k] (row-major, K contiguous) in shared memory. Value e of tile j is
// D[g + 8 (e / 2)][8 j + 2 t + e % 2], t = lane % 4: PTX mma.m16n8k16's
// fragment layout.
// ---------------------------------------------------------------------------

template <typename T> struct Frag;
template <> struct Frag<__nv_bfloat16> {
  uint32_t a[4];
  __device__ __forceinline__ void load(const __nv_bfloat16* r0, const __nv_bfloat16* r1,
                                       int t) {
    a[0] = *reinterpret_cast<const uint32_t*>(r0 + 2 * t);
    a[1] = *reinterpret_cast<const uint32_t*>(r1 + 2 * t);
    a[2] = *reinterpret_cast<const uint32_t*>(r0 + 2 * t + 8);
    a[3] = *reinterpret_cast<const uint32_t*>(r1 + 2 * t + 8);
  }
  // bt: Bt at (n0, k0) of this 8-row tile
  __device__ __forceinline__ void mma(float d[4], const __nv_bfloat16* bt, int ldb,
                                      int lane) const {
    const int g = lane >> 2, t = lane & 3;
    const uint32_t b0 = *reinterpret_cast<const uint32_t*>(bt + g * ldb + 2 * t);
    const uint32_t b1 = *reinterpret_cast<const uint32_t*>(bt + g * ldb + 2 * t + 8);
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};
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
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w1) |
       reinterpret_cast<uintptr_t>(w2) | reinterpret_cast<uintptr_t>(w3) |
       reinterpret_cast<uintptr_t>(wd) | reinterpret_cast<uintptr_t>(y)) % 16 != 0)
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

}  // namespace

extern "C" {

// dtype: 0 float32 (FMA), 1 bfloat16 (tensor cores). x (n, h, w, c) and y
// (n, h, w, co) NHWC; wd and bd null without a downsample (then c == co).
// Widths divisible by 8; th x tw the output tile, nc the phase-3 channel
// pass (a multiple of 8), smem the layout's bytes (ops/rchain.py plans all
// three). Returns a cudaError_t value (0 = success).
int kdcc_bneck_eval(int dtype, const void* x, const void* w1, const void* b1, const void* w2,
                    const void* b2, const void* w3, const void* b3, const void* wd,
                    const void* bd, void* y, int n, int h, int w, int c, int cm, int co, int th,
                    int tw, int nc, int smem, void* stream) {
  const int ds = wd != nullptr;
  if (c % 8 || cm % 8 || co % 8 || nc % 8 || nc < 8 || th < 1 || tw < 1 || (ds != (bd != nullptr)) ||
      (!ds && c != co))
    return (int)cudaErrorInvalidValue;
  Geom g;
  g.n = n; g.h = h; g.w = w; g.c = c; g.cm = cm; g.co = co; g.ds = ds;
  g.th = th; g.tw = tw; g.tiles_w = (w + tw - 1) / tw; g.nc = nc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(g, x, w1, b1, w2, b2, w3, b3, wd, bd, y, smem, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(g, x, w1, b1, w2, b2, w3, b3, wd, bd, y, smem, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

// Eval-mode MobileNetV2 inverted-residual block, BN folded, one launch per block.
//
// Replaces the Pallas eval kernels of kd_cheap_conv_tpu/ops/pallas/irchain.py:
//   stride 1: fused_mnv2_blocks_eval (body _k_ir_eval)            -> kernel A
//   stride 2: fused_ir_block_s2_eval (stem.py _run_bn_pw,
//             _run_bn_dw_s2 and an XLA affine: three passes)       -> kernel B
// Both are the same template here; only the dw stride differs.
//
// What bounds it on an H100: bytes. Between blocks only the block input and
// output touch device memory (Cin, Cout <= 320 channels per pixel), while the
// expanded hidden activation (up to 960 channels, 6x the input) never leaves
// the SM. The plain path writes and reads that hidden tensor several times
// (expand, BN, clamp, dw, BN, clamp), which at Cin <= 160 is most of its
// traffic. The design keeps the hidden tensor in shared memory: a CTA owns
// one th x tw output tile of one image, stages the input tile plus its dw
// halo once, then walks the hidden channels in chunks of `ch`:
//   expand (1x1, folded BN bias, relu6) on every halo pixel -> es (f32)
//   depthwise 3x3 taps (folded BN bias, relu6)              -> ds (T)
//   project (1x1) accumulated in f32                        -> acc
// and writes acc + bias (+ the f32 residual) cast to T in the epilogue.
// Halo pixels outside the image are 0 AFTER the expand: the dw conv pads the
// expanded activation, so they must not become relu6(bias).
//
// bfloat16 computes both 1x1 products on the tensor cores (mma.sync
// m16n8k16, f32 accumulation) from padded shared-memory tiles and moves
// activations and weights 16 bytes per access (so it takes channel counts
// divisible by 8 and 16-byte aligned tensors); float32 keeps
// plain FMAs, so that its results stay exact to f32 rounding (TF32 would
// not). The recomputed halo costs (th+2d)(tw+2d)/(th*tw) expands per output
// pixel; TMA staging, wgmma and a halo-free schedule are later work.
// The C entry point launches on the caller's stream and returns
// cudaGetLastError(); the Python wrapper raises if it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// mma path: the project accumulators live in registers, at most kAccTiles
// 16x8 tiles per warp (the planner keeps (op/16) * (cout/8) <= 8 * kAccTiles)
constexpr int kAccTiles = 10;

struct Geom {
  int n, h, w, cin, ce, cout;  // input image and channel widths
  int ho, wo;                  // output image
  int stride, dil;             // dw stride and dilation; padding == dil
  int expand, res;             // has the 1x1 expand; adds the residual
  int th, tw;                  // output tile
  int hh, hw;                  // input halo tile: (t - 1) * stride + 2 * dil + 1
  int ch;                      // hidden channels per chunk
  int tiles_w;                 // output tiles along W
};

// Shared-memory layout: byte offsets and row strides (in elements). The
// Python planner (ops/irchain_eval.py, smem_bytes) computes the same total
// and the launcher checks that the two agree.
struct Smem {
  size_t xs, wes, es, ds, wps, acc, total;
  int hp, op;          // rows of the halo and output tiles (padded to 16 for mma)
  int kx, cp;          // cin padded to 16, cout padded to 8 (mma); else cin, cout
  int xs_ld, we_ld, es_ld, ds_ld, wp_ld, acc_ld;
};

__host__ __device__ inline size_t round16(size_t b) { return (b + 15) / 16 * 16; }
__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

__host__ __device__ inline Smem smem_layout(const Geom& g, bool mma) {
  Smem s;
  const size_t es_ = mma ? 2 : 4;  // activation element size
  const int hp = g.hh * g.hw, op = g.th * g.tw;
  if (mma) {
    // xs, wes: [row][kx + 8] bf16; es: [hp][ch + 8] f32; ds, wps: [row][ch + 8]
    // bf16; the accumulators are in registers. The +8 keeps fragment loads
    // off one bank.
    s.hp = round_up(hp, 16); s.op = round_up(op, 16);
    s.kx = round_up(g.cin, 16); s.cp = round_up(g.cout, 8);
    s.xs_ld = s.kx + 8; s.we_ld = s.kx + 8; s.es_ld = g.ch + 8;
    s.ds_ld = g.ch + 8; s.wp_ld = g.ch + 8; s.acc_ld = 0;
  } else {
    // xs: [hp][cin]; wes: [cin][ch]; es: [hp][ch]; ds: [op][ch];
    // wps: [ch][cout]; acc: [op][cout]
    s.hp = hp; s.op = op; s.kx = g.cin; s.cp = g.cout;
    s.xs_ld = g.cin; s.we_ld = g.ch; s.es_ld = g.ch;
    s.ds_ld = g.ch; s.wp_ld = g.cout; s.acc_ld = g.cout;
  }
  const size_t we_rows = mma ? g.ch : g.cin, wp_rows = mma ? s.cp : g.ch;
  size_t o = 0;
  s.xs = o;  o += round16((size_t)s.hp * s.xs_ld * es_);
  s.wes = o; o += g.expand ? round16(we_rows * s.we_ld * es_) : 0;
  s.es = o;  o += round16((size_t)s.hp * s.es_ld * 4);
  s.ds = o;  o += round16((size_t)s.op * s.ds_ld * es_);
  s.wps = o; o += round16(wp_rows * s.wp_ld * es_);
  s.acc = o; o += round16((size_t)s.op * s.acc_ld * 4);
  s.total = o;
  return s;
}

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}

__device__ __forceinline__ float relu6(float v) { return fminf(fmaxf(v, 0.f), 6.f); }

// D = A (16x16 bf16, row-major) * B (16x8 bf16, given as its transpose
// Bt[n][k]) + D, f32. Fragment layouts of PTX mma.m16n8k16: with g = lane/4
// and t = lane%4, a0 = A[g][2t..], a1 = A[g+8][2t..], a2 = A[g][2t+8..],
// a3 = A[g+8][2t+8..]; b0 = Bt[g][2t..], b1 = Bt[g][2t+8..];
// d0,d1 = D[g][2t, 2t+1], d2,d3 = D[g+8][2t, 2t+1].
__device__ __forceinline__ void mma_bf16(float d[4], const __nv_bfloat16* a, int lda,
                                         const __nv_bfloat16* bt, int ldb, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const uint32_t a0 = *reinterpret_cast<const uint32_t*>(a + g * lda + 2 * t);
  const uint32_t a1 = *reinterpret_cast<const uint32_t*>(a + (g + 8) * lda + 2 * t);
  const uint32_t a2 = *reinterpret_cast<const uint32_t*>(a + g * lda + 2 * t + 8);
  const uint32_t a3 = *reinterpret_cast<const uint32_t*>(a + (g + 8) * lda + 2 * t + 8);
  const uint32_t b0 = *reinterpret_cast<const uint32_t*>(bt + g * ldb + 2 * t);
  const uint32_t b1 = *reinterpret_cast<const uint32_t*>(bt + g * ldb + 2 * t + 8);
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// x (n, h, w, cin) T; we (ce, cin) T; wp (cout, ce) T; be, bd (ce),
// kd (ce, 9), bp (cout) f32; y (n, ho, wo, cout) T. All contiguous.
template <typename T, bool kMma>
__global__ void __launch_bounds__(kThreads, kMma ? 2 : 1)
ir_block_eval_kernel(const T* __restrict__ x, const T* __restrict__ we,
                     const float* __restrict__ be, const float* __restrict__ kd,
                     const float* __restrict__ bd, const T* __restrict__ wp,
                     const float* __restrict__ bp, T* __restrict__ y, Geom g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem L = smem_layout(g, kMma);
  T* xs = reinterpret_cast<T*>(smem + L.xs);
  T* wes = reinterpret_cast<T*>(smem + L.wes);
  float* es = reinterpret_cast<float*>(smem + L.es);
  T* ds = reinterpret_cast<T*>(smem + L.ds);
  T* wps = reinterpret_cast<T*>(smem + L.wps);
  float* acc = reinterpret_cast<float*>(smem + L.acc);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int img = blockIdx.y;
  const int oy0 = (blockIdx.x / g.tiles_w) * g.th;
  const int ox0 = (blockIdx.x % g.tiles_w) * g.tw;
  const int iy0 = oy0 * g.stride - g.dil;
  const int ix0 = ox0 * g.stride - g.dil;
  const int hp = g.hh * g.hw;
  const int op = g.th * g.tw;
  const T* ximg = x + (size_t)img * g.h * g.w * g.cin;

  // input tile + halo, zero outside the image and in the padding; the mma
  // path moves 16 bytes (8 channels) per access
  constexpr int kVec = kMma ? 8 : 1;
  for (int i = tid; i < L.hp * (L.kx / kVec); i += kThreads) {
    const int p = i / (L.kx / kVec), k = (i - p * (L.kx / kVec)) * kVec;
    const int iy = iy0 + p / g.hw, ix = ix0 + p % g.hw;
    const bool in = p < hp && k < g.cin && iy >= 0 && iy < g.h && ix >= 0 && ix < g.w;
    const T* src = ximg + ((size_t)iy * g.w + ix) * g.cin + k;
    if constexpr (kMma) {
      *reinterpret_cast<uint4*>(xs + p * L.xs_ld + k) =
          in ? *reinterpret_cast<const uint4*>(src) : make_uint4(0, 0, 0, 0);
    } else {
      xs[p * L.xs_ld + k] = in ? *src : from_f<T>(0.f);
    }
  }
  for (int i = tid; i < L.op * L.acc_ld; i += kThreads) acc[i] = 0.f;
  float pacc[kMma ? kAccTiles : 1][4] = {};  // mma path: project accumulators
  const int pm_n = L.op / 16, pn_n = L.cp / 8;  // project tiles (mma path)

  for (int c0 = 0; c0 < g.ce; c0 += g.ch) {
    const int cw = min(g.ch, g.ce - c0);
    const int kc = kMma ? round_up(cw, 16) : cw;  // project depth this chunk
    __syncthreads();  // xs staged; the previous chunk's readers are done
    if constexpr (kMma) {
      const uint4 zero = make_uint4(0, 0, 0, 0);
      if (g.expand)
        for (int i = tid; i < g.ch * (L.kx / 8); i += kThreads) {
          const int c = i / (L.kx / 8), k = (i - c * (L.kx / 8)) * 8;
          *reinterpret_cast<uint4*>(wes + c * L.we_ld + k) =
              (c < cw && k < g.cin)
                  ? *reinterpret_cast<const uint4*>(we + (size_t)(c0 + c) * g.cin + k)
                  : zero;
        }
      for (int i = tid; i < L.cp * (kc / 8); i += kThreads) {
        const int o = i / (kc / 8), c = (i - o * (kc / 8)) * 8;
        *reinterpret_cast<uint4*>(wps + o * L.wp_ld + c) =
            (o < g.cout && c < cw)
                ? *reinterpret_cast<const uint4*>(wp + (size_t)o * g.ce + c0 + c)
                : zero;
      }
    } else {
      if (g.expand)
        for (int i = tid; i < cw * g.cin; i += kThreads) {
          const int c = i / g.cin, k = i - c * g.cin;
          wes[k * L.we_ld + c] = we[(size_t)(c0 + c) * g.cin + k];
        }
      for (int i = tid; i < g.cout * cw; i += kThreads) {
        const int o = i / cw, c = i - o * cw;
        wps[c * L.wp_ld + o] = wp[(size_t)o * g.ce + c0 + c];
      }
    }
    __syncthreads();

    // expand the halo pixels of this chunk (identity without an expand conv);
    // 0 for pixels outside the image
    if (kMma && g.expand) {
      const int mt_n = L.hp / 16, nt_n = g.ch / 8;
      for (int tt = warp; tt < mt_n * nt_n; tt += kWarps) {
        const int m0 = (tt / nt_n) * 16, n0 = (tt % nt_n) * 8;
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        for (int k0 = 0; k0 < L.kx; k0 += 16)
          mma_bf16(d, reinterpret_cast<const __nv_bfloat16*>(xs) + m0 * L.xs_ld + k0,
                   L.xs_ld, reinterpret_cast<const __nv_bfloat16*>(wes) + n0 * L.we_ld + k0,
                   L.we_ld, lane);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int p = m0 + (lane >> 2) + (r >> 1) * 8;
          const int c = n0 + 2 * (lane & 3) + (r & 1);
          const int iy = iy0 + p / g.hw, ix = ix0 + p % g.hw;
          float v = 0.f;
          if (p < hp && c < cw && iy >= 0 && iy < g.h && ix >= 0 && ix < g.w)
            v = relu6(d[r] + be[c0 + c]);
          es[p * L.es_ld + c] = v;
        }
      }
    } else {
      for (int i = tid; i < hp * cw; i += kThreads) {
        const int p = i / cw, c = i - p * cw;
        const int iy = iy0 + p / g.hw, ix = ix0 + p % g.hw;
        float v = 0.f;
        if (iy >= 0 && iy < g.h && ix >= 0 && ix < g.w) {
          const T* xr = xs + (size_t)p * L.xs_ld;
          if (g.expand) {
            float s = 0.f;
            for (int k = 0; k < g.cin; ++k)
              s = fmaf(to_f(xr[k]), to_f(wes[k * L.we_ld + c]), s);
            v = relu6(s + be[c0 + c]);
          } else {
            v = to_f(xr[c0 + c]);
          }
        }
        es[p * L.es_ld + c] = v;
      }
    }
    __syncthreads();

    // depthwise 3x3 (stride, dilation) + bias + relu6, rounded to T as the
    // project product's operand; zero in the depth padding of the mma path
    for (int i = tid; i < op * kc; i += kThreads) {
      const int q = i / kc, c = i - q * kc;
      float v = 0.f;
      if (c < cw) {
        const int qy = q / g.tw, qx = q - qy * g.tw;
        const float* k9 = kd + (size_t)(c0 + c) * 9;
        float s = 0.f;
#pragma unroll
        for (int ky = 0; ky < 3; ++ky)
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            const int p = (qy * g.stride + ky * g.dil) * g.hw + qx * g.stride + kx * g.dil;
            s = fmaf(es[p * L.es_ld + c], k9[ky * 3 + kx], s);
          }
        v = relu6(s + bd[c0 + c]);
      }
      ds[q * L.ds_ld + c] = from_f<T>(v);
    }
    __syncthreads();

    // project, accumulated in f32: tile j of this warp is 16x8 tile
    // warp + 8 j of the (op x cout) output, in registers on the mma path
    if constexpr (kMma) {
#pragma unroll
      for (int j = 0; j < kAccTiles; ++j) {
        const int tt = warp + j * kWarps;
        if (tt < pm_n * pn_n) {
          const int m0 = (tt % pm_n) * 16, n0 = (tt / pm_n) * 8;
          for (int k0 = 0; k0 < kc; k0 += 16)
            mma_bf16(pacc[j], reinterpret_cast<const __nv_bfloat16*>(ds) + m0 * L.ds_ld + k0,
                     L.ds_ld, reinterpret_cast<const __nv_bfloat16*>(wps) + n0 * L.wp_ld + k0,
                     L.wp_ld, lane);
        }
      }
    } else {
      // every thread owns the same (q, o) entries in every chunk
      for (int i = tid; i < op * g.cout; i += kThreads) {
        const int q = i / g.cout, o = i - q * g.cout;
        const T* dr = ds + (size_t)q * L.ds_ld;
        float s = 0.f;
        for (int c = 0; c < cw; ++c) s = fmaf(to_f(dr[c]), to_f(wps[c * L.wp_ld + o]), s);
        acc[q * L.acc_ld + o] += s;
      }
    }
  }
  __syncthreads();

  // epilogue: bias, f32 residual, cast; ragged tile edges are not written
  T* yimg = y + (size_t)img * g.ho * g.wo * g.cout;
  if constexpr (kMma) {
    // straight from the accumulator fragments: rows g and g+8 of the tile,
    // two neighbouring channels per store
#pragma unroll
    for (int j = 0; j < kAccTiles; ++j) {
      const int tt = warp + j * kWarps;
      if (tt >= pm_n * pn_n) continue;
      const int m0 = (tt % pm_n) * 16, o = (tt / pm_n) * 8 + 2 * (lane & 3);
      if (o >= g.cout) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = m0 + (lane >> 2) + 8 * h;
        const int qy = q / g.tw, qx = q - qy * g.tw;
        const int oy = oy0 + qy, ox = ox0 + qx;
        if (q >= op || oy >= g.ho || ox >= g.wo) continue;
        float v0 = pacc[j][2 * h] + bp[o], v1 = pacc[j][2 * h + 1] + bp[o + 1];
        if (g.res) {
          const T* xr = xs + ((qy + g.dil) * g.hw + qx + g.dil) * L.xs_ld + o;
          v0 += to_f(xr[0]);
          v1 += to_f(xr[1]);
        }
        *reinterpret_cast<__nv_bfloat162*>(yimg + ((size_t)oy * g.wo + ox) * g.cout + o) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  } else {
    for (int i = tid; i < op * g.cout; i += kThreads) {
      const int q = i / g.cout, o = i - q * g.cout;
      const int qy = q / g.tw, qx = q - qy * g.tw;
      const int oy = oy0 + qy, ox = ox0 + qx;
      if (oy >= g.ho || ox >= g.wo) continue;
      float v = acc[q * L.acc_ld + o] + bp[o];
      if (g.res) v += to_f(xs[((qy + g.dil) * g.hw + qx + g.dil) * L.xs_ld + o]);
      yimg[((size_t)oy * g.wo + ox) * g.cout + o] = from_f<T>(v);
    }
  }
}

template <typename T, bool kMma>
int launch(const Geom& g, const void* x, const void* we, const void* be, const void* kd,
           const void* bd, const void* wp, const void* bp, void* y, int smem_bytes,
           cudaStream_t stream) {
  const Smem L = smem_layout(g, kMma);
  if ((size_t)smem_bytes != L.total) return (int)cudaErrorInvalidValue;
  // the mma path moves 8 channels per access: 16-byte aligned rows
  if (kMma && (g.ch % 16 != 0 || g.cin % 8 != 0 || g.ce % 16 != 0 || g.cout % 8 != 0 ||
               (L.op / 16) * (L.cp / 8) > kWarps * kAccTiles ||
               (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(we) |
                reinterpret_cast<uintptr_t>(wp) | reinterpret_cast<uintptr_t>(y)) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(ir_block_eval_kernel<T, kMma>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int tiles_h = (g.ho + g.th - 1) / g.th;
  dim3 grid(tiles_h * g.tiles_w, g.n);
  ir_block_eval_kernel<T, kMma><<<grid, kThreads, smem_bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(we), static_cast<const float*>(be),
      static_cast<const float*>(kd), static_cast<const float*>(bd),
      static_cast<const T*>(wp), static_cast<const float*>(bp), static_cast<T*>(y), g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 float32 (FMA), 1 bfloat16 (tensor cores). Returns a cudaError_t
// value (0 = success).
int kdcc_ir_block_eval(int dtype, const void* x, const void* we, const void* be,
                       const void* kd, const void* bd, const void* wp, const void* bp,
                       void* y, int n, int h, int w, int cin, int ce, int cout, int stride,
                       int dil, int expand, int res, int th, int tw, int ch, int smem_bytes,
                       int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (stride != 1 && stride != 2) return (int)cudaErrorInvalidValue;
  if (res && (stride != 1 || cin != cout)) return (int)cudaErrorInvalidValue;
  if (!expand && cin != ce) return (int)cudaErrorInvalidValue;
  Geom g;
  g.n = n; g.h = h; g.w = w; g.cin = cin; g.ce = ce; g.cout = cout;
  g.ho = (h - 1) / stride + 1;  // 3x3, padding == dilation
  g.wo = (w - 1) / stride + 1;
  g.stride = stride; g.dil = dil; g.expand = expand; g.res = res;
  g.th = th; g.tw = tw;
  g.hh = (th - 1) * stride + 2 * dil + 1;
  g.hw = (tw - 1) * stride + 2 * dil + 1;
  g.ch = ch;
  g.tiles_w = (g.wo + tw - 1) / tw;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float, false>(g, x, we, be, kd, bd, wp, bp, y, smem_bytes, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, true>(g, x, we, be, kd, bd, wp, bp, y, smem_bytes, s);
  return (int)cudaErrorInvalidValue;
}

const char* kdcc_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"

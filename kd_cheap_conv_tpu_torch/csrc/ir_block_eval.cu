// Eval-mode MobileNetV2 inverted-residual block, BN folded, one launch per block.
//
// Replaces the Pallas eval kernels of kd_cheap_conv_tpu/ops/pallas/irchain.py:
//   stride 1: fused_mnv2_blocks_eval (body _k_ir_eval)            -> kernel A
//   stride 2: fused_ir_block_s2_eval (stem.py _run_bn_pw,
//             _run_bn_dw_s2 and an XLA affine: three passes)       -> kernel B
// Both are the same template here; only the dw stride differs.
//
// What it computes, per output pixel (every BN folded by the wrapper):
//   h = relu6(x . We^T + be)      f32, kept in f32; x itself without an expand
//   h = 0 at halo pixels outside the image (the dw conv pads h, not x)
//   t = relu6(dw3x3(h; stride, dilation) + bd), rounded to the activation dtype
//   y = t . Wp^T + bp (+ x, the f32 residual), rounded once
// The expanded hidden activation (up to 960 channels, 6x the input) never
// leaves the SM: between blocks only x and y touch device memory.
//
// What bounds it on an H100: at 513² and batch 4 the blocks are a few
// GFLOP and a few MB each, far below the card's rates (PERF.md: the bound
// is 0.026 ms for all 14 A blocks); what the time goes to is latency:
// barriers, copies nobody overlaps, re-reading weights, re-expanding the
// halo. The two kernels below answer that differently by dtype.
//
// bfloat16 (namespace irb, the main path): one launch on one wave of
// persistent CTAs (512 threads, one CTA an SM) that walk th x tw output
// tiles; the hidden channels are taken in chunks of ch. Per tile:
//   x halo   cp.async into one of two slots, issued while the tile before is
//            computed (zero fill is the image border; pads stay zero)
//   weights  a chunk's We, Wp slices and its dw taps and biases into a slot
//            by five bulk copies (cp.async.bulk, completing on the slot's
//            mbarrier) that one thread issues: the wrapper keeps We with
//            padded rows and Wp chunk-major (ops/irchain_eval.py
//            bf16_weights), so each slice is one contiguous block laid out
//            as the slot holds it. Resident for the launch when the CTA
//            walks several tiles and they fit, else a ring of 3 slots two
//            chunks ahead
//   phase A  expand of chunk c (ldmatrix + mma.sync m16n8k16, f32 sums,
//            + be, relu6, masked) -> es (f32), and, on the same warps, the
//            project of chunk c - 1 into registers (ldmatrix + mma.sync)
//   phase B  depthwise of chunk c: a thread keeps a channel pair's 9 taps
//            and bias in registers and slides a window along 4 outputs of a
//            row -> ds (bf16, the project's operand)
// two barriers a chunk; after the last chunk its project, then y = acc + bp
// (+ x from the staged halo) stored as bf16 pairs. The plan (th, tw, ch,
// the warps' split of the project, resident or ring, grid) is the Python
// planner's (ops/irchain_eval.py plan_bf16, cached per shape); the launcher
// recomputes the shared-memory layout from it and refuses a mismatch. Every
// output has one owner and every sum a fixed order: y is the same bits on
// every call.
//
// float32 (parity checks only): the first design, kept as it was: one CTA
// per tile of a grid, plain FMAs (exact to f32 rounding; TF32 would not be),
// four barrier phases a chunk, weights staged per chunk by plain loads.
//
// The C entry points launch on the caller's stream and return
// cudaGetLastError(); the Python wrapper raises if it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"
#include "wgmma.cuh"

namespace {

__device__ __forceinline__ float relu6(float v) { return fminf(fmaxf(v, 0.f), 6.f); }

// ---------------------------------------------------------------------------
// float32: one CTA per output tile
// ---------------------------------------------------------------------------

namespace f32k {

constexpr int kThreads = 256;

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

// Shared-memory layout: byte offsets (the Python planner, smem_bytes,
// computes the same total and the launcher checks that the two agree)
struct Smem {
  size_t xs, wes, es, ds, wps, acc, total;
};

__host__ __device__ inline size_t round16(size_t b) { return (b + 15) / 16 * 16; }

// xs: [hp][cin]; wes: [cin][ch]; es: [hp][ch]; ds: [op][ch]; wps: [ch][cout];
// acc: [op][cout]
__host__ __device__ inline Smem smem_layout(const Geom& g) {
  Smem s;
  const size_t hp = (size_t)g.hh * g.hw, op = (size_t)g.th * g.tw;
  size_t o = 0;
  s.xs = o;  o += round16(hp * g.cin * 4);
  s.wes = o; o += g.expand ? round16((size_t)g.cin * g.ch * 4) : 0;
  s.es = o;  o += round16(hp * g.ch * 4);
  s.ds = o;  o += round16(op * g.ch * 4);
  s.wps = o; o += round16((size_t)g.ch * g.cout * 4);
  s.acc = o; o += round16(op * g.cout * 4);
  s.total = o;
  return s;
}

// x (n, h, w, cin); we (ce, cin); wp (cout, ce); be, bd (ce), kd (ce, 9),
// bp (cout); y (n, ho, wo, cout). All f32, contiguous.
__global__ void __launch_bounds__(kThreads, 1)
ir_block_eval_kernel(const float* __restrict__ x, const float* __restrict__ we,
                     const float* __restrict__ be, const float* __restrict__ kd,
                     const float* __restrict__ bd, const float* __restrict__ wp,
                     const float* __restrict__ bp, float* __restrict__ y, Geom g) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem L = smem_layout(g);
  float* xs = reinterpret_cast<float*>(smem + L.xs);
  float* wes = reinterpret_cast<float*>(smem + L.wes);
  float* es = reinterpret_cast<float*>(smem + L.es);
  float* ds = reinterpret_cast<float*>(smem + L.ds);
  float* wps = reinterpret_cast<float*>(smem + L.wps);
  float* acc = reinterpret_cast<float*>(smem + L.acc);

  const int tid = threadIdx.x;
  const int img = blockIdx.y;
  const int oy0 = (blockIdx.x / g.tiles_w) * g.th;
  const int ox0 = (blockIdx.x % g.tiles_w) * g.tw;
  const int iy0 = oy0 * g.stride - g.dil;
  const int ix0 = ox0 * g.stride - g.dil;
  const int hp = g.hh * g.hw;
  const int op = g.th * g.tw;
  const float* ximg = x + (size_t)img * g.h * g.w * g.cin;

  // input tile + halo, zero outside the image
  for (int i = tid; i < hp * g.cin; i += kThreads) {
    const int p = i / g.cin, k = i - p * g.cin;
    const int iy = iy0 + p / g.hw, ix = ix0 + p % g.hw;
    const bool in = iy >= 0 && iy < g.h && ix >= 0 && ix < g.w;
    xs[i] = in ? ximg[((size_t)iy * g.w + ix) * g.cin + k] : 0.f;
  }
  for (int i = tid; i < op * g.cout; i += kThreads) acc[i] = 0.f;

  for (int c0 = 0; c0 < g.ce; c0 += g.ch) {
    const int cw = min(g.ch, g.ce - c0);
    __syncthreads();  // xs staged; the previous chunk's readers are done
    if (g.expand)
      for (int i = tid; i < cw * g.cin; i += kThreads) {
        const int c = i / g.cin, k = i - c * g.cin;
        wes[k * g.ch + c] = we[(size_t)(c0 + c) * g.cin + k];
      }
    for (int i = tid; i < g.cout * cw; i += kThreads) {
      const int o = i / cw, c = i - o * cw;
      wps[c * g.cout + o] = wp[(size_t)o * g.ce + c0 + c];
    }
    __syncthreads();

    // expand the halo pixels of this chunk (identity without an expand
    // conv); 0 for pixels outside the image
    for (int i = tid; i < hp * cw; i += kThreads) {
      const int p = i / cw, c = i - p * cw;
      const int iy = iy0 + p / g.hw, ix = ix0 + p % g.hw;
      float v = 0.f;
      if (iy >= 0 && iy < g.h && ix >= 0 && ix < g.w) {
        const float* xr = xs + (size_t)p * g.cin;
        if (g.expand) {
          float s = 0.f;
          for (int k = 0; k < g.cin; ++k) s = fmaf(xr[k], wes[k * g.ch + c], s);
          v = relu6(s + be[c0 + c]);
        } else {
          v = xr[c0 + c];
        }
      }
      es[p * g.ch + c] = v;
    }
    __syncthreads();

    // depthwise 3x3 (stride, dilation) + bias + relu6
    for (int i = tid; i < op * cw; i += kThreads) {
      const int q = i / cw, c = i - q * cw;
      const int qy = q / g.tw, qx = q - qy * g.tw;
      const float* k9 = kd + (size_t)(c0 + c) * 9;
      float s = 0.f;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const int p = (qy * g.stride + ky * g.dil) * g.hw + qx * g.stride + kx * g.dil;
          s = fmaf(es[p * g.ch + c], k9[ky * 3 + kx], s);
        }
      ds[q * g.ch + c] = relu6(s + bd[c0 + c]);
    }
    __syncthreads();

    // project, accumulated in f32: every thread owns the same (q, o)
    // entries in every chunk
    for (int i = tid; i < op * g.cout; i += kThreads) {
      const int q = i / g.cout, o = i - q * g.cout;
      const float* dr = ds + (size_t)q * g.ch;
      float s = 0.f;
      for (int c = 0; c < cw; ++c) s = fmaf(dr[c], wps[c * g.cout + o], s);
      acc[i] += s;
    }
  }
  __syncthreads();

  // epilogue: bias, residual; ragged tile edges are not written
  float* yimg = y + (size_t)img * g.ho * g.wo * g.cout;
  for (int i = tid; i < op * g.cout; i += kThreads) {
    const int q = i / g.cout, o = i - q * g.cout;
    const int qy = q / g.tw, qx = q - qy * g.tw;
    const int oy = oy0 + qy, ox = ox0 + qx;
    if (oy >= g.ho || ox >= g.wo) continue;
    float v = acc[i] + bp[o];
    if (g.res) v += xs[((qy + g.dil) * g.hw + qx + g.dil) * g.cin + o];
    yimg[((size_t)oy * g.wo + ox) * g.cout + o] = v;
  }
}

int launch(const Geom& g, const void* x, const void* we, const void* be, const void* kd,
           const void* bd, const void* wp, const void* bp, void* y, int smem_bytes,
           cudaStream_t stream) {
  if ((size_t)smem_bytes != smem_layout(g).total) return (int)cudaErrorInvalidValue;
  static bool raised = false;
  if (!raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        ir_block_eval_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (err != cudaSuccess) return (int)err;
    raised = true;
  }
  const int tiles_h = (g.ho + g.th - 1) / g.th;
  dim3 grid(tiles_h * g.tiles_w, g.n);
  ir_block_eval_kernel<<<grid, kThreads, smem_bytes, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(we),
      static_cast<const float*>(be), static_cast<const float*>(kd),
      static_cast<const float*>(bd), static_cast<const float*>(wp),
      static_cast<const float*>(bp), static_cast<float*>(y), g);
  return (int)cudaGetLastError();
}

}  // namespace f32k

// ---------------------------------------------------------------------------
// bfloat16: one wave of persistent CTAs (see the head of the file)
// ---------------------------------------------------------------------------

namespace irb {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kSeg = 4;               // dw outputs a thread takes along a row
constexpr int kMaxM = 3, kMaxN = 3;   // project sub-tiles (16 x 8) a warp holds
constexpr int kRing = 3;              // weight slots when they stream
constexpr int kSmemMax = 232448;

struct Geom {
  const bf16* x;          // (n, h, w, cin)
  const bf16* we;         // (ce, r16(cin) + 8), zero past cin; null without an expand
  const float* be;        // (ce,); null without an expand
  const float* kd;        // (ce, 9)
  const float* bd;        // (ce,)
  const bf16* wp;         // (ce / ch, cout, ch + 8): chunk-major, zero past ch
  const float* bp;        // (cout,)
  bf16* y;                // (n, ho, wo, cout)
  int n, h, w, cin, ce, cout, ho, wo, stride, dil, expand, res;
  int th, tw, ch, wn, resident, grid;   // the plan
  int tiles_w, tiles_img, ntiles;
};

// The shared-memory layout of a plan, computed alike on the host (the
// launcher's check) and the device; ops/irchain_eval.py bf16_smem mirrors
// it. Regions 128-byte aligned:
//   x slots   [xsl][mp][ldx] bf16, the halo (rows past hp and columns past
//             cin zero)
//   w slots   [wsl] x { We [ch][ldx] bf16 (columns past cin zero), Wp
//             [cout][ldc] bf16, taps [ch][9] f32, bd [ch], be [ch] }
//   es        [hp][ldc] f32, the expanded chunk (with an expand)
//   ds        [opp][ldc] bf16, the depthwise output of the chunk
//   bars      [wsl] mbarriers, one a weight slot
// Row strides ldx = r16(cin) + 8 and ldc = ch + 8 (bf16) are an odd number
// of 16-byte units: ldmatrix reads them without bank conflicts.
struct Lay {
  int hh, hw, hp, mp, op, opp, kx, ldx, ldc, nch, xsl, wsl;
  int mt, nt, wm, mper, nper;                 // the project's split over the warps
  int o_we, o_wp, o_kd, o_bd, o_be, wslot;    // within a weight slot
  int wbytes;                                 // bytes a slot's copies bring
  int xslot, o_x, o_w, o_es, o_ds, o_bar, total;
};

__host__ __device__ inline int r16i(int v) { return (v + 15) / 16 * 16; }
__host__ __device__ inline int up128(int b) { return (b + 127) / 128 * 128; }

__host__ __device__ inline Lay layout(const Geom& g) {
  Lay L;
  L.hh = (g.th - 1) * g.stride + 2 * g.dil + 1;
  L.hw = (g.tw - 1) * g.stride + 2 * g.dil + 1;
  L.hp = L.hh * L.hw;
  L.mp = r16i(L.hp);
  L.op = g.th * g.tw;
  L.opp = r16i(L.op);
  L.kx = r16i(g.cin);
  L.ldx = L.kx + 8;
  L.ldc = g.ch + 8;
  L.nch = g.ce / g.ch;
  L.xsl = g.grid < g.ntiles ? 2 : 1;
  L.wsl = g.resident ? L.nch : kRing;
  L.mt = L.opp / 16;
  L.nt = g.cout / 8;
  L.wm = kWarps / g.wn;
  L.mper = (L.mt + L.wm - 1) / L.wm;
  L.nper = (L.nt + g.wn - 1) / g.wn;
  int o = 0;
  L.o_we = o; o += g.expand ? up128(g.ch * L.ldx * 2) : 0;
  L.o_wp = o; o += up128(g.cout * L.ldc * 2);
  L.o_kd = o; o += up128(g.ch * 9 * 4);
  L.o_bd = o; o += up128(g.ch * 4);
  L.o_be = o; o += g.expand ? up128(g.ch * 4) : 0;
  L.wslot = o;
  L.wbytes = (g.expand ? g.ch * L.ldx * 2 + g.ch * 4 : 0) + g.cout * L.ldc * 2 + g.ch * 40;
  L.xslot = up128(L.mp * L.ldx * 2);
  o = 0;
  L.o_x = o;  o += L.xsl * L.xslot;
  L.o_w = o;  o += L.wsl * L.wslot;
  L.o_es = o; o += g.expand ? up128(L.hp * L.ldc * 4) : 0;
  L.o_ds = o; o += up128(L.opp * L.ldc * 2);
  L.o_bar = o; o += up128(L.wsl * 8);
  L.total = o;
  return L;
}

__device__ __forceinline__ void tile_origin(const Geom& g, int tile, int& img, int& oy0,
                                            int& ox0) {
  img = tile / g.tiles_img;
  const int r = tile - img * g.tiles_img;
  oy0 = (r / g.tiles_w) * g.th;
  ox0 = (r % g.tiles_w) * g.tw;
}

// the input halo of `tile` into an x slot, 16 bytes a copy; outside the
// image the copy reads nothing and fills zeros. A thread keeps one 16-byte
// unit of a pixel and walks the pixels (no division per copy).
__device__ void stage_x(const Geom& g, const Lay& L, bf16* xs, int tile) {
  int img, oy0, ox0;
  tile_origin(g, tile, img, oy0, ox0);
  const int iy0 = oy0 * g.stride - g.dil, ix0 = ox0 * g.stride - g.dil;
  const int cu = g.cin / 8, rows = kThreads / cu, u = threadIdx.x % cu;
  const bf16* ximg = g.x + (size_t)img * g.h * g.w * g.cin + 8 * u;
  int p = threadIdx.x / cu;
  if (p >= rows) return;
  int py = p / L.hw, px = p - py * L.hw;
  const int sy = rows / L.hw, sx = rows - sy * L.hw;
  for (; p < L.hp; p += rows) {
    const int iy = iy0 + py, ix = ix0 + px;
    const bool in = iy >= 0 && iy < g.h && ix >= 0 && ix < g.w;
    const bf16* src = in ? ximg + ((size_t)iy * g.w + ix) * g.cin : g.x;
    hop::cp_async16_zfill(xs + p * L.ldx + 8 * u, src, in ? 16u : 0u);
    py += sy, px += sx;
    if (px >= L.hw) px -= L.hw, ++py;
  }
}

// rows x units 16-byte copies of a row-major block: row r, unit u from
// src + r * src_ld + 8 u to dst + r * dst_ld + 8 u (bf16 elements)
__device__ __forceinline__ void copy_rows(bf16* dst, int dst_ld, const bf16* src, size_t src_ld,
                                          int rows, int units) {
  const int step = kThreads / units, u = threadIdx.x % units;
  for (int r = threadIdx.x / units; r < rows && threadIdx.x < step * units; r += step)
    hop::cp_async16(dst + r * dst_ld + 8 * u, src + r * src_ld + 8 * u);
}
__device__ __forceinline__ void copy_floats(float* dst, const float* src, int n) {
  for (int i = threadIdx.x; i < n / 4; i += kThreads) hop::cp_async16(dst + 4 * i, src + 4 * i);
}

// chunk c's weights, taps and biases into a weight slot: five bulk copies
// by one thread, announced on the slot's mbarrier
__device__ void stage_w(const Geom& g, const Lay& L, unsigned char* slot, int c, uint64_t* bar) {
  const int c0 = c * g.ch;
  hop::mbar_expect_tx(bar, L.wbytes);
  if (g.expand) {
    hop::bulk_copy(slot + L.o_we, g.we + (size_t)c0 * L.ldx, g.ch * L.ldx * 2, bar);
    hop::bulk_copy(slot + L.o_be, g.be + c0, g.ch * 4, bar);
  }
  hop::bulk_copy(slot + L.o_wp, g.wp + (size_t)c * g.cout * L.ldc, g.cout * L.ldc * 2, bar);
  hop::bulk_copy(slot + L.o_kd, g.kd + (size_t)c0 * 9, g.ch * 36, bar);
  hop::bulk_copy(slot + L.o_bd, g.bd + c0, g.ch * 4, bar);
}

// phase A, expand: es[p][c] = relu6(x[p] . We[c] + be[c]) at halo pixels in
// the image, 0 outside; a warp's unit is 16 pixels x 16 channels
__device__ void expand(const Geom& g, const Lay& L, const bf16* xs, const unsigned char* slot,
                       float* es, int iy0, int ix0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* we = reinterpret_cast<const bf16*>(slot + L.o_we);
  const float* be = reinterpret_cast<const float*>(slot + L.o_be);
  const int mtiles = L.mp / 16, units = mtiles * (g.ch / 16);
  for (int u = warp; u < units; u += kWarps) {
    const int m = u % mtiles, nb = u / mtiles;
    float d[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    const bf16* pa = xs + (16 * m + (lane & 15)) * L.ldx + (lane >> 4) * 8;
    const bf16* pb = we + (16 * nb + (lane & 7) + ((lane >> 4) << 3)) * L.ldx + ((lane >> 3) & 1) * 8;
    for (int k = 0; k < L.kx; k += 16) {
      uint32_t a[4], b[4];
      ldsm_x4(a, pa + k);
      ldsm_x4(b, pb + k);
      const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
      mma_bf16(d[0], a, b0);
      mma_bf16(d[1], a, b1);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = 16 * m + (lane >> 2) + 8 * r;
      if (p >= L.hp) continue;
      const int py = p / L.hw;
      const int iy = iy0 + py, ix = ix0 + p - py * L.hw;
      const bool in = iy >= 0 && iy < g.h && ix >= 0 && ix < g.w;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = 16 * nb + 8 * j + 2 * (lane & 3);
        const float2 bb = *reinterpret_cast<const float2*>(be + c);
        const float v0 = in ? relu6(d[j][2 * r] + bb.x) : 0.f;
        const float v1 = in ? relu6(d[j][2 * r + 1] + bb.y) : 0.f;
        *reinterpret_cast<float2*>(es + p * L.ldc + c) = make_float2(v0, v1);
      }
    }
  }
}

// the project of one chunk into this warp's accumulators: the warp holds
// m-tiles wm_i + i * wm (i < mper) and n-tiles wn_i * nper + j (j < nper)
__device__ __forceinline__ void project(const Geom& g, const Lay& L, const bf16* ds,
                                        const unsigned char* slot,
                                        float (&acc)[kMaxM][kMaxN][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wn_i = warp % g.wn, wm_i = warp / g.wn;
  const bf16* wp = reinterpret_cast<const bf16*>(slot + L.o_wp);
  for (int k0 = 0; k0 < g.ch; k0 += 16) {
    uint32_t b[kMaxN][2];
#pragma unroll
    for (int j = 0; j < kMaxN; ++j) {
      const int nt = wn_i * L.nper + j;
      b[j][0] = b[j][1] = 0u;
      if (j < L.nper && nt < L.nt)
        ldsm_x2(b[j], wp + (8 * nt + (lane & 7)) * L.ldc + k0 + ((lane >> 3) & 1) * 8);
    }
#pragma unroll
    for (int i = 0; i < kMaxM; ++i) {
      const int mt = wm_i + i * L.wm;
      if (i >= L.mper || mt >= L.mt) continue;
      uint32_t a[4];
      ldsm_x4(a, ds + (16 * mt + (lane & 15)) * L.ldc + k0 + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < kMaxN; ++j)
        if (j < L.nper && wn_i * L.nper + j < L.nt) mma_bf16(acc[i][j], a, b[j]);
    }
  }
}

// phase B, depthwise of one chunk: a thread owns a channel pair (its 18 taps
// and 2 biases in registers) and segments of kSeg outputs along a row; per
// kernel row it loads the window its segment reads once (compile-time
// stride and dilation; D == 0: the dilation at run time, taps read per
// output). Outputs past the tile's width are computed on clamped columns
// and not stored. The sum runs over ky, then kx, from 0, as the f32 kernel.
template <int S, int D, bool kExp>
__device__ __forceinline__ void depthwise(const Geom& g, const Lay& L, const float* es,
                                          const bf16* xs, int c0, const unsigned char* slot,
                                          bf16* ds) {
  const int tid = threadIdx.x, cp = g.ch / 2, tpp = kThreads / cp;
  if (tid >= cp * tpp) return;
  const int c = 2 * (tid % cp);
  const float* kd = reinterpret_cast<const float*>(slot + L.o_kd);
  const float* bd = reinterpret_cast<const float*>(slot + L.o_bd);
  float k0[9], k1[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) k0[t] = kd[c * 9 + t], k1[t] = kd[c * 9 + 9 + t];
  const float b0 = bd[c], b1 = bd[c + 1];
  const int dil = D > 0 ? D : g.dil;
  const int nsx = (g.tw + kSeg - 1) / kSeg, nseg = g.th * nsx;
  auto at = [&](int p) -> float2 {
    if constexpr (kExp) return *reinterpret_cast<const float2*>(es + p * L.ldc + c);
    else return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xs + p * L.ldx + c0 + c));
  };
  for (int sg = tid / cp; sg < nseg; sg += tpp) {
    const int y = sg / nsx, x0 = (sg - y * nsx) * kSeg;
    float a0[kSeg], a1[kSeg];
#pragma unroll
    for (int r = 0; r < kSeg; ++r) a0[r] = a1[r] = 0.f;
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
      const int row = (y * S + ky * dil) * L.hw;
      if constexpr (D > 0) {
        constexpr int W = (kSeg - 1) * S + 2 * D + 1;
        float2 v[W];
#pragma unroll
        for (int k = 0; k < W; ++k) v[k] = at(row + min(x0 * S + k, L.hw - 1));
#pragma unroll
        for (int r = 0; r < kSeg; ++r)
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            const float2 e = v[r * S + kx * D];
            a0[r] = fmaf(e.x, k0[ky * 3 + kx], a0[r]);
            a1[r] = fmaf(e.y, k1[ky * 3 + kx], a1[r]);
          }
      } else {
#pragma unroll
        for (int r = 0; r < kSeg; ++r)
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            const float2 e = at(row + min((x0 + r) * S + kx * dil, L.hw - 1));
            a0[r] = fmaf(e.x, k0[ky * 3 + kx], a0[r]);
            a1[r] = fmaf(e.y, k1[ky * 3 + kx], a1[r]);
          }
      }
    }
#pragma unroll
    for (int r = 0; r < kSeg; ++r)
      if (x0 + r < g.tw)
        *reinterpret_cast<__nv_bfloat162*>(ds + (y * g.tw + x0 + r) * L.ldc + c) =
            __floats2bfloat162_rn(relu6(a0[r] + b0), relu6(a1[r] + b1));
  }
}

template <int S, int D>
__global__ void __launch_bounds__(kThreads, 1) ir_block_eval_kernel(const Geom g) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Lay L = layout(g);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* es = reinterpret_cast<float*>(smem + L.o_es);
  bf16* ds = reinterpret_cast<bf16*>(smem + L.o_ds);

  // the halo's padding rows and columns are read by the expand and stay
  // zero: zero the x slots first; one mbarrier a weight slot
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.o_bar);
  for (int i = tid; i < L.o_w / 16; i += kThreads)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  if (tid == 0) {
    for (int j = 0; j < L.wsl; ++j) hop::mbar_init(&full[j], 1);
    hop::mbar_init_fence();
  }
  __syncthreads();

  const int ntl = (g.ntiles - 1 - (int)blockIdx.x) / g.grid + 1;   // this CTA's tiles
  const int steps = ntl * L.nch;
  auto slot_of = [&](int s) { return g.resident ? s % L.nch : s % kRing; };
  auto wslot = [&](int s) -> unsigned char* { return smem + L.o_w + slot_of(s) * L.wslot; };
  auto xslot = [&](int i) -> bf16* {
    return reinterpret_cast<bf16*>(smem + L.o_x + (i % L.xsl) * L.xslot);
  };
  // issue t: step t's weights (each step while they stream, the first
  // tile's when resident; the k-th fill of a ring slot completes phase k of
  // its mbarrier), by the last thread, and at a tile's first step that
  // tile's x halo as cp.async group t; each must have landed before step
  // t's phase A. Step s issues t = s + 2, so a slot is refilled only after
  // the barrier behind its last reader. With one chunk a tile, tile j's
  // halo goes into group j + 1 (issued during tile j - 1, when tile j - 2
  // is done with the slot) and phase A waits for every group.
  auto issue = [&](int t) {
    if (tid == kThreads - 1 && t < steps && (!g.resident || t < L.nch))
      stage_w(g, L, wslot(t), t % L.nch, &full[slot_of(t)]);
    const int xt = L.nch > 1 ? (t % L.nch == 0 ? t / L.nch : -1) : (t == 0 ? 0 : t - 1);
    if (xt >= 0 && xt < ntl && (L.nch > 1 || t != 1))
      stage_x(g, L, xslot(xt), (int)blockIdx.x + xt * g.grid);
    hop::cp_async_commit();
  };
  issue(0);
  issue(1);

  const int wn_i = warp % g.wn, wm_i = warp / g.wn;
  float bias[kMaxN][2];   // bp of this thread's output channels
#pragma unroll
  for (int b = 0; b < kMaxN; ++b) {
    const int o = 8 * min(wn_i * L.nper + b, L.nt - 1) + 2 * (lane & 3);
    bias[b][0] = __ldg(g.bp + o), bias[b][1] = __ldg(g.bp + o + 1);
  }
  for (int i = 0; i < ntl; ++i) {
    int img, oy0, ox0;
    tile_origin(g, (int)blockIdx.x + i * g.grid, img, oy0, ox0);
    const int iy0 = oy0 * S - g.dil, ix0 = ox0 * S - g.dil;
    const bf16* xs = xslot(i);
    float acc[kMaxM][kMaxN][4];
#pragma unroll
    for (int a = 0; a < kMaxM; ++a)
#pragma unroll
      for (int b = 0; b < kMaxN; ++b) acc[a][b][0] = acc[a][b][1] = acc[a][b][2] = acc[a][b][3] = 0.f;

    for (int c = 0; c < L.nch; ++c) {
      const int s = i * L.nch + c;
      hop::mbar_wait(&full[slot_of(s)], g.resident ? 0u : (uint32_t)((s / kRing) & 1));
      if (L.nch > 1) hop::cp_async_wait<1>();
      else hop::cp_async_wait<0>();
      __syncthreads();   // step s's copies landed; phase B of the step before is done
      if (g.expand) expand(g, L, xs, wslot(s), es, iy0, ix0);
      if (c > 0) project(g, L, ds, wslot(s - 1), acc);
      __syncthreads();   // es written, ds read
      issue(s + 2);
      if (g.expand) depthwise<S, D, true>(g, L, es, xs, c * g.ch, wslot(s), ds);
      else depthwise<S, D, false>(g, L, es, xs, c * g.ch, wslot(s), ds);
    }
    __syncthreads();     // ds of the last chunk written
    project(g, L, ds, wslot(i * L.nch + L.nch - 1), acc);

    // epilogue: bias, the f32 residual from the staged halo, one rounding;
    // ragged tile edges are not written
    bf16* yimg = g.y + (size_t)img * g.ho * g.wo * g.cout;
#pragma unroll
    for (int a = 0; a < kMaxM; ++a) {
      const int mt = wm_i + a * L.wm;
      if (a >= L.mper || mt >= L.mt) continue;
#pragma unroll
      for (int b = 0; b < kMaxN; ++b) {
        const int nt = wn_i * L.nper + b;
        if (b >= L.nper || nt >= L.nt) continue;
        const int o = 8 * nt + 2 * (lane & 3);
        const float bp0 = bias[b][0], bp1 = bias[b][1];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = 16 * mt + (lane >> 2) + 8 * h;
          if (q >= L.op) continue;
          const int qy = q / g.tw, qx = q - qy * g.tw;
          const int oy = oy0 + qy, ox = ox0 + qx;
          if (oy >= g.ho || ox >= g.wo) continue;
          float v0 = acc[a][b][2 * h] + bp0, v1 = acc[a][b][2 * h + 1] + bp1;
          if (g.res) {
            const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                xs + ((qy * S + g.dil) * L.hw + qx * S + g.dil) * L.ldx + o));
            v0 += r.x;
            v1 += r.y;
          }
          *reinterpret_cast<__nv_bfloat162*>(yimg + ((size_t)oy * g.wo + ox) * g.cout + o) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
  hop::cp_async_wait<0>();
}

template <int S, int D> int launch(const Geom& g, int smem, cudaStream_t stream) {
  static bool raised = false;   // the shared-memory opt-in, once per instance
  if (!raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        ir_block_eval_kernel<S, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return (int)err;
    raised = true;
  }
  ir_block_eval_kernel<S, D><<<g.grid, kThreads, smem, stream>>>(g);
  return (int)cudaGetLastError();
}

}  // namespace irb

}  // namespace

extern "C" {

// float32 (the parity kernel). Returns a cudaError_t value (0 = success).
int kdcc_ir_block_eval(const void* x, const void* we, const void* be, const void* kd,
                       const void* bd, const void* wp, const void* bp, void* y, int n, int h,
                       int w, int cin, int ce, int cout, int stride, int dil, int expand,
                       int res, int th, int tw, int ch, int smem_bytes, int device,
                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (stride != 1 && stride != 2) return (int)cudaErrorInvalidValue;
  if (res && (stride != 1 || cin != cout)) return (int)cudaErrorInvalidValue;
  if (!expand && cin != ce) return (int)cudaErrorInvalidValue;
  f32k::Geom g;
  g.n = n; g.h = h; g.w = w; g.cin = cin; g.ce = ce; g.cout = cout;
  g.ho = (h - 1) / stride + 1;  // 3x3, padding == dilation
  g.wo = (w - 1) / stride + 1;
  g.stride = stride; g.dil = dil; g.expand = expand; g.res = res;
  g.th = th; g.tw = tw;
  g.hh = (th - 1) * stride + 2 * dil + 1;
  g.hw = (tw - 1) * stride + 2 * dil + 1;
  g.ch = ch;
  g.tiles_w = (g.wo + tw - 1) / tw;
  return f32k::launch(g, x, we, be, kd, bd, wp, bp, y, smem_bytes,
                      static_cast<cudaStream_t>(stream));
}

// bfloat16 in one launch on the plan (th, tw, ch, wn, resident, grid) of
// ops/irchain_eval.py plan_bf16: stride 1 at any dilation, stride 2 at
// dilation 1. smem must be the plan's layout total; we and wp laid out as
// bf16_weights keeps them for that ch. All pointers 16-byte aligned; cin,
// cout divisible by 8, ce and ch by 16, ch dividing ce. Returns a
// cudaError_t value (0 = success).
int kdcc_ir_block_eval_bf16(const void* x, const void* we, const void* be, const void* kd,
                            const void* bd, const void* wp, const void* bp, void* y, int n,
                            int h, int w, int cin, int ce, int cout, int stride, int dil,
                            int expand, int res, int th, int tw, int ch, int wn, int resident,
                            int grid, int smem, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const uintptr_t bits = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(kd) |
                         reinterpret_cast<uintptr_t>(bd) | reinterpret_cast<uintptr_t>(wp) |
                         reinterpret_cast<uintptr_t>(bp) | reinterpret_cast<uintptr_t>(y) |
                         reinterpret_cast<uintptr_t>(we) | reinterpret_cast<uintptr_t>(be);
  if (x == nullptr || kd == nullptr || bd == nullptr || wp == nullptr || bp == nullptr ||
      y == nullptr || (expand && (we == nullptr || be == nullptr)) || bits % 16 ||
      (stride != 1 && stride != 2) || dil < 1 || (res && (stride != 1 || cin != cout)) ||
      (!expand && cin != ce) || n < 1 || h < 1 || w < 1 || cin < 8 || cin % 8 || cout < 8 ||
      cout % 8 || ce % 16 || ch < 16 || ch % 16 || ce % ch || th < 1 || tw < 1 ||
      !(wn == 1 || wn == 2 || wn == 4 || wn == 8 || wn == 16))
    return (int)cudaErrorInvalidValue;
  irb::Geom g;
  g.x = static_cast<const __nv_bfloat16*>(x);
  g.we = static_cast<const __nv_bfloat16*>(we);
  g.be = static_cast<const float*>(be);
  g.kd = static_cast<const float*>(kd);
  g.bd = static_cast<const float*>(bd);
  g.wp = static_cast<const __nv_bfloat16*>(wp);
  g.bp = static_cast<const float*>(bp);
  g.y = static_cast<__nv_bfloat16*>(y);
  g.n = n; g.h = h; g.w = w; g.cin = cin; g.ce = ce; g.cout = cout;
  g.ho = (h - 1) / stride + 1;
  g.wo = (w - 1) / stride + 1;
  g.stride = stride; g.dil = dil; g.expand = expand; g.res = res;
  g.th = th; g.tw = tw; g.ch = ch; g.wn = wn; g.resident = resident ? 1 : 0;
  g.tiles_w = (g.wo + tw - 1) / tw;
  g.tiles_img = ((g.ho + th - 1) / th) * g.tiles_w;
  g.ntiles = n * g.tiles_img;
  g.grid = grid;
  if (grid < 1 || grid > g.ntiles) return (int)cudaErrorInvalidValue;
  const irb::Lay L = irb::layout(g);
  if (smem != L.total || smem > irb::kSmemMax || L.mper > irb::kMaxM || L.nper > irb::kMaxN)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stride == 2) return dil == 1 ? irb::launch<2, 1>(g, smem, s) : (int)cudaErrorInvalidValue;
  if (dil == 1) return irb::launch<1, 1>(g, smem, s);
  if (dil == 2) return irb::launch<1, 2>(g, smem, s);
  if (dil == 4) return irb::launch<1, 4>(g, smem, s);
  return irb::launch<1, 0>(g, smem, s);
}

const char* kdcc_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"

// The decoder's bilinear upsample and the depthwise conv, forward and backward.
//
// Replaces the Pallas kernels of kd_cheap_conv_tpu/ops/pallas/:
//   _k_up_fwd (upsample.py:85, pallas_call :143)           -> up_fwd_kernel<T>
//   _k_up_bwd (upsample.py:99, pallas_call :186)           -> up_bwd_kernel<T>
//   _k_dw_fwd, _k_dw_dx (dwconv.py:79, :89; :164, :246),
//   _k_conv (dwhwnc.py:119; :174)                          -> dw_conv_kernel<T, K>
//   _k_dw_dk (dwconv.py:98; :185), _k_dk (dwhwnc.py:124; :217) -> dkw::dw_dk_kernel<T, K, CPT>
// (dwconv.py and dwhwnc.py are one computation in two TPU layouts; both read
// NHWC here.)
//
// What they compute (activations NHWC, unpadded):
// - up_fwd: the half-pixel bilinear upsample (align_corners=False) from the
//   host tables of ops/upsample.py: per output row two (input row, f32
//   weight) taps, per output column two (input column, weight rounded to
//   the activation dtype) taps; where both taps of an axis clip onto one
//   index the table holds the summed weight and a zero. The rounding points
//   are the JAX kernel's: z = w0 x[r0] + w1 x[r1] in f32, rounded to the
//   activation dtype; y = m0 z[c0] + m1 z[c1] in f32, rounded once.
// - up_bwd: the transposed interpolation in gather form (no atomics): each
//   input pixel sums its own output taps from the per-input lists (output
//   index, weight; -1 ends a list): u = sum m g over the column list in f32,
//   not rounded; gx = sum w u over the row list in f32, rounded once.
// - dw_conv: the depthwise K x K conv, stride 1, dilation d, pad d (K - 1) / 2,
//   taps (K*K, C) f32; out-of-image taps are skipped (they read zero in the
//   JAX kernels, which pad the input). With flip set, tap t reads taps row
//   K*K - 1 - t: the input gradient. Inputs and taps widened to f32, the
//   taps summed in the JAX kernel's order (row-major), rounded once.
// - dw_dk: dk[t][c] = sum over pixels of x[tap t] * g in f32, one launch
//   (namespace dkw below), the sums across CTAs taken in the kernel.
// The upsample and conv products and sums are separate roundings (no FMA
// contraction), as the plain versions' torch ops round them, so the kernels
// give the plain versions' values bit for bit.
//
// Determinism: no float atomics. A dk sum has one owner at every level (a
// thread's registers, a fixed butterfly across the pixel lanes of a warp, the
// warps in order, the CTAs of a channel block in order after integer
// tickets); the work list and the grid depend on the shape only.
//
// What bounds them on an H100: about nine multiply-adds per element moved,
// far below the card's FLOP/byte balance, so all four are bound by HBM bytes:
// the design reads each input through 16-byte channel-group loads with
// neighbouring threads on neighbouring channel groups, keeps the taps and the
// sums in registers, and writes each output once (the upsample's 16x larger
// output dominates its traffic). In up_fwd, up_bwd and dw_conv the re-reads
// of the halo and of the upsample's 2x2 neighbourhood come from L1/L2 (no
// shared-memory staging, no pipelining); dw_dk stages its rows in shared
// memory by TMA, double-buffered, so HBM reads g once and x once plus a
// halo of K/2 rows a band (which L2 mostly serves: a CTA's next band
// follows).
//
// The C entry points launch on the caller's stream and return
// cudaGetLastError(); the Python wrapper raises if it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStrip = 4;       // dw_conv: output columns per thread

__device__ __forceinline__ float mul_add(float acc, float a, float b) {
  return __fadd_rn(acc, __fmul_rn(a, b));
}

// ---------------------------------------------------------------------------
// up_fwd: one thread per (output pixel, 8-channel group)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
up_fwd_kernel(const T* __restrict__ x, const int* __restrict__ rows,
              const float* __restrict__ rw, const int* __restrict__ cols,
              const float* __restrict__ cw, T* __restrict__ y, int n, int hi, int wi, int ho,
              int wo, int c) {
  const int groups = c / 8;
  const long long total = (long long)n * ho * wo * groups;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const int g = (int)(i % groups);
  const long long pix = i / groups;
  const int ox = (int)(pix % wo), oy = (int)((pix / wo) % ho), img = (int)(pix / ((long long)wo * ho));
  const int r0 = rows[2 * oy], r1 = rows[2 * oy + 1], c0 = cols[2 * ox], c1 = cols[2 * ox + 1];
  const float a0 = rw[2 * oy], a1 = rw[2 * oy + 1], b0 = cw[2 * ox], b1 = cw[2 * ox + 1];
  const T* base = x + (size_t)img * hi * wi * c + 8 * g;
  float x00[8], x10[8], x01[8], x11[8], out[8];
  load8<T>(base + ((size_t)r0 * wi + c0) * c, x00);
  load8<T>(base + ((size_t)r1 * wi + c0) * c, x10);
  load8<T>(base + ((size_t)r0 * wi + c1) * c, x01);
  load8<T>(base + ((size_t)r1 * wi + c1) * c, x11);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float z0 = rounded<T>(__fadd_rn(__fmul_rn(a0, x00[e]), __fmul_rn(a1, x10[e])));
    const float z1 = rounded<T>(__fadd_rn(__fmul_rn(a0, x01[e]), __fmul_rn(a1, x11[e])));
    out[e] = __fadd_rn(__fmul_rn(b0, z0), __fmul_rn(b1, z1));
  }
  store8<T>(y + (size_t)pix * c + 8 * g, out);
}

// ---------------------------------------------------------------------------
// up_bwd: one thread per (input pixel, 8-channel group), gathering its output
// taps: rlist/rlw (hi, lr) over output rows, clist/clw (wi, lc) over columns
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
up_bwd_kernel(const T* __restrict__ g, const int* __restrict__ rlist,
              const float* __restrict__ rlw, int lr, const int* __restrict__ clist,
              const float* __restrict__ clw, int lc, T* __restrict__ gx, int n, int hi, int wi,
              int ho, int wo, int c) {
  const int groups = c / 8;
  const long long total = (long long)n * hi * wi * groups;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const int cg = (int)(i % groups);
  const long long pix = i / groups;
  const int ix = (int)(pix % wi), iy = (int)((pix / wi) % hi), img = (int)(pix / ((long long)wi * hi));
  const T* base = g + (size_t)img * ho * wo * c + 8 * cg;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int j = 0; j < lr; ++j) {
    const int ro = rlist[iy * lr + j];
    if (ro < 0) break;
    const float wr = rlw[iy * lr + j];
    float u[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int q = 0; q < lc; ++q) {
      const int co = clist[ix * lc + q];
      if (co < 0) break;
      const float m = clw[ix * lc + q];
      float gv[8];
      load8<T>(base + ((size_t)ro * wo + co) * c, gv);
#pragma unroll
      for (int e = 0; e < 8; ++e) u[e] = mul_add(u[e], m, gv[e]);
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = mul_add(acc[e], wr, u[e]);
  }
  store8<T>(gx + (size_t)pix * c + 8 * cg, acc);
}

// ---------------------------------------------------------------------------
// dw_conv: one thread per (row strip of kStrip output pixels, 8-channel group);
// each tap's eight weights are loaded once for the strip
// ---------------------------------------------------------------------------

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
dw_conv_kernel(const T* __restrict__ x, const float* __restrict__ taps, T* __restrict__ y,
               int n, int h, int w, int c, int dil, int flip) {
  const int groups = c / 8, strips = (w + kStrip - 1) / kStrip;
  const long long total = (long long)n * h * strips * groups;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const int cg = (int)(i % groups);
  const long long rest = i / groups;
  const int sx = (int)(rest % strips), oy = (int)((rest / strips) % h);
  const int img = (int)(rest / ((long long)strips * h)), ox0 = sx * kStrip;
  const T* base = x + (size_t)img * h * w * c + 8 * cg;
  float acc[kStrip][8];
#pragma unroll
  for (int s = 0; s < kStrip; ++s)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[s][e] = 0.f;
#pragma unroll
  for (int ti = 0; ti < K; ++ti) {
    const int yy = oy + (ti - K / 2) * dil;
    if (yy < 0 || yy >= h) continue;
#pragma unroll
    for (int tj = 0; tj < K; ++tj) {
      const int t = flip ? K * K - 1 - (ti * K + tj) : ti * K + tj;
      float kv[8];
      load8<float>(taps + (size_t)t * c + 8 * cg, kv);
#pragma unroll
      for (int s = 0; s < kStrip; ++s) {
        const int xx = ox0 + s + (tj - K / 2) * dil;
        if (ox0 + s >= w || xx < 0 || xx >= w) continue;
        float xv[8];
        load8<T>(base + ((size_t)yy * w + xx) * c, xv);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[s][e] = mul_add(acc[s][e], xv[e], kv[e]);
      }
    }
  }
#pragma unroll
  for (int s = 0; s < kStrip; ++s)
    if (ox0 + s < w) store8<T>(y + (((size_t)img * h + oy) * w + ox0 + s) * c + 8 * cg, acc[s]);
}

// ---------------------------------------------------------------------------
// dw_dk (namespace dkw): one launch on one wave of persistent CTAs, one a
// CTA an SM.
//
// Rows in class order: with dilation d, image row y = r + j d belongs to
// class r = y mod d, and a tap row ti pairs g row y only with x row
// y + (ti - K/2) d, the same class. Laid out as the sequence of classes
// (class 0's rows, then class 1's, ...), the vertical taps of any dilation
// reach K/2 sequence rows either side (a row mask drops the pairs that
// would cross into another class or leave the image).
//
// The work list is fixed by the shape alone (`plan`): items (channel block
// of cb channels, image, band of `rows` sequence rows), block-major, one
// contiguous run of items a CTA. cb spans 128 bytes a pixel where C allows
// (whole 128-byte lines: copies of 32 bytes a line, as narrower blocks make,
// held each SM far below its share of HBM). A
// producer warp stages an item's g rows and x rows (a halo of K/2 rows) in
// shared memory, a TMA box a row on the stage's mbarrier, the next item's
// while 16 consumer warps sum this one (two stages). A consumer thread owns
// cpt channels of the block; the block's pixels, flattened column-major,
// are cut into one run a pixel lane. For K = 3 a lane walks down each column
// of its run with a sliding window: the x values of tap rows r - 1, r, r + 1
// at columns c - d, c, c + d stay in registers, so a pixel costs one new x
// row (three loads) and its g; all 9 taps of its channels sum in registers,
// through all the items of the run that share a block (K = 5, 7: a plain
// loop over each pixel's taps, two channels a thread). When the block
// changes or the run ends the CTA flushes: a fixed butterfly across the
// pixel lanes of a warp, the warps in order through shared memory, the
// CTA's partial into a scratch slot; the CTAs that share a block take
// integer tickets, and the last adds the slots in CTA order and writes dk
// for the block. One level of tickets: a block has at most
// ceil(grid / blocks) + 1 contributing CTAs, a handful.
// ---------------------------------------------------------------------------

namespace dkw {

constexpr int kConsumers = 512;          // 16 warps sum; the 17th issues the stages' TMA copies
constexpr int kThreads = kConsumers + 32;
constexpr int kCtas = 132;               // the wave: one CTA an SM of an H100
constexpr int kStage = 108 * 1024;       // bytes a stage: x rows with halo, then g rows
constexpr int kMaxRows = 64;             // sequence rows a band at most
constexpr int kMaxFlush = 16;            // blocks a CTA flushes before it settles their tickets
constexpr int kSmem = 2 * kStage + 2 * kMaxRows * 4 + 2 * 8 + 2 * kMaxFlush * 4 + 128;

struct Plan {
  int cpt, cb, u, pl;          // channels a thread, a block; threads across a block; pixel lanes
  int nbox, bw, wp;            // TMA boxes a row, pixels a box; a staged row: whole boxes, 128-byte aligned
  int hk, bands, rows;         // halo (sequence rows), bands an image, sequence rows a band
  int nb, ncb, items, grid, mc;  // items a block, blocks, items, CTAs, scratch slots a block
  long long scratch;           // floats: ncb x mc x K^2 x cb
};

// mirrored by ops/dwconv.py `dw_dk_plan`: the widest block (128, 64, 32 or
// 16 bytes a pixel) dividing C whose flush and a one-row band fit a stage;
// a row as ceil(w / 256) boxes of equal width (a multiple of 8 pixels when
// there are several); of the band counts whose window fits a
// stage, the one with the least ceil(items / grid) x (x rows + g rows + 2)
__host__ __device__ inline Plan plan(int n, int h, int w, int c, int k, int esize) {
  Plan p{};
  p.cpt = k == 3 ? 4 : 2;
  p.hk = k / 2;
  p.nbox = (w + 255) / 256;
  p.bw = p.nbox == 1 ? w : ((w + p.nbox - 1) / p.nbox + 7) / 8 * 8;   // boxes start 128-byte aligned
  long long best = -1;
  for (int bytes = 128; bytes >= 16 && best < 0; bytes /= 2) {
    const int cb = bytes / esize;
    // the flush's [warp][K^2][cb] fits a stage
    if (c % cb || kConsumers / 32 * k * k * cb * 4 > kStage) continue;
    const int wp = (p.nbox * p.bw * bytes + 127) / 128 * 128 / bytes;
    const long long row = (long long)wp * bytes;
    for (int b = 1; b <= h; ++b) {
      const int rows = (h + b - 1) / b;
      const int xr = h < rows + 2 * p.hk ? h : rows + 2 * p.hk;
      if (rows > kMaxRows || (xr + rows) * row > kStage) continue;
      const long long items = (long long)n * b * (c / cb);
      const long long grid = items < kCtas ? items : kCtas;
      const long long cost = (items + grid - 1) / grid * (xr + rows + 2);
      if (best < 0 || cost < best) best = cost, p.bands = b, p.cb = cb, p.wp = wp;
    }
  }
  if (best < 0) return p;      // items 0: refused
  p.u = p.cb / p.cpt;
  p.pl = kConsumers / p.u;
  p.ncb = c / p.cb;
  p.rows = (h + p.bands - 1) / p.bands;
  p.nb = n * p.bands;
  p.items = p.nb * p.ncb;
  p.grid = p.items < kCtas ? p.items : kCtas;
  const int most = (p.grid + p.ncb - 1) / p.ncb + 1;
  p.mc = most < p.nb ? most : p.nb;
  p.scratch = (long long)p.ncb * p.mc * k * k * p.cb;
  return p;
}

// the CTA whose run holds item i: runs are [j I / G, (j + 1) I / G)
__device__ __forceinline__ int owner(long long i, const Plan& p) {
  return (int)(((i + 1) * p.grid - 1) / p.items);
}

// image row of sequence row s (classes of rows mod d, in class order)
__device__ __forceinline__ int seq_row(int s, int h, int d) {
  const int q = h / d, rem = h - q * d, big = rem * (q + 1);
  if (s < big) {
    const int r = s / (q + 1);
    return r + (s - r * (q + 1)) * d;
  }
  const int t = s - big, r = rem + t / q;
  return r + (t - (r - rem) * q) * d;
}

struct Item {
  int blk, img, s0, s1, xs0, xs1;
};
__device__ __forceinline__ Item item_at(int i, const Plan& p, int h) {
  Item it;
  it.blk = i / p.nb;
  const int rest = i - it.blk * p.nb;
  it.img = rest / p.bands;
  it.s0 = (rest - it.img * p.bands) * p.rows;
  it.s1 = min(h, it.s0 + p.rows);
  it.xs0 = max(0, it.s0 - p.hk);
  it.xs1 = min(h, it.s1 + p.hk);
  return it;
}

// cpt channels as f32: four (8 or 16 bytes) or two (4 or 8 bytes)
template <typename T, int CPT> __device__ __forceinline__ void loadc(const T* q, float* v);
template <> __device__ __forceinline__ void loadc<float, 4>(const float* q, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(q);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
}
template <> __device__ __forceinline__ void loadc<__nv_bfloat16, 4>(const __nv_bfloat16* q,
                                                                    float* v) {
  const uint2 a = *reinterpret_cast<const uint2*>(q);
  v[0] = __uint_as_float(a.x << 16), v[1] = __uint_as_float(a.x & 0xffff0000u);
  v[2] = __uint_as_float(a.y << 16), v[3] = __uint_as_float(a.y & 0xffff0000u);
}
template <typename T, int CPT> __device__ __forceinline__ void loadc(const T* q, float* v) {
  static_assert(CPT == 2, "two channels a thread for K = 5, 7");
  const float2 a = load2<T>(q);
  v[0] = a.x, v[1] = a.y;
}

// the item's x rows [xs0, xs1) then g rows [s0, s1), each row wp pixels of
// cb channels (w and a 128-byte aligned end), by TMA boxes of bw pixels (one
// a row unless w > 256) on the stage's mbarrier, a lane a row of the
// producer warp; and the g rows' tap masks (bit ti: the x row of tap row ti
// is in the image), which the consumers read after the next CTA barrier.
// `fence`: the stage was last written by generic stores (a flush)
__device__ __forceinline__ void issue(const CUtensorMap* mx, const CUtensorMap* mg, char* stage,
                                      int* mask, uint64_t* bar, const Item& it, const Plan& p,
                                      int h, int esize, int dil, bool fence) {
  const int lane = threadIdx.x & 31;
  const int nx = it.xs1 - it.xs0, rows = nx + it.s1 - it.s0, nbox = p.nbox;
  const int box_bytes = p.bw * p.cb * esize, row_bytes = p.wp * p.cb * esize;
  if (lane == 0) hop::mbar_expect_tx(bar, (uint32_t)(rows * nbox * box_bytes));
  __syncwarp();
  if (fence) hop::fence_proxy_async();
  for (int rr = lane; rr < rows; rr += 32) {
    const bool isg = rr >= nx;
    const int y = seq_row(isg ? it.s0 + rr - nx : it.xs0 + rr, h, dil);
    for (int b = 0; b < nbox; ++b)
      hop::tma_load_3d(stage + rr * row_bytes + b * box_bytes, isg ? mg : mx, it.blk * p.cb,
                       b * p.bw, it.img * h + y, bar);
    if (isg) {
      int m = 0;
      for (int ti = 0; ti < 2 * p.hk + 1; ++ti) {
        const int yy = y + (ti - p.hk) * dil;
        m |= (yy >= 0 && yy < h) << ti;
      }
      mask[rr - nx] = m;
    }
  }
}

// K = 3: one column segment [r0, r1) of g rows at column col (item-local
// rows), a window of three x rows (tap rows 0, 1, 2) x three columns that
// slides down one row a step. A tap row outside the stage (outside the
// image) and a tap column outside the image read zeros; with MASK (a
// dilation above 1) a tap row in another class is dropped by the g row's
// mask
template <typename T>
struct Col3 {
  const T* xs;          // the stage's x rows, this thread's channels
  const T* gs;          // its g rows
  const int* mk;
  const T* zu;          // zeros for this thread's channels
  int nx, x_off, row_elems, cb;

  __device__ __forceinline__ void load_row(float (&wr)[3][4], const T* row, int xr, int om,
                                           int oc, int op, bool vm, bool vp) const {
    const bool rv = (unsigned)xr < (unsigned)nx;
    loadc<T, 4>(rv && vm ? row + om : zu, wr[0]);
    loadc<T, 4>(rv ? row + oc : zu, wr[1]);
    loadc<T, 4>(rv && vp ? row + op : zu, wr[2]);
  }
  template <bool MASK>
  __device__ __forceinline__ void step(float (&acc)[9][4], const float (&wa)[3][4],
                                       const float (&wb)[3][4], const float (&wc)[3][4],
                                       const T* gp, const int* mp) const {
    float gv[4], g0[4], g2[4];
    loadc<T, 4>(gp, gv);
    if constexpr (MASK) {
      const int m = *mp;
#pragma unroll
      for (int e = 0; e < 4; ++e) g0[e] = (m & 1) ? gv[e] : 0.f, g2[e] = (m & 4) ? gv[e] : 0.f;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) g0[e] = g2[e] = gv[e];
    }
#pragma unroll
    for (int tj = 0; tj < 3; ++tj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[tj][e] = fmaf(wa[tj][e], g0[e], acc[tj][e]);
        acc[3 + tj][e] = fmaf(wb[tj][e], gv[e], acc[3 + tj][e]);
        acc[6 + tj][e] = fmaf(wc[tj][e], g2[e], acc[6 + tj][e]);
      }
  }
  template <bool MASK>
  __device__ __forceinline__ void segment(float (&acc)[9][4], int col, int r0, int r1, int wp,
                                          int dil, int w) const {
    const int om = (col - dil) * cb, oc = col * cb, op = (col + dil) * cb;
    const bool vm = col >= dil, vp = col + dil < w;
    int xr = r0 + x_off;                        // the x row of tap row 0
    const T* row = xs + xr * row_elems;
    const T* gp = gs + (r0 * wp + col) * cb;
    const int* mp = mk + r0;
    float wa[3][4], wb[3][4], wc[3][4];
    load_row(wa, row, xr, om, oc, op, vm, vp);
    load_row(wb, row + row_elems, xr + 1, om, oc, op, vm, vp);
    int r = r0;
    for (; r + 3 <= r1; r += 3) {
      load_row(wc, row + 2 * row_elems, xr + 2, om, oc, op, vm, vp);
      step<MASK>(acc, wa, wb, wc, gp, mp);
      load_row(wa, row + 3 * row_elems, xr + 3, om, oc, op, vm, vp);
      step<MASK>(acc, wb, wc, wa, gp + row_elems, mp + 1);
      load_row(wb, row + 4 * row_elems, xr + 4, om, oc, op, vm, vp);
      step<MASK>(acc, wc, wa, wb, gp + 2 * row_elems, mp + 2);
      row += 3 * row_elems, xr += 3, gp += 3 * row_elems, mp += 3;
    }
    if (r < r1) {
      load_row(wc, row + 2 * row_elems, xr + 2, om, oc, op, vm, vp);
      step<MASK>(acc, wa, wb, wc, gp, mp);
      if (r + 1 < r1) {
        load_row(wa, row + 3 * row_elems, xr + 3, om, oc, op, vm, vp);
        step<MASK>(acc, wb, wc, wa, gp + row_elems, mp + 1);
      }
    }
  }
};

// the tickets of the blocks this CTA flushed (its slots written): one fence,
// a ticket a block, and for each block whose last slot this CTA wrote, the
// slots' sum in CTA order into dk; resets nf
__device__ __forceinline__ void settle(int& nf, const int* flushed, int* last_of, float* dk,
                                       const float* scratch, int* tickets, const Plan& p, int c,
                                       int taps) {
  const int tid = threadIdx.x;
  __threadfence();
  __syncthreads();
  if (tid < nf) {
    const int blk = flushed[tid];
    const int nc = owner((long long)(blk + 1) * p.nb - 1, p) - owner((long long)blk * p.nb, p) + 1;
    last_of[tid] = atomicAdd(&tickets[blk], 1) == nc - 1;
  }
  __syncthreads();
  const int nv = taps * p.cb;
  for (int f = 0; f < nf; ++f) {
    if (!last_of[f]) continue;
    const int blk = flushed[f];
    const int nc = owner((long long)(blk + 1) * p.nb - 1, p) - owner((long long)blk * p.nb, p) + 1;
    const float* slots = scratch + (long long)blk * p.mc * nv;
    __threadfence();
    for (int v = tid; v < nv; v += kThreads) {
      float s = 0.f;
      for (int s0 = 0; s0 < nc; s0 += 8) {
        float vals[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) vals[q] = s0 + q < nc ? __ldcg(slots + (s0 + q) * nv + v) : 0.f;
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if (s0 + q < nc) s += vals[q];
      }
      const int t = v / p.cb;
      dk[(long long)t * c + blk * p.cb + (v - t * p.cb)] = s;
    }
    if (tid == 0) tickets[blk] = 0;
  }
  __syncthreads();
  nf = 0;
}

template <typename T, int K, int CPT>
__global__ void __launch_bounds__(kThreads, 1)
dw_dk_kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mg,
             float* __restrict__ dk, float* __restrict__ scratch, int* __restrict__ tickets,
             Plan p, int h, int w, int c, int dil) {
  extern __shared__ __align__(128) char sm[];
  const T* zeros = reinterpret_cast<const T*>(sm + 2 * kStage);         // 128 bytes
  int* masks = reinterpret_cast<int*>(sm + 2 * kStage + 128);         // [2][kMaxRows]
  uint64_t* bars = reinterpret_cast<uint64_t*>(masks + 2 * kMaxRows);   // [2]
  int* flushed = reinterpret_cast<int*>(bars + 2);                     // [kMaxFlush] blocks
  int* last_of = flushed + kMaxFlush;                                  // [kMaxFlush] flags
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int u = tid % p.u, pl = tid / p.u;
  const int i0 = (int)((long long)blockIdx.x * p.items / p.grid);
  const int i1 = (int)((long long)(blockIdx.x + 1) * p.items / p.grid);
  const int row_elems = p.wp * p.cb;
  float acc[K * K][CPT];
#pragma unroll
  for (int t = 0; t < K * K; ++t)
#pragma unroll
    for (int e = 0; e < CPT; ++e) acc[t][e] = 0.f;
  if (tid < 32) reinterpret_cast<float*>(sm + 2 * kStage)[tid] = 0.f;
  if (tid == 0) {
    hop::mbar_init(&bars[0], 1);
    hop::mbar_init(&bars[1], 1);
    hop::mbar_init_fence();
  }
  __syncthreads();
  const bool producer = warp == kConsumers / 32;
  if (producer) {
    hop::tma_prefetch_map(&mx);
    hop::tma_prefetch_map(&mg);
    issue(&mx, &mg, sm, masks, &bars[0], item_at(i0, p, h), p, h, (int)sizeof(T), dil, false);
  }
  __syncthreads();                    // the first item's masks
  int st = 0, nflushed = 0;
  bool flushed_last = false;          // the previous item's stage holds a flush's generic writes
  for (int i = i0; i < i1; ++i, st ^= 1) {
    const Item it = item_at(i, p, h);
    if (producer) {
      // the next item's rows, while the consumers sum this one
      if (i + 1 < i1)
        issue(&mx, &mg, sm + (st ^ 1) * kStage, masks + (st ^ 1) * kMaxRows, &bars[st ^ 1],
              item_at(i + 1, p, h), p, h, (int)sizeof(T), dil, flushed_last);
    } else {
      hop::mbar_wait(&bars[st], ((i - i0) >> 1) & 1);   // item i's rows are in
      const T* xs = reinterpret_cast<const T*>(sm + st * kStage) + u * CPT;
      const int nx = it.xs1 - it.xs0, ng = it.s1 - it.s0;
      const T* gs = xs + nx * row_elems;
      const int* mk = masks + st * kMaxRows;
      const int x_off = it.s0 - it.xs0 - p.hk;
      if constexpr (K == 3) {
        // this lane's run of the column-major pixels, column by column
        const Col3<T> cl{xs, gs, mk, zeros + u * CPT, nx, x_off, row_elems, p.cb};
        const int npx = ng * w;
        const int q0 = pl * npx / p.pl, q1 = (pl + 1) * npx / p.pl;
        for (int q = q0; q < q1;) {
          const int col = q / ng, r0 = q - col * ng, r1 = min(ng, r0 + q1 - q);
          if (dil == 1)   // no class boundaries: the stage's ends are the image's
            cl.template segment<false>(acc, col, r0, r1, p.wp, dil, w);
          else
            cl.template segment<true>(acc, col, r0, r1, p.wp, dil, w);
          q += r1 - r0;
        }
      } else {
        for (int px = pl; px < ng * w; px += p.pl) {
          const int r = px / w, xx = px - r * w, m = mk[r];
          float gv[CPT];
          loadc<T, CPT>(gs + (r * p.wp + xx) * p.cb, gv);
  #pragma unroll
          for (int ti = 0; ti < K; ++ti) {
            if (!((m >> ti) & 1)) continue;
            const T* xrow = xs + (r + x_off + ti) * row_elems;
  #pragma unroll
            for (int tj = 0; tj < K; ++tj) {
              const int xc = xx + (tj - K / 2) * dil;
              if ((unsigned)xc >= (unsigned)w) continue;
              float xv[CPT];
              loadc<T, CPT>(xrow + xc * p.cb, xv);
  #pragma unroll
              for (int e = 0; e < CPT; ++e)
                acc[ti * K + tj][e] = fmaf(xv[e], gv[e], acc[ti * K + tj][e]);
            }
          }
        }
      }
    }
    const bool last = i + 1 == i1 || (i + 1) / p.nb != it.blk;
    flushed_last = last;
    if (last) {
      // flush: the pixel lanes of each warp (a fixed butterfly), then the
      // warps in order, into this CTA's slot of the block
      for (int off = 16; off >= p.u; off >>= 1)   // a level at a time: the shuffles pipeline
#pragma unroll
        for (int t = 0; t < K * K; ++t)
#pragma unroll
          for (int e = 0; e < CPT; ++e) acc[t][e] += __shfl_xor_sync(0xffffffffu, acc[t][e], off);
      const int nv = K * K * p.cb;
      float* red = reinterpret_cast<float*>(sm + st * kStage);   // [warp][K * K][cb]
      __syncthreads();                // every thread is done with the stage
      if (!producer && lane < p.u) {
#pragma unroll
        for (int t = 0; t < K * K; ++t)
#pragma unroll
          for (int e = 0; e < CPT; ++e) red[(warp * K * K + t) * p.cb + u * CPT + e] = acc[t][e];
      }
      __syncthreads();
      const int j0 = owner((long long)it.blk * p.nb, p);
      float* slot = scratch + ((long long)it.blk * p.mc + blockIdx.x - j0) * nv;
      for (int v = tid; v < nv; v += kThreads) {
        float s = red[v];
#pragma unroll
        for (int wp = 1; wp < kConsumers / 32; ++wp) s += red[wp * nv + v];
        __stcg(slot + v, s);
      }
      if (tid == 0) flushed[nflushed] = it.blk;
      if (++nflushed == kMaxFlush) settle(nflushed, flushed, last_of, dk, scratch, tickets, p, c,
                                          K * K);
#pragma unroll
      for (int t = 0; t < K * K; ++t)
#pragma unroll
        for (int e = 0; e < CPT; ++e) acc[t][e] = 0.f;
    }
    __syncthreads();                  // the stage is free for item i + 2
  }
  settle(nflushed, flushed, last_of, dk, scratch, tickets, p, c, K * K);
}

}  // namespace dkw

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

int blocks(long long threads) { return (int)((threads + kThreads - 1) / kThreads); }

template <typename T>
cudaError_t run_up_fwd(const void* x, const void* rows, const void* rw, const void* cols,
                       const void* cw, void* y, int n, int hi, int wi, int ho, int wo, int c,
                       cudaStream_t st) {
  up_fwd_kernel<T><<<blocks((long long)n * ho * wo * (c / 8)), kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const int*>(rows), static_cast<const float*>(rw),
      static_cast<const int*>(cols), static_cast<const float*>(cw), static_cast<T*>(y), n, hi,
      wi, ho, wo, c);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_up_bwd(const void* g, const void* rlist, const void* rlw, int lr,
                       const void* clist, const void* clw, int lc, void* gx, int n, int hi,
                       int wi, int ho, int wo, int c, cudaStream_t st) {
  up_bwd_kernel<T><<<blocks((long long)n * hi * wi * (c / 8)), kThreads, 0, st>>>(
      static_cast<const T*>(g), static_cast<const int*>(rlist), static_cast<const float*>(rlw),
      lr, static_cast<const int*>(clist), static_cast<const float*>(clw), lc,
      static_cast<T*>(gx), n, hi, wi, ho, wo, c);
  return cudaGetLastError();
}

template <typename T, int K>
cudaError_t run_dw_conv(const void* x, const void* taps, void* y, int n, int h, int w, int c,
                        int dil, int flip, cudaStream_t st) {
  const long long threads = (long long)n * h * ((w + kStrip - 1) / kStrip) * (c / 8);
  dw_conv_kernel<T, K><<<blocks(threads), kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(taps), static_cast<T*>(y), n, h, w,
      c, dil, flip);
  return cudaGetLastError();
}

// the 3-D map (c, w, n h) of x or g read in boxes of (cb, bw, 1), encoded once
// per (address, shape): the caching allocator hands the step's tensors the
// same addresses step after step, and encoding two maps a launch would be
// host time
inline bool dk_map(CUtensorMap* map, const void* base, int esize, int n, int h, int w, int c,
                   const dkw::Plan& p) {
  constexpr int kEntries = 64;
  struct Entry {
    const void* base;
    int esize, n, h, w, c, cb;
    CUtensorMap map;
  };
  static Entry table[kEntries];
  static int used = 0, next = 0;
  for (int i = 0; i < used; ++i) {
    const Entry& e = table[i];
    if (e.base == base && e.esize == esize && e.n == n && e.h == h && e.w == w && e.c == c &&
        e.cb == p.cb) {
      *map = e.map;
      return true;
    }
  }
  hop::EncodeTiledFn fn = hop::encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)c, (cuuint64_t)w, (cuuint64_t)n * h};
  const cuuint64_t strides[2] = {(cuuint64_t)c * esize, (cuuint64_t)w * c * esize};
  const cuuint32_t box[3] = {(cuuint32_t)p.cb, (cuuint32_t)p.bw, 1}, estr[3] = {1, 1, 1};
  if (fn(map, esize == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
         const_cast<void*>(base), dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  table[next] = Entry{base, esize, n, h, w, c, p.cb, *map};
  next = (next + 1) % kEntries;
  if (used < kEntries) ++used;
  return true;
}

template <typename T, int K>
cudaError_t run_dw_dk(const void* x, const void* g, void* dk, void* scratch, void* tickets,
                      const dkw::Plan& p, int n, int h, int w, int c, int dil, cudaStream_t st) {
  constexpr int CPT = K == 3 ? 4 : 2;
  CUtensorMap mx, mg;
  if (p.cpt != CPT || ctas_per_sm<dkw::dw_dk_kernel<T, K, CPT>>(dkw::kThreads, dkw::kSmem) < 1 ||
      !dk_map(&mx, x, (int)sizeof(T), n, h, w, c, p) ||
      !dk_map(&mg, g, (int)sizeof(T), n, h, w, c, p))
    return cudaErrorInvalidValue;
  dkw::dw_dk_kernel<T, K, CPT><<<p.grid, dkw::kThreads, dkw::kSmem, st>>>(
      mx, mg, static_cast<float*>(dk), static_cast<float*>(scratch), static_cast<int*>(tickets),
      p, h, w, c, dil);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dw_conv_k(int k, const void* x, const void* taps, void* y, int n, int h, int w,
                      int c, int dil, int flip, cudaStream_t st) {
  switch (k) {
    case 3: return run_dw_conv<T, 3>(x, taps, y, n, h, w, c, dil, flip, st);
    case 5: return run_dw_conv<T, 5>(x, taps, y, n, h, w, c, dil, flip, st);
    case 7: return run_dw_conv<T, 7>(x, taps, y, n, h, w, c, dil, flip, st);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dw_dk_k(int k, const void* x, const void* g, void* dk, void* scratch, void* tickets,
                    const dkw::Plan& p, int n, int h, int w, int c, int dil, cudaStream_t st) {
  switch (k) {
    case 3: return run_dw_dk<T, 3>(x, g, dk, scratch, tickets, p, n, h, w, c, dil, st);
    case 5: return run_dw_dk<T, 5>(x, g, dk, scratch, tickets, p, n, h, w, c, dil, st);
    case 7: return run_dw_dk<T, 7>(x, g, dk, scratch, tickets, p, n, h, w, c, dil, st);
  }
  return cudaErrorInvalidValue;
}

bool shape_ok(int n, int h, int w, int c) {
  return n >= 1 && h >= 1 && w >= 1 && c >= 8 && c % 8 == 0;
}

}  // namespace

extern "C" {

// Upsample, forward. x (n, hi, wi, c), y (n, ho, wo, c) in dtype (0 float32,
// 1 bfloat16); rows (ho, 2), cols (wo, 2) int32; rw (ho, 2), cw (wo, 2) f32.
int kdcc_up_fwd(int dtype, const void* x, const void* rows, const void* rw, const void* cols,
                const void* cw, void* y, int n, int hi, int wi, int ho, int wo, int c,
                void* stream) {
  if (!shape_ok(n, hi, wi, c) || ho < hi || wo < wi) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)run_up_fwd<float>(x, rows, rw, cols, cw, y, n, hi, wi, ho, wo, c, st);
  if (dtype == 1)
    return (int)run_up_fwd<__nv_bfloat16>(x, rows, rw, cols, cw, y, n, hi, wi, ho, wo, c, st);
  return (int)cudaErrorInvalidValue;
}

// Upsample, backward. g (n, ho, wo, c), gx (n, hi, wi, c) in dtype; rlist
// (hi, lr), clist (wi, lc) int32 (-1 ends a list); rlw, clw f32 alike.
int kdcc_up_bwd(int dtype, const void* g, const void* rlist, const void* rlw, int lr,
                const void* clist, const void* clw, int lc, void* gx, int n, int hi, int wi,
                int ho, int wo, int c, void* stream) {
  if (!shape_ok(n, hi, wi, c) || ho < hi || wo < wi || lr < 1 || lc < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)run_up_bwd<float>(g, rlist, rlw, lr, clist, clw, lc, gx, n, hi, wi, ho, wo, c,
                                  st);
  if (dtype == 1)
    return (int)run_up_bwd<__nv_bfloat16>(g, rlist, rlw, lr, clist, clw, lc, gx, n, hi, wi, ho,
                                          wo, c, st);
  return (int)cudaErrorInvalidValue;
}

// Depthwise conv (flip 0) or its input gradient (flip 1). x, y (n, h, w, c) in
// dtype; taps (k * k, c) f32; k 3, 5 or 7.
int kdcc_dw_conv(int dtype, const void* x, const void* taps, void* y, int n, int h, int w,
                 int c, int k, int dil, int flip, void* stream) {
  if (!shape_ok(n, h, w, c) || dil < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dw_conv_k<float>(k, x, taps, y, n, h, w, c, dil, flip, st);
  if (dtype == 1)
    return (int)dw_conv_k<__nv_bfloat16>(k, x, taps, y, n, h, w, c, dil, flip, st);
  return (int)cudaErrorInvalidValue;
}

// Depthwise weight gradient, one launch. x, g (n, h, w, c) in dtype, 16-byte
// aligned; dk (k * k, c) f32, written whole; scratch (scratch_floats) f32
// and tickets (c / cb int32, zero, left zero) kept by the caller; grid and
// scratch_floats must be the plan's (ops/dwconv.py `dw_dk_plan`).
int kdcc_dw_dk(int dtype, const void* x, const void* g, void* dk, void* scratch, void* tickets,
               int n, int h, int w, int c, int k, int dil, int grid, long long scratch_floats,
               void* stream) {
  if (!shape_ok(n, h, w, c) || dil < 1 || (dtype != 0 && dtype != 1) ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(g) % 16)
    return (int)cudaErrorInvalidValue;
  const dkw::Plan p = dkw::plan(n, h, w, c, k, dtype == 0 ? 4 : 2);
  if (p.items < 1 || grid != p.grid || scratch_floats != p.scratch)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dw_dk_k<float>(k, x, g, dk, scratch, tickets, p, n, h, w, c, dil, st);
  return (int)dw_dk_k<__nv_bfloat16>(k, x, g, dk, scratch, tickets, p, n, h, w, c, dil, st);
}

}  // extern "C"

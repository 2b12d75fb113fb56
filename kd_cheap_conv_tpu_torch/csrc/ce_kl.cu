// Pixelwise CE + softened KL on full-resolution class-major logits, forward
// and backward (the cached-teacher step's loss).
//
// Replaces the Pallas kernels of kd_cheap_conv_tpu/ops/pallas/losses.py
// `fused_ce_kl_loss` (:150):
//   forward  _fwd_kernel (:33)  -> ffw::ce_kl_fwd_kernel: the three sums
//                                  (nll * valid, valid, kl), summed in the
//                                  kernel into (3,)
//   backward _bwd_kernel (:80)  -> fbw::ce_kl_bwd_kernel: ds in one pass
// The same loss as kernels C and D (ce_kl_upsampled.cu) without the
// upsample gather. Per pixel, in f32:
//   nll = lse(s) - s[label]           (a label outside [0, C): s[label] = 0)
//   t   = clip(t, +-clip) / T,  log_p_t = max(t - lse(t), -87)
//   kl  = sum_c exp(log_p_t) * (log_p_t - (s / T - lse(s / T)))
//   ds  = a * (softmax(s) - onehot) * valid + k * (softmax(s / T) - softmax(t))
// valid = label != ignore; CE sums valid pixels, KL every pixel. (a, k) are
// the grad scales the autograd backward folds from the three cotangents (the
// JAX package's _grad_scales), read from device memory: no host sync.
//
// Layouts: s (n, c, h, w) contiguous, f32 or bf16; ds the same. The teacher
// t is (n, c, h, w) by its strides: class-major, or the NHWC memory of the
// cache (class stride 1, pixel stride c), in f32, bf16 or f16 (the cache's
// own dtype: widening f16 to f32 is exact, so the kernel reads the stored
// values and the host never widens them). Labels int64 (n, h, w).
//
// What bounds both on an H100: bytes. At config #1's step (16 x 21 x 513²,
// s bf16, t f16 NHWC, int64 labels) the forward reads 177 + 177 + 34 MB
// (0.116 ms at 3.35 TB/s) and the backward writes ds's 177 MB more (0.168
// ms); the three exponentials a class and pixel take ~0.063 ms on the
// special-function units. In practice both are paced by their arithmetic
// as much as by their bytes (PERF.md), so the design keeps the copies off
// the threads' critical path and the per-pixel arithmetic short.
//
// Design (both kernels): one launch on one wave of persistent CTAs (one an
// SM, kCtas), each walking tiles of `tile` pixels inside one image, CTA b
// the tiles [b per, (b + 1) per): the split, and so the order of every sum,
// depends on the shape alone (`plan`; ops/losses_fused.py `full_plan`
// mirrors it, and the entry points refuse another grid or shared memory
// size). A ring of 2-4 slots holds ring - 1 tiles in flight while the
// threads read another from shared memory, a pixel at a time (1024-pixel
// tiles, two a thread: smaller tiles spent more on each tile's staging and
// barrier than they gained in depth, PERF.md). A slot holds
// the c class-plane spans of s, the teacher (one contiguous span of tile x
// c values in the NHWC form, or c plane spans) and the labels' span. The
// plane spans (2 KB at config #1) arrive by 16-byte cp.async from every
// warp (a warp a plane, a lane a chunk); the NHWC teacher's and the labels'
// span by one thread's two bulk copies (cp.async.bulk) on the slot's
// mbarrier.
// One thread issuing a bulk copy per plane was slower: at ~23 copies a
// tile their issue took as long as the tile's arithmetic, serialised with
// the issuing warp. One barrier a tile: after it, every thread's copies of
// tile k have landed and every thread is done with tile k - 1, whose slot
// then takes tile k + ring - 1.
//
// The alignment rule. At 513² hw is odd, so most spans start off 16 bytes:
// a class plane of bf16 s is 526,338 B (2 mod 16), an NHWC f16 image of the
// teacher 11,053,098 B (10 mod 16), an image's labels 2,105,352 B (8 mod
// 16). A 16-byte cp.async or a bulk copy needs 16-byte-aligned ends (and a
// TMA tensor map 16-byte strides), so each span is copied as its
// 16-byte-aligned superset (start rounded down, end rounded up; within the
// allocation's granule) and read at the element offset of its true start,
// which each thread recomputes from the address's low bits. A slot's region
// for a span is its bytes plus 16.
//
// Forward arithmetic (kernel C's): s read as s log2(e), t / T natural, 3
// ex2.approx a class and pixel (s - m, s/T - m/T, (t/T - m_t) log2 e,
// scaled after the subtraction: at the 3e4 clip t / T is 7500); the KL as
// r_t sum_c e_t (t/T - s/T) - (lse_t - lse_s) (p_t = e_t r_t sums to 1),
// two operations a class; maxima by trees, sums in two chains. Each thread
// sums its pixels' (nll * valid, valid, kl) in tile order, then the warp,
// the CTA in warp order, and the last CTA to take an integer ticket sums
// the CTAs' partials in a fixed tree into (3,): the same bits every call.
//
// Backward arithmetic: the plain version's, operation for operation
// (expf of each max-subtracted logit, the sums in class order, correctly
// rounded quotients, every product and difference by its _rn intrinsic so
// that nothing contracts into a multiply-add), because ds is
// compared after the rounding to bf16 at rtol 1e-4, where one bf16 ulp is
// ~2^-8: the ~2 f32 ulp of ex2.approx would flip roundings. Each quotient
// is e * r corrected once by an fma against the sum (Markstein's step on
// the correctly rounded reciprocal r): 3 reciprocals a pixel, not 3
// divisions a class. ds is written in s's dtype by each pixel's thread, a
// warp's 32 pixels of a class plane in one coalesced store; every element
// once.
//
// The C entry points launch on the caller's stream and return
// cudaGetLastError(); the Python wrapper raises if it is not 0.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;

// the launch: CTAs of kThreads, at most kCtas (one an SM on an H100), each
// with at most kSmemCta bytes of dynamic shared memory; ring slots
// kMinRing..kMaxRing; kFixed bytes beside the ring (the slots' barriers,
// the warps' sums and a flag)
constexpr int kThreads = 512, kWarps = kThreads / 32, kTile = 1024;
constexpr int kCtas = 132;
constexpr int kSmemCta = 227 * 1024;
constexpr int kMaxRing = 4, kMinRing = 2;
constexpr int kFixed = 512;

__host__ __device__ constexpr int dt_bytes(int dt) { return dt == 0 ? 4 : 2; }

// The plan of a launch (ops/losses_fused.py full_plan mirrors it): tiles of
// `tile` pixels (kTile, two a thread, or a half, quarter or eighth of it,
// the largest of which two slots fit), a slot
// holding c spans of s (s_ld bytes each), the teacher (t_ld bytes: the NHWC
// span, or each of c plane spans) and the labels; as many slots as fit,
// up to kMaxRing; per tiles a CTA, grid CTAs.
struct Plan {
  int tile, ring, s_ld, t_ld, slot, tiles_img, tiles, per, grid, smem;
};
__host__ __device__ inline Plan plan(int n, int c, int hw, int s_dt, int t_dt, bool nhwc) {
  Plan p{};
  for (p.tile = kTile;; p.tile /= 2) {
    p.s_ld = p.tile * dt_bytes(s_dt) + 16;
    p.t_ld = p.tile * (nhwc ? c : 1) * dt_bytes(t_dt) + 16;
    p.slot = c * p.s_ld + (nhwc ? 1 : c) * p.t_ld + p.tile * 8 + 16;
    p.ring = (kSmemCta - kFixed) / p.slot;
    p.ring = p.ring < kMaxRing ? p.ring : kMaxRing;
    if (p.ring >= kMinRing || p.tile == kTile / 8) break;
  }
  p.tiles_img = (hw + p.tile - 1) / p.tile;
  p.tiles = n * p.tiles_img;
  p.per = (p.tiles + kCtas - 1) / kCtas;
  p.grid = (p.tiles + p.per - 1) / p.per;
  p.smem = kFixed + p.ring * p.slot;
  return p;
}

struct Args {
  const char* s;            // (n, c, hw) f32 or bf16
  const char* t;            // (n, c, hw) class-major or (n, hw, c), f32 / bf16 / f16
  const char* labels;       // (n, hw) int64
  int s_dt, t_dt, nhwc;     // dtypes: 0 f32, 1 bf16, 2 f16
  int n, c, hw;
  float inv_t, clip;        // clip 0: none
  int ignore_index;
};

// one value at p in shared memory, of the dtype kDt (or dt at run time
// where kDt < 0)
template <int kDt>
__device__ __forceinline__ float ld(const char* p, int dt) {
  const int d = kDt >= 0 ? kDt : dt;
  if (d == 1) return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(p));
  if (d == 2) return __half2float(*reinterpret_cast<const __half*>(p));
  return *reinterpret_cast<const float*>(p);
}

// 2^x and log2(x) on the special-function unit; ex2 flushes results below
// 2^-126 to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The 16-byte-aligned superset of the span [src, src + bytes)
__device__ __forceinline__ void copy_span(char* dst, const char* src, uint32_t bytes,
                                          uint64_t* bar, bool issue, uint32_t& total) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src) & ~uintptr_t(15);
  const uintptr_t b = (reinterpret_cast<uintptr_t>(src) + bytes + 15) & ~uintptr_t(15);
  if (issue) hop::bulk_copy(dst, reinterpret_cast<const char*>(a), uint32_t(b - a), bar);
  else total += uint32_t(b - a);
}

// Where a tile lies: image, first pixel, pixels; and the low address bits
// of its spans (s's class plane 0 and the plane step, the teacher's, the
// labels'), from which a reader finds each span's true start in its slot.
struct Tile {
  int img, p0, np;
  uint32_t s_lo, s_step, t_lo, t_step, l_lo;
};
__device__ __forceinline__ Tile tile_at(const Args& a, const Plan& pl, int C, int tile) {
  Tile g;
  g.img = tile / pl.tiles_img;
  g.p0 = (tile - g.img * pl.tiles_img) * pl.tile;
  g.np = min(pl.tile, a.hw - g.p0);
  const int ses = dt_bytes(a.s_dt), tes = dt_bytes(a.t_dt);
  const size_t pix = (size_t)g.img * a.hw + g.p0;
  g.s_lo = uint32_t(reinterpret_cast<uintptr_t>(a.s) +
                    ((size_t)g.img * C * a.hw + g.p0) * ses);
  g.s_step = uint32_t(a.hw) * ses;
  g.t_lo = uint32_t(reinterpret_cast<uintptr_t>(a.t) +
                    (a.nhwc ? pix * C : (size_t)g.img * C * a.hw + g.p0) * tes);
  g.t_step = a.nhwc ? 0u : uint32_t(a.hw) * tes;
  g.l_lo = uint32_t(reinterpret_cast<uintptr_t>(a.labels) + pix * 8);
  return g;
}

// The c class-plane spans of x (es bytes an element, planes hw apart) of
// the tile at (img, p0, np), as their 16-byte-aligned supersets, into
// regions of ld bytes from dst: a warp a plane, a lane a 16-byte chunk
// (cp.async), so the CTA's threads issue the copies together
__device__ __forceinline__ void stage_planes(char* dst, int ld, const char* x, int es,
                                             const Args& a, int C, int img, int p0, int np) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int ch = warp; ch < C; ch += kWarps) {
    const uintptr_t src =
        reinterpret_cast<uintptr_t>(x + ((size_t)(img * C + ch) * a.hw + p0) * es);
    const uintptr_t a0 = src & ~uintptr_t(15);
    const int chunks = int((((src + (size_t)np * es + 15) & ~uintptr_t(15)) - a0) / 16);
    for (int j = lane; j < chunks; j += 32)
      hop::cp_async16(dst + ch * ld + 16 * j, reinterpret_cast<const char*>(a0 + 16 * j));
  }
}

// The thread that issues a tile's bulk copies: in the last warp, which
// stages the fewest planes (thread 0's warp trails the barriers)
constexpr int kIssuer = kThreads - 1;

// Stage tile `tile` into `slot` (every thread): the class planes of s (and
// of a class-major teacher) by cp.async, in this thread's current group;
// the NHWC teacher's span and the labels' span by bulk copies on `bar`,
// their bytes expected before any arrives.
__device__ void stage_tile(char* slot, uint64_t* bar, const Args& a, const Plan& pl, int tile) {
  const int C = a.c, img = tile / pl.tiles_img;
  const int p0 = (tile - img * pl.tiles_img) * pl.tile, np = min(pl.tile, a.hw - p0);
  const int ses = dt_bytes(a.s_dt), tes = dt_bytes(a.t_dt);
  stage_planes(slot, pl.s_ld, a.s, ses, a, C, img, p0, np);
  char* ts = slot + C * pl.s_ld;
  if (!a.nhwc) stage_planes(ts, pl.t_ld, a.t, tes, a, C, img, p0, np);
  if (threadIdx.x == kIssuer) {
    const size_t pix = (size_t)img * a.hw + p0;
    char* ls = ts + (a.nhwc ? pl.t_ld : C * pl.t_ld);
    uint32_t total = 0;
    for (int issue = 0; issue < 2; ++issue) {
      if (issue) hop::mbar_expect_tx(bar, total);
      if (a.nhwc) copy_span(ts, a.t + pix * C * tes, np * C * tes, bar, issue, total);
      copy_span(ls, a.labels + pix * 8, np * 8, bar, issue, total);
    }
  }
}

// the maximum of v[0..n) by a tree (fmaxf is exact, so any order gives the
// sequential maximum)
template <int N>
__device__ __forceinline__ float tree_max(const float (&v)[N]) {
  float w[N];
#pragma unroll
  for (int i = 0; i < N; ++i) w[i] = v[i];
#pragma unroll
  for (int d = 1; d < N; d *= 2)
#pragma unroll
    for (int i = 0; i + d < N; i += 2 * d) w[i] = fmaxf(w[i], w[i + d]);
  return w[0];
}

// Pixel p's logits from a staged slot: sv[c] = s (times s_scale), tv[c] =
// clip(t) / T; their maxima; and its label.
template <int CMAX, bool kExact, int kS, int kT, int kN>
__device__ __forceinline__ int64_t load_pixel(const Args& a, const Plan& pl, const char* slot,
                                              const Tile& g, int p, float s_scale,
                                              float (&sv)[CMAX], float (&tv)[CMAX], float& m_s,
                                              float& m_t) {
  const int C = kExact ? CMAX : a.c;
  const bool nhwc = kN >= 0 ? kN != 0 : a.nhwc != 0;
  const int ses = kS >= 0 ? dt_bytes(kS) : dt_bytes(a.s_dt);
  const int tes = kT >= 0 ? dt_bytes(kT) : dt_bytes(a.t_dt);
  const char* ts = slot + C * pl.s_ld;
  const char* ls = ts + (nhwc ? pl.t_ld : C * pl.t_ld);
  const char* tp = ts + (g.t_lo & 15u) + p * C * tes;    // NHWC: pixel p's row
#pragma unroll
  for (int ch = 0; ch < CMAX; ++ch) {
    sv[ch] = tv[ch] = -INFINITY;   // classes past C (a bin's padding)
    if (ch < C) {
      sv[ch] = __fmul_rn(
          ld<kS>(slot + ch * pl.s_ld + ((g.s_lo + ch * g.s_step) & 15u) + p * ses, a.s_dt),
          s_scale);
      float t = nhwc ? ld<kT>(tp + ch * tes, a.t_dt)
                     : ld<kT>(ts + ch * pl.t_ld + ((g.t_lo + ch * g.t_step) & 15u) + p * tes,
                              a.t_dt);
      if (a.clip > 0.f) t = fminf(fmaxf(t, -a.clip), a.clip);
      tv[ch] = __fmul_rn(t, a.inv_t);   // kept apart from the subtraction that follows
    }
  }
  m_s = tree_max(sv);
  m_t = tree_max(tv);
  return *reinterpret_cast<const int64_t*>(ls + (g.l_lo & 15u) + p * 8);
}

// The CTA's shared memory: the ring, then kFixed bytes: the slots'
// barriers (a slot's bulk bytes have arrived), the warps' sums [kWarps][4]
// and a flag
struct Smem {
  char* ring;
  uint64_t* full;
  float* red;
  int* flag;
};
__device__ __forceinline__ Smem carve(char* smem, const Plan& pl) {
  Smem m;
  m.ring = smem;
  m.full = reinterpret_cast<uint64_t*>(smem + pl.ring * pl.slot);
  m.red = reinterpret_cast<float*>(m.full + kMaxRing);
  m.flag = reinterpret_cast<int*>(m.red + 4 * kWarps);
  return m;
}

// The ring: ring - 1 tiles in flight while one is read. Every thread
// commits one cp.async group a tile (empty past its last), so waiting for
// all but the newest ring - 2 groups leaves its copies of tile k done.
__device__ __forceinline__ void ring_start(const Smem& m, const Args& a, const Plan& pl, int t0,
                                           int mine) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < pl.ring; ++i) hop::mbar_init(&m.full[i], 1);
    hop::mbar_init_fence();
  }
  __syncthreads();
  for (int k = 0; k + 1 < pl.ring; ++k) {
    if (k < mine) stage_tile(m.ring + k * pl.slot, &m.full[k], a, pl, t0 + k);
    hop::cp_async_commit();
  }
}

// Tile k has arrived (every thread's copies and the bulk bytes) and every
// thread is done with tile k - 1, whose slot then takes tile k + ring - 1.
__device__ __forceinline__ void ring_next(const Smem& m, const Args& a, const Plan& pl, int t0,
                                          int mine, int k) {
  if (pl.ring == 2) hop::cp_async_wait<0>();
  else if (pl.ring == 3) hop::cp_async_wait<1>();
  else hop::cp_async_wait<2>();
  hop::mbar_wait(&m.full[k % pl.ring], (k / pl.ring) & 1);
  __syncthreads();
  const int nk = k + pl.ring - 1, slot = nk % pl.ring;
  if (nk < mine) stage_tile(m.ring + slot * pl.slot, &m.full[slot], a, pl, t0 + nk);
  hop::cp_async_commit();
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

namespace ffw {

// CMAX bounds the class count C; kExact: C == CMAX. kS, kT, kN: s's and
// t's dtypes and the NHWC form at compile time, or -1: read from a.
// partials: (grid, 4) f32, the CTAs' (nll * valid, valid, kl, 0); ticket:
// zero between launches, left zero; out: (3,) f32
template <int CMAX, bool kExact, int kS, int kT, int kN>
__global__ void __launch_bounds__(kThreads, 1)
ce_kl_fwd_kernel(const Args a, float* __restrict__ partials, int* __restrict__ ticket,
                 float* __restrict__ out) {
  extern __shared__ __align__(128) char smem[];
  const int tid = threadIdx.x, C = kExact ? CMAX : a.c;
  const int ses = kS >= 0 ? dt_bytes(kS) : dt_bytes(a.s_dt);
  const Plan pl = plan(a.n, a.c, a.hw, a.s_dt, a.t_dt, a.nhwc != 0);
  const Smem m = carve(smem, pl);
  const int t0 = blockIdx.x * pl.per, mine = min(pl.per, pl.tiles - t0);
  ring_start(m, a, pl, t0, mine);

  float nll_v = 0.f, valid_n = 0.f, kl = 0.f;   // this thread's sums, in tile order
  for (int k = 0; k < mine; ++k) {
    const int slot = k % pl.ring;
    const char* base = m.ring + slot * pl.slot;
    const Tile g = tile_at(a, pl, C, t0 + k);
    ring_next(m, a, pl, t0, mine, k);
    for (int p = tid; p < g.np; p += kThreads) {
      // s in log2 units, t / T natural
      float sv[CMAX], tv[CMAX], et[CMAX], m_s, m_t;
      const int64_t lbl =
          load_pixel<CMAX, kExact, kS, kT, kN>(a, pl, base, g, p, kLog2e, sv, tv, m_s, m_t);
      // the three exponentials, each once: exp(s - m), exp(s/T - m/T) and
      // exp(t/T - m_t), the last kept for the KL; each sum over even and
      // odd classes apart (two chains of adds)
      const float m_sT = m_s * a.inv_t;
      float sum1[2] = {0.f, 0.f}, sum_s[2] = {0.f, 0.f}, sum_t[2] = {0.f, 0.f};
#pragma unroll
      for (int ch = 0; ch < CMAX; ++ch) {
        if (ch < C) {
          sum1[ch & 1] += ex2(sv[ch] - m_s);
          sum_s[ch & 1] += ex2(sv[ch] * a.inv_t - m_sT);
          et[ch] = ex2((tv[ch] - m_t) * kLog2e);
          sum_t[ch & 1] += et[ch];
        }
      }
      // s[label] from the slot (0 outside [0, C)), in log2 units
      float s_lbl = 0.f;
      if (lbl >= 0 && lbl < C) {
        const int l = (int)lbl;
        s_lbl = ld<kS>(base + l * pl.s_ld + ((g.s_lo + l * g.s_step) & 15u) + p * ses,
                       a.s_dt) * kLog2e;
      }
      const float valid = lbl != a.ignore_index ? 1.f : 0.f;
      nll_v = fmaf(valid, (m_s + lg2(sum1[0] + sum1[1]) - s_lbl) * kLn2, nll_v);
      valid_n += valid;
      // kl = sum_c p_t (log p_t - log p_s) = r_t sum_c e_t (t/T - s/T) -
      // (lse_t - lse_s), with p_t = e_t r_t and sum_c p_t = 1: two
      // operations a class. The -87 clamp of log p_t changes only classes
      // with p_t < e^-87, whose terms are below 1e-34 (and e_t flushes to 0
      // there)
      const float st = sum_t[0] + sum_t[1];
      const float lse_t = fmaf(lg2(st), kLn2, m_t);
      const float lse_s = (m_sT + lg2(sum_s[0] + sum_s[1])) * kLn2;
      const float to_nat = -kLn2 * a.inv_t;   // s log2(e) -> -s / T
      float kp[2] = {0.f, 0.f};
#pragma unroll
      for (int ch = 0; ch < CMAX; ++ch)
        if (ch < C) kp[ch & 1] = fmaf(et[ch], fmaf(sv[ch], to_nat, tv[ch]), kp[ch & 1]);
      kl += (kp[0] + kp[1]) / st - (lse_t - lse_s);
    }
  }

  // the CTA's sums: warps by shuffles, then the warps in order
  nll_v = warp_sum(nll_v);
  valid_n = warp_sum(valid_n);
  kl = warp_sum(kl);
  if (tid % 32 == 0) {
    m.red[4 * (tid / 32)] = nll_v;
    m.red[4 * (tid / 32) + 1] = valid_n;
    m.red[4 * (tid / 32) + 2] = kl;
  }
  __syncthreads();
  if (tid < 4) {
    float v = 0.f;
    if (tid < 3)
#pragma unroll
      for (int wi = 0; wi < kWarps; ++wi) v += m.red[4 * wi + tid];
    __stcg(partials + 4 * blockIdx.x + tid, v);
  }
  // the CTAs' partials, summed by the last CTA to finish: lane l adds
  // CTAs l, l + 32, .. in order, then the lanes by shuffles (a fixed tree)
  __threadfence();
  __syncthreads();
  if (tid == 0) *m.flag = atomicAdd(ticket, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!*m.flag || tid >= 32) return;
  __threadfence();
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int b = tid; b < (int)gridDim.x; b += 32) {
    const float4 q = __ldcg(reinterpret_cast<const float4*>(partials) + b);
    v.x += q.x, v.y += q.y, v.z += q.z;
  }
  v.x = warp_sum(v.x);
  v.y = warp_sum(v.y);
  v.z = warp_sum(v.z);
  if (tid == 0) {
    out[0] = v.x, out[1] = v.y, out[2] = v.z;
    *ticket = 0;
  }
}

}  // namespace ffw

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

namespace fbw {

// x / d correctly rounded from r = 1 / d correctly rounded (Markstein: the
// quotient's residual, exact by the fma, corrects x r once); x in [0, 1],
// d in [1, C]: no overflow, and below 2^-126 only x's own rounding
__device__ __forceinline__ float quot(float x, float d, float r) {
  const float q = __fmul_rn(x, r);
  return __fmaf_rn(__fmaf_rn(-q, d, x), r, q);
}

template <int CMAX, bool kExact, int kS, int kT, int kN>
__global__ void __launch_bounds__(kThreads, 1)
ce_kl_bwd_kernel(const Args a, const float* __restrict__ scales, char* __restrict__ ds) {
  extern __shared__ __align__(128) char smem[];
  const int tid = threadIdx.x, C = kExact ? CMAX : a.c;
  const int ses = kS >= 0 ? dt_bytes(kS) : dt_bytes(a.s_dt);
  const Plan pl = plan(a.n, a.c, a.hw, a.s_dt, a.t_dt, a.nhwc != 0);
  const Smem m = carve(smem, pl);
  const int t0 = blockIdx.x * pl.per, mine = min(pl.per, pl.tiles - t0);
  ring_start(m, a, pl, t0, mine);
  const float sa_all = scales[0], sk = scales[1];

  for (int k = 0; k < mine; ++k) {
    const int slot = k % pl.ring;
    const Tile g = tile_at(a, pl, C, t0 + k);
    ring_next(m, a, pl, t0, mine, k);
    for (int p = tid; p < g.np; p += kThreads) {
      float sv[CMAX], tv[CMAX], es[CMAX], m_s, m_t;
      const int64_t lbl = load_pixel<CMAX, kExact, kS, kT, kN>(
          a, pl, m.ring + slot * pl.slot, g, p, 1.f, sv, tv, m_s, m_t);
      // the plain version's softmaxes: exp of each max-subtracted logit,
      // summed in class order; s / T as s * (1 / T), as torch scales by a
      // scalar, whose maximum is m_s / T (rounding is monotone)
      const float m_sT = __fmul_rn(m_s, a.inv_t);
      float sum1 = 0.f, sum_s = 0.f, sum_t = 0.f;
#pragma unroll
      for (int ch = 0; ch < CMAX; ++ch) {
        if (ch < C) {
          es[ch] = expf(__fsub_rn(__fmul_rn(sv[ch], a.inv_t), m_sT));
          sv[ch] = expf(sv[ch] - m_s);
          tv[ch] = expf(tv[ch] - m_t);
          sum1 += sv[ch];
          sum_s += es[ch];
          sum_t += tv[ch];
        }
      }
      const float r1 = __frcp_rn(sum1), rs = __frcp_rn(sum_s), rt = __frcp_rn(sum_t);
      const float sa = lbl != a.ignore_index ? sa_all : 0.f;
      const int l32 = lbl >= 0 && lbl < C ? (int)lbl : -1;   // the one-hot's class
      char* o = ds + ((size_t)(g.img * C) * a.hw + g.p0 + p) * ses;
#pragma unroll
      for (int ch = 0; ch < CMAX; ++ch) {
        if (ch < C) {
          // a (p - onehot) valid + k (p_s - p_t), rounded as the plain
          // version's separate torch ops round it
          const float onehot = ch == l32 ? 1.f : 0.f;
          const float gce = __fmul_rn(sa, __fsub_rn(quot(sv[ch], sum1, r1), onehot));
          const float gkl = __fmul_rn(sk, __fsub_rn(quot(es[ch], sum_s, rs),
                                                   quot(tv[ch], sum_t, rt)));
          const float gv = __fadd_rn(gce, gkl);
          char* q = o + (size_t)ch * a.hw * ses;
          if (ses == 2) *reinterpret_cast<__nv_bfloat16*>(q) = __float2bfloat16_rn(gv);
          else *reinterpret_cast<float*>(q) = gv;
        }
      }
    }
  }
}

}  // namespace fbw

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <auto kKern>
cudaError_t raise_smem() {
  static bool raised = false;   // the shared-memory opt-in, once per instance
  if (!raised) {
    const cudaError_t e =
        cudaFuncSetAttribute(kKern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemCta);
    if (e != cudaSuccess) return e;
    raised = true;
  }
  return cudaSuccess;
}

template <int CMAX, bool kExact, int kS, int kT, int kN>
cudaError_t run(const Args& a, const Plan& p, const float* scales, void* out, float* partials,
                int* ticket, bool bwd, cudaStream_t st) {
  if (bwd) {
    constexpr auto kern = fbw::ce_kl_bwd_kernel<CMAX, kExact, kS, kT, kN>;
    const cudaError_t e = raise_smem<kern>();
    if (e != cudaSuccess) return e;
    kern<<<p.grid, kThreads, p.smem, st>>>(a, scales, static_cast<char*>(out));
  } else {
    constexpr auto kern = ffw::ce_kl_fwd_kernel<CMAX, kExact, kS, kT, kN>;
    const cudaError_t e = raise_smem<kern>();
    if (e != cudaSuccess) return e;
    kern<<<p.grid, kThreads, p.smem, st>>>(a, partials, ticket, static_cast<float*>(out));
  }
  return cudaGetLastError();
}

// exact instances for 21 and 19 classes (configs #1 and #3) with s in
// either dtype and the cache's float16 NHWC teacher; every other case up to
// 32 classes in bins of 8, its dtypes and form read at run time
int dispatch(const Args& a, const float* scales, void* out, float* partials, int* ticket,
             bool bwd, int grid, int smem, void* stream) {
  if ((a.s_dt != 0 && a.s_dt != 1) || a.t_dt < 0 || a.t_dt > 2 || a.c < 1 || a.c > 32 ||
      a.n < 1 || a.hw < 1)
    return (int)cudaErrorInvalidValue;
  const Plan p = plan(a.n, a.c, a.hw, a.s_dt, a.t_dt, a.nhwc != 0);
  if (grid != p.grid || smem != p.smem || p.ring < kMinRing || p.smem > kSmemCta)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool cache = a.t_dt == 2 && a.nhwc;
  if (cache && a.c == 21)
    return (int)(a.s_dt ? run<21, true, 1, 2, 1>(a, p, scales, out, partials, ticket, bwd, st)
                        : run<21, true, 0, 2, 1>(a, p, scales, out, partials, ticket, bwd, st));
  if (cache && a.c == 19)
    return (int)(a.s_dt ? run<19, true, 1, 2, 1>(a, p, scales, out, partials, ticket, bwd, st)
                        : run<19, true, 0, 2, 1>(a, p, scales, out, partials, ticket, bwd, st));
  if (a.c <= 8) return (int)run<8, false, -1, -1, -1>(a, p, scales, out, partials, ticket, bwd, st);
  if (a.c <= 16)
    return (int)run<16, false, -1, -1, -1>(a, p, scales, out, partials, ticket, bwd, st);
  if (a.c <= 24)
    return (int)run<24, false, -1, -1, -1>(a, p, scales, out, partials, ticket, bwd, st);
  return (int)run<32, false, -1, -1, -1>(a, p, scales, out, partials, ticket, bwd, st);
}

Args make_args(int s_dt, int t_dt, int nhwc, const void* s, const void* t, const void* labels,
               int n, int c, int hw, float inv_t, float clip, int ignore_index) {
  Args a{};
  a.s = static_cast<const char*>(s);
  a.t = static_cast<const char*>(t);
  a.labels = static_cast<const char*>(labels);
  a.s_dt = s_dt;
  a.t_dt = t_dt;
  a.nhwc = nhwc != 0;
  a.n = n; a.c = c; a.hw = hw;
  a.inv_t = inv_t;
  a.clip = clip;
  a.ignore_index = ignore_index;
  return a;
}

}  // namespace

extern "C" {

// The plan of a launch by `what`: 0 tile pixels, 1 ring slots, 2 slot
// bytes, 3 tiles a CTA, 4 CTAs, 5 dynamic shared memory; -1 for a shape
// the kernels do not take. s_dt 0 f32 / 1 bf16, t_dt 0 f32 / 1 bf16 / 2
// f16, nhwc 1 for the teacher's NHWC form.
int kdcc_ce_kl_plan(int what, int n, int c, int hw, int s_dt, int t_dt, int nhwc) {
  if (n < 1 || c < 1 || c > 32 || hw < 1 || s_dt < 0 || s_dt > 1 || t_dt < 0 || t_dt > 2)
    return -1;
  const Plan p = plan(n, c, hw, s_dt, t_dt, nhwc != 0);
  if (p.ring < kMinRing) return -1;
  switch (what) {
    case 0: return p.tile;
    case 1: return p.ring;
    case 2: return p.slot;
    case 3: return p.per;
    case 4: return p.grid;
    case 5: return p.smem;
    default: return -1;
  }
}

// Forward. out (3,) f32; partials f32 scratch of 4 x grid; ticket one int32,
// zero, left zero. grid and smem must be the plan's.
int kdcc_ce_kl_fwd(int s_dt, int t_dt, int nhwc, const void* s, const void* t,
                   const void* labels, void* out, void* partials, void* ticket, int n, int c,
                   int hw, float inv_t, float clip, int ignore_index, int grid, int smem,
                   void* stream) {
  const Args a = make_args(s_dt, t_dt, nhwc, s, t, labels, n, c, hw, inv_t, clip, ignore_index);
  return dispatch(a, nullptr, out, static_cast<float*>(partials), static_cast<int*>(ticket),
                  false, grid, smem, stream);
}

// Backward. scales: (a, k) f32 on the device; ds: (n, c, hw) in s's dtype.
// grid and smem must be the plan's.
int kdcc_ce_kl_bwd(int s_dt, int t_dt, int nhwc, const void* s, const void* t,
                   const void* labels, const void* scales, void* ds, int n, int c, int hw,
                   float inv_t, float clip, int ignore_index, int grid, int smem, void* stream) {
  const Args a = make_args(s_dt, t_dt, nhwc, s, t, labels, n, c, hw, inv_t, clip, ignore_index);
  return dispatch(a, static_cast<const float*>(scales), ds, nullptr, nullptr, true, grid, smem,
                  stream);
}

}  // extern "C"

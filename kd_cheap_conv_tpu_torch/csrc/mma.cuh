// The warp-level product routines of head_convs.cu (`gemm`: sub-tiles dealt
// round-robin over the warps) and wide_pw.cu / sep_conv.cuh (`WarpGemm`: a
// fixed block of sub-tiles per warp, `frags_to_smem` its tile out to shared
// memory): mma.sync m16n8k16 for bfloat16, FMAs in the same
// fragment layout for float32 (the f32 path is for parity checks), over
// shared-memory operands, for CTAs of kMmaWarps warps. Both issue the one
// bf16 step `mma_bf16` on the fragments `a_frag` / `b_frag` load, and map
// accumulator values to rows and columns with `frag_rc`. The ldmatrix
// loads (`ldsm_x4`, `ldsm_x2` and their `.trans` forms) serve the kernels
// that stage fragments themselves (bn_passes.cu, ir_block_eval.cu,
// head_convs.cu's bf16 B1).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMmaWarps = 8;

// the one bf16 tensor-core step both routines issue: d += a . b on this
// thread's fragments (a0 = A[g][2t..], a1 = A[g+8][2t..], a2 = A[g][2t+8..],
// a3 = A[g+8][2t+8..]; b0 = Bt[g][2t..], b1 = Bt[g][2t+8..])
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// this thread's A fragment of the 16 x 16 block at a, and its Bt fragment
// of the 8 x 16 block at bt
__device__ __forceinline__ void a_frag(uint32_t (&f)[4], const __nv_bfloat16* a, int lda,
                                       int lane) {
  const __nv_bfloat16* p = a + (lane >> 2) * lda + 2 * (lane & 3);
  f[0] = *reinterpret_cast<const uint32_t*>(p);
  f[1] = *reinterpret_cast<const uint32_t*>(p + 8 * lda);
  f[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  f[3] = *reinterpret_cast<const uint32_t*>(p + 8 * lda + 8);
}
__device__ __forceinline__ void b_frag(uint32_t (&f)[2], const __nv_bfloat16* bt, int ldb,
                                       int lane) {
  const __nv_bfloat16* p = bt + (lane >> 2) * ldb + 2 * (lane & 3);
  f[0] = *reinterpret_cast<const uint32_t*>(p);
  f[1] = *reinterpret_cast<const uint32_t*>(p + 8);
}

// ldmatrix: this thread's share of four (x4) or two (x2) 8 x 8 bf16
// matrices, each lane giving a row's shared-memory address (lanes 8 i ..
// 8 i + 7 those of matrix i); .trans delivers them transposed
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// (row, column) of value e of this thread's part of the 16 x 8 sub-tile
// (m, n): the layout of PTX mma.m16n8k16's accumulator fragments
__device__ __forceinline__ int2 frag_rc(int m, int n, int e) {
  const int lane = threadIdx.x & 31;
  return make_int2(m * 16 + (lane >> 2) + 8 * (e >> 1), n * 8 + 2 * (lane & 3) + (e & 1));
}

// ---------------------------------------------------------------------------
// the product routine: C (16 mt x 8 nt) += A (16 mt x K) . Bt (8 nt x K)^T,
// A and Bt row-major in shared memory, K a multiple of 16. Sub-tile
// s = m * nt + n (16 x 8) belongs to warp s % kMmaWarps, slot s / kMmaWarps; a
// thread's four values of it are C[16 m + g + 8 (e / 2)][8 n + 2 t + e % 2],
// g = lane / 4, t = lane % 4: the layout of PTX mma.m16n8k16's fragments.
// ---------------------------------------------------------------------------

template <typename T> struct Mma;
template <> struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void step(float (&d)[4], const __nv_bfloat16* a, int lda,
                                              const __nv_bfloat16* bt, int ldb, int lane) {
    uint32_t fa[4], fb[2];
    a_frag(fa, a, lda, lane);
    b_frag(fb, bt, ldb, lane);
    mma_bf16(d, fa, fb);
  }
};
template <> struct Mma<float> {
  static __device__ __forceinline__ void step(float (&d)[4], const float* a, int lda,
                                              const float* bt, int ldb, int lane) {
    const int g = lane >> 2, t = lane & 3;
    const float *a0 = a + g * lda, *a1 = a + (g + 8) * lda;
    const float *b0 = bt + 2 * t * ldb, *b1 = bt + (2 * t + 1) * ldb;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      d[0] = fmaf(a0[k], b0[k], d[0]);
      d[1] = fmaf(a0[k], b1[k], d[1]);
      d[2] = fmaf(a1[k], b0[k], d[2]);
      d[3] = fmaf(a1[k], b1[k], d[3]);
    }
  }
};

template <typename T, int S>
__device__ __forceinline__ void gemm(float (&acc)[S][4], const T* A, int lda, const T* Bt,
                                     int ldb, int mt, int nt, int K) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const int s = warp + i * kMmaWarps;
    if (s < mt * nt) {
      const int m = s / nt, n = s - m * nt;
      for (int k0 = 0; k0 < K; k0 += 16)
        Mma<T>::step(acc[i], A + m * 16 * lda + k0, lda, Bt + n * 8 * ldb + k0, ldb, lane);
    }
  }
}

// (row, column) of value e of this thread's slot i, row -1 if the slot is empty
__device__ __forceinline__ int2 frag_at(int i, int e, int mt, int nt) {
  const int s = (threadIdx.x >> 5) + i * kMmaWarps;
  if (s >= mt * nt) return make_int2(-1, -1);
  const int m = s / nt;
  return frag_rc(m, s - m * nt, e);
}

template <int S> __device__ __forceinline__ void zero(float (&acc)[S][4]) {
#pragma unroll
  for (int i = 0; i < S; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
}

// row stride (elements) of a shared-memory operand of K columns: 16 bytes of
// padding, which also keeps the mma fragment loads free of bank conflicts
__host__ __device__ constexpr int ld_of(int k) { return k + 8; }

// ---------------------------------------------------------------------------
// the warp-tiled product routine: warp w takes the MW x NW block of 16 x 8
// sub-tiles at m-block (w / WN) * MW, n-block (w % WN) * NW (the CTA's
// warps as a kMmaWarps / WN x WN grid), and for bfloat16 loads each A and B
// fragment once per 16-deep step into registers for all MW x NW products
// (`gemm` reloads both for every sub-tile). Sub-tiles at n-block >= nt are
// skipped. acc[i * NW + j] holds sub-tile (i, j); `warp_frag_at` maps its
// values as frag_at does.
// ---------------------------------------------------------------------------

template <typename T, int MW, int NW, int WN> struct WarpGemm {
  static __device__ __forceinline__ void run(float (&acc)[MW * NW][4], const T* A, int lda,
                                             const T* Bt, int ldb, int nt, int K) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int mb = (warp / WN) * MW, nb = (warp % WN) * NW;
    for (int k0 = 0; k0 < K; k0 += 16)
#pragma unroll
      for (int i = 0; i < MW; ++i)
#pragma unroll
        for (int j = 0; j < NW; ++j)
          if (nb + j < nt)
            Mma<T>::step(acc[i * NW + j], A + (mb + i) * 16 * lda + k0, lda,
                         Bt + (nb + j) * 8 * ldb + k0, ldb, lane);
  }
};

template <int MW, int NW, int WN> struct WarpGemm<__nv_bfloat16, MW, NW, WN> {
  static __device__ __forceinline__ void run(float (&acc)[MW * NW][4],
                                             const __nv_bfloat16* A, int lda,
                                             const __nv_bfloat16* Bt, int ldb, int nt, int K) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int mb = (warp / WN) * MW, nb = (warp % WN) * NW;
    for (int k0 = 0; k0 < K; k0 += 16) {
      uint32_t a[MW][4], b[NW][2];
#pragma unroll
      for (int i = 0; i < MW; ++i) a_frag(a[i], A + (mb + i) * 16 * lda + k0, lda, lane);
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        if (nb + j < nt)
          b_frag(b[j], Bt + (nb + j) * 8 * ldb + k0, ldb, lane);
        else
          b[j][0] = b[j][1] = 0u;
      }
#pragma unroll
      for (int i = 0; i < MW; ++i)
#pragma unroll
        for (int j = 0; j < NW; ++j)
          if (nb + j < nt) mma_bf16(acc[i * NW + j], a[i], b[j]);
    }
  }
};

// (row, column) of value e of sub-tile i * NW + j of this thread's warp block
template <int MW, int NW, int WN>
__device__ __forceinline__ int2 warp_frag_at(int s, int e) {
  const int warp = threadIdx.x >> 5;
  return frag_rc((warp / WN) * MW + s / NW, (warp % WN) * NW + s % NW, e);
}

// a CTA's WarpGemm accumulators -> the f32 tile c in shared memory (rows
// ldc floats apart)
template <int MW, int NW, int WN>
__device__ __forceinline__ void frags_to_smem(const float (&acc)[MW * NW][4], float* c,
                                              int ldc) {
#pragma unroll
  for (int i = 0; i < MW * NW; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int2 rc = warp_frag_at<MW, NW, WN>(i, e);
      c[rc.x * ldc + rc.y] = acc[i][e];
    }
}

}  // namespace

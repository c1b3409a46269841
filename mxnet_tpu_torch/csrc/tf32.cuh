// The split-TF32 pieces that the float32 attention kernels share: K1
// (flash_fwd.cu) and K2/K3 (flash_bwd.cu).  The product itself
// (hopper.cuh::split_tf32, split_frag, mma_tf32, wgmma_tf32_*) computes
// A·B as A_lo·B_hi + A_hi·B_lo + A_hi·B_hi in float32 from TF32 parts; here
// are the loaders and the layouts that feed it:
//   - stage_async: rows of a [b, s, h, d] float32 view into shared memory
//     by cp.async, zero past the sequence and past d;
//   - store_natural / split_natural / split_transposed: hi and lo planes in
//     wgmma's no-swizzle core-matrix layout (hopper.cuh), as the B (or A)
//     operand of a product reduced over d ("natural") or over the tile's
//     rows ("transposed");
//   - score_wg: S = A Bᵀ with A split per step in registers (K2/K3);
//   - issue_part / add_part: X B for 64 output columns, X from registers;
//   - mma3 and kChunkK for the mma.sync route (width 256 of K2/K3).
// The tensor cores' float32 accumulation truncates, so every user chains
// at most kChunkK / 8 k-steps (12 products) in a zeroed accumulator and
// adds it to the running sum by a float32 add, which rounds to nearest.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace tf32 {

// One [b, s, h, d] float32 input: base and (b, s, h) strides in elements.
struct View {
  const float* p;
  int64_t b, s, h;
};

// views[i] of base[i] with strides st[3i .. 3i + 2]; returns 1 if every
// base is 16-byte aligned and every stride a multiple of 4 elements (the
// loaders may then copy 16 bytes at a time), else 0.
inline int make_views(int n, const void* const* base, const int64_t* st,
                      View* views) {
  int vec = 1;
  for (int i = 0; i < n; ++i) {
    views[i] = View{static_cast<const float*>(base[i]), st[3 * i],
                    st[3 * i + 1], st[3 * i + 2]};
    if (reinterpret_cast<uintptr_t>(base[i]) % 16 || st[3 * i] % 4 ||
        st[3 * i + 1] % 4 || st[3 * i + 2] % 4)
      vec = 0;
  }
  return vec;
}

// dst[r * kSD + c] = src[(row0 + r) * ss + c] for r < rows, c < D by
// cp.async; rows at or past nrows and columns at or past d are zeros.
// vec: 16-byte copies (base and row stride in whole 16-byte units), else
// 4-byte copies.
template <int D, int kThreads, int kSD = D + 4>
__device__ __forceinline__ void stage_async(float* dst, const float* src,
                                            int64_t ss, int row0, int nrows,
                                            int rows, int d, bool vec) {
  if (vec) {
    for (int e = threadIdx.x; e < rows * (D / 4); e += kThreads) {
      const int r = e / (D / 4), c = e % (D / 4) * 4;
      const int row = row0 + r;
      const bool ok = row < nrows && c < d;
      hopper::cp_async_16(dst + r * kSD + c, ok ? src + row * ss + c : src,
                          ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < rows * D; e += kThreads) {
      const int r = e / D, c = e % D;
      const int row = row0 + r;
      const bool ok = row < nrows && c < d;
      hopper::cp_async_4(dst + r * kSD + c, ok ? src + row * ss + c : src,
                         ok ? 4 : 0);
    }
  }
}

// The tensor cores' float32 accumulation truncates, so a long chain of
// products into one accumulator drifts toward zero.  Every product below
// sums at most kChunkK / 8 k-steps in zeroed accumulators (on mma.sync one
// for the A_hi·B_hi terms and one for the two small terms, which also
// gives the tensor cores independent chains to overlap) and adds them to
// the running sum by float32 adds, which round to nearest.
constexpr int kChunkK = 32;

// big += A_hi B_hi, small += A_lo B_hi + A_hi B_lo, A and B split already.
__device__ __forceinline__ void mma3(float (&big)[4], float (&small)[4],
                                     const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float bh0,
                                     float bh1, float bl0, float bl1) {
  hopper::mma_tf32(small, al, __float_as_uint(bh0), __float_as_uint(bh1));
  hopper::mma_tf32(small, ah, __float_as_uint(bl0), __float_as_uint(bl1));
  hopper::mma_tf32(big, ah, __float_as_uint(bh0), __float_as_uint(bh1));
}

// Columns 4q .. 4q + 3 of row r, split, into a hi and a lo plane of the
// core-matrix layout with R rows and K = the columns, each 8-column step
// in the k-slot order of an accumulator read as an A fragment (slot s < 4
// holds column 2s, slot s + 4 column 2s + 1; a sum over the columns runs
// in any order, so both operands of a product reduced over them only have
// to agree): columns 8kk + 4(q % 2) + {0, 2} are slots 2 (q % 2) + {0, 1}
// of core 2kk, columns + {1, 3} the same slots of core 2kk + 1, 16 R bytes
// further.
template <int R>
__device__ __forceinline__ void store_natural(uint8_t* hi, uint8_t* lo, int r,
                                              int q, float4 x) {
  uint32_t h[4], l[4];
  hopper::split_frag(x.x, x.y, x.z, x.w, h, l);
  const int o = 128 * ((q & ~1) * (R / 8) + r / 8) + 16 * (r % 8) + 8 * (q & 1);
  *reinterpret_cast<uint2*>(hi + o) = make_uint2(h[0], h[2]);
  *reinterpret_cast<uint2*>(hi + o + 16 * R) = make_uint2(h[1], h[3]);
  *reinterpret_cast<uint2*>(lo + o) = make_uint2(l[0], l[2]);
  *reinterpret_cast<uint2*>(lo + o + 16 * R) = make_uint2(l[1], l[3]);
}

// The split of one raw streamed tile (kRows x D at a row stride of D + 4
// floats) into its planes, by kThreads threads.
//
// Natural: a hi and a lo plane (store_natural) with rows = the kRows
// streamed rows and K = the D columns.  A thread splits 4 columns of a row
// (one 16-byte load); consecutive threads take consecutive rows.
template <int D, int kRows = 16, int kThreads = 256>
__device__ __forceinline__ void split_natural(uint8_t* hi, uint8_t* lo,
                                              const float* raw) {
  constexpr int kSDr = D + 4;
  for (int e = threadIdx.x; e < kRows * D / 4; e += kThreads) {
    const int r = e % kRows, q = e / kRows;  // columns 4q .. 4q + 3
    store_natural<kRows>(
        hi, lo, r, q, *reinterpret_cast<const float4*>(raw + r * kSDr + 4 * q));
  }
}

// Transposed: a hi and a lo plane of the core-matrix layout with rows = the
// D columns and K = the kRows k-slots (slot c of 8-row block j is row 8j +
// 2c, slot c + 4 row 8j + 2c + 1).  A thread splits the 4 slots of one
// column that share a core row (4 loads, a 16-byte store to each plane);
// consecutive threads take consecutive columns.
template <int D, int kRows = 16, int kThreads = 256>
__device__ __forceinline__ void split_transposed(uint8_t* hi, uint8_t* lo,
                                                 const float* raw) {
  constexpr int kSDr = D + 4;
  for (int e = threadIdx.x; e < kRows / 4 * D; e += kThreads) {
    const int n = e % D, kc = e / D;  // slots 4kc .. 4kc + 3
    const float* col = raw + (8 * (kc / 2) + (kc & 1)) * kSDr + n;
    uint32_t h[4], l[4];
    hopper::split_frag(col[0], col[2 * kSDr], col[4 * kSDr], col[6 * kSDr], h,
                       l);
    const int o = 128 * (kc * (D / 8) + n / 8) + 16 * (n % 8);
    *reinterpret_cast<uint4*>(hi + o) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + o) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// s0 = A0 B0ᵀ and s1 = A1 B1ᵀ (64 x 16 per warpgroup, over D columns) by
// wgmma.m64n16k8, the two products interleaved: A from registers, the
// warp's 16 raw resident rows split here per 8-column step (the thread's
// row g, columns 2c, 2c + 1 as k-slots c, c + 4: two 8-byte loads), B a
// natural hi and lo plane pair (descriptors of their first step).  The A
// fragments of two steps alternate, so a step's loads and split overlap
// the previous step's products.  Each product's three terms sum per
// kChunkK columns in a zeroed part, added in float32.
template <int D, int kSD>
__device__ __forceinline__ void score_wg(float (&s0)[8], float (&s1)[8],
                                         const float* a0, const float* a1,
                                         uint64_t b0h, uint64_t b0l,
                                         uint64_t b1h, uint64_t b1l) {
  constexpr uint32_t kLbo = 16 * 16;  // 16-row planes
  constexpr int kSteps = kChunkK / 8;
  auto lda = [](const float* p) { return *reinterpret_cast<const float2*>(p); };
#pragma unroll
  for (int k0 = 0; k0 < D / 8; k0 += kSteps) {
    float p0[8], p1[8];
    uint32_t ah[2][2][4], al[2][2][4];  // [step % 2][tensor]
#pragma unroll
    for (int kk = k0; kk < k0 + kSteps; ++kk) {
      const int r = kk & 1;
      float2 x = lda(a0 + 8 * kk), y = lda(a0 + 8 * kSD + 8 * kk);
      hopper::split_frag(x.x, y.x, x.y, y.y, ah[r][0], al[r][0]);
      x = lda(a1 + 8 * kk);
      y = lda(a1 + 8 * kSD + 8 * kk);
      hopper::split_frag(x.x, y.x, x.y, y.y, ah[r][1], al[r][1]);
      hopper::fence_regs(p0);
      hopper::fence_regs(p1);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        hopper::fence_regs(ah[r][t]);
        hopper::fence_regs(al[r][t]);
      }
      hopper::wgmma_fence();
      const uint32_t ob = (kk * 2 * kLbo) >> 4;
      const int acc = kk > k0;
      hopper::wgmma_tf32_rs_n16(p0, al[r][0], b0h + ob, acc);
      hopper::wgmma_tf32_rs_n16(p1, al[r][1], b1h + ob, acc);
      hopper::wgmma_tf32_rs_n16(p0, ah[r][0], b0l + ob, 1);
      hopper::wgmma_tf32_rs_n16(p1, ah[r][1], b1l + ob, 1);
      hopper::wgmma_tf32_rs_n16(p0, ah[r][0], b0h + ob, 1);
      hopper::wgmma_tf32_rs_n16(p1, ah[r][1], b1h + ob, 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();  // the previous step's products are done
      if (kk > k0) {  // its A registers stay untouched until here
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          hopper::fence_regs(ah[r ^ 1][t]);
          hopper::fence_regs(al[r ^ 1][t]);
        }
      }
    }
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      hopper::fence_regs(ah[(k0 + kSteps - 1) & 1][t]);
      hopper::fence_regs(al[(k0 + kSteps - 1) & 1][t]);
    }
    hopper::fence_regs(p0);
    hopper::fence_regs(p1);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s0[i] += p0[i];
      s1[i] += p1[i];
    }
  }
}

// part = X B for output columns 64n .. 64n + 63 over kSteps 8-row k-steps
// of a streamed tile by wgmma, issued and committed, not waited for: X
// from registers (hi and lo A fragments of the warpgroup's 64 rows, one
// per k-step), B a transposed hi and lo plane pair of D rows (descriptors
// of their first k-step).  3 kSteps products: at most 12.
template <int D, int kSteps = 2>
__device__ __forceinline__ void issue_part(float (&part)[32],
                                           uint32_t (&xh)[kSteps][4],
                                           uint32_t (&xl)[kSteps][4],
                                           uint64_t bh, uint64_t bl, int n) {
  constexpr uint32_t kLbo = 16 * D;
  hopper::fence_regs(part);
#pragma unroll
  for (int j = 0; j < kSteps; ++j) hopper::fence_regs(xh[j]);
#pragma unroll
  for (int j = 0; j < kSteps; ++j) hopper::fence_regs(xl[j]);
  hopper::wgmma_fence();
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    const uint32_t ob = (j * 2 * kLbo + n * 1024) >> 4;
    hopper::wgmma_tf32_rs_n64(part, xl[j], bh + ob, j > 0);
    hopper::wgmma_tf32_rs_n64(part, xh[j], bl + ob, 1);
    hopper::wgmma_tf32_rs_n64(part, xh[j], bh + ob, 1);
  }
  hopper::wgmma_commit();
}

// acc (columns 64n ..) += part, in float32
template <int D>
__device__ __forceinline__ void add_part(float (&acc)[D / 2],
                                         float (&part)[32], int n) {
  hopper::fence_regs(part);
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[32 * n + i] += part[i];
}

}  // namespace tf32

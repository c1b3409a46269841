// Hopper (sm_90a) building blocks written out in PTX: mbarriers, TMA tensor
// maps and loads, wgmma operand descriptors and the bf16 wgmma products the
// attention kernels issue, the split-TF32 float32 product on mma.sync and
// wgmma (A from registers or, with both operands in shared memory, SS),
// cp.async, named barriers, and register reallocation between warpgroups.
//
// Layout contract shared by the TMA maps and the wgmma descriptors: a tile
// of R rows by D bf16 columns lives in shared memory as D / 64 column blocks
// of R rows x 128 bytes each, every block 1024-byte aligned and written by
// TMA with the 128-byte swizzle (16-byte chunk c of row r lands at chunk
// c ^ (r % 8)).  One TMA box fills one column block.
//   K-major operand (the reduction runs along a row): 8-row groups at a
//     stride of 1024 bytes (SBO); the k-th 16-column step of the reduction
//     starts (k % 4) * 32 bytes into the row of column block k / 4.
//   MN-major operand (the reduction runs down the rows, through the
//     transpose bit): 64-column blocks of the output at LBO = R * 128
//     bytes, 8-row groups of the reduction at SBO = 1024; the k-th 16-row
//     step starts k * 2048 bytes into the tile.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar))
               : "memory");
}

// Arrive and add `bytes` to the transaction count the phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Block until the phase with the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA ------------------------------------------------------------------

// One box of a 4-d tensor map into shared memory; completion is counted on
// `bar` in bytes.  Coordinates are innermost first.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no link against libcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A bf16 [b, s, h, d] view with unit stride in d and (b, s, h) strides in
// elements, mapped as the 4-d tensor {d, h, s, b} with boxes of 64 columns
// by `box_rows` rows of one head, 128-byte swizzle.  Rows at or past s, and
// columns at or past d (a box reaching past a head dim of 32 or 96), read
// as zeros; the transaction still counts the whole box.  Returns false if
// cuTensorMapEncodeTiled refuses (TMA wants a 16-byte aligned base and
// strides that are multiples of 16 bytes).
inline bool encode_bshd_bf16(CUtensorMap* map, const void* base, int b, int s,
                             int h, int d, int64_t stride_b, int64_t stride_s,
                             int64_t stride_h, int box_rows) {
  EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)h, (cuuint64_t)s,
                              (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)stride_h * 2,
                                 (cuuint64_t)stride_s * 2,
                                 (cuuint64_t)stride_b * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---- wgmma ----------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle; offsets in bytes.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Wait until at most N committed wgmma groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Pin registers that an asynchronous wgmma reads or writes, so the
// compiler neither moves nor reuses them across the issue and the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// 2^x by the SFU alone (ex2.approx.ftz: about 2 ulp, subnormal results
// flushed to 0, 2^-inf = 0).  exp2f adds a range fix-up around the same
// instruction for subnormal results, which a softmax of bf16 data can drop.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Two floats to one register of two bf16 (lo in the low half).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

#define HOPPER_ACC8(d, i)                                                   \
  "+f"(d[i + 0]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64 x 64] (+)= A[64 x 16] * B[64 x 16]^T, both K-major in shared memory.
// Accumulator layout (thread t of the warpgroup, warp w = t / 32, g = t % 32
// / 4, c = t % 4): d[4j + 2x + y] holds row 16w + g + 8x, column 8j + 2c + y.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : HOPPER_ACC8(d, 0), HOPPER_ACC8(d, 8), HOPPER_ACC8(d, 16),
        HOPPER_ACC8(d, 24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// The same with N = 32 (B is 32 x 16).
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : HOPPER_ACC8(d, 0), HOPPER_ACC8(d, 8)
      : "l"(da), "l"(db), "r"(accumulate));
}

// The same with N = 128 (B is 128 x 16).
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : HOPPER_ACC8(d, 0), HOPPER_ACC8(d, 8), HOPPER_ACC8(d, 16),
        HOPPER_ACC8(d, 24), HOPPER_ACC8(d, 32), HOPPER_ACC8(d, 40),
        HOPPER_ACC8(d, 48), HOPPER_ACC8(d, 56)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 64] += A[64 x 16] * B[16 x 64]: A from registers (four registers of
// bf16 pairs in the accumulator layout of columns 16k .. 16k + 15), B
// MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : HOPPER_ACC8(d, 0), HOPPER_ACC8(d, 8), HOPPER_ACC8(d, 16),
        HOPPER_ACC8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The same with N = 128.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : HOPPER_ACC8(d, 0), HOPPER_ACC8(d, 8), HOPPER_ACC8(d, 16),
        HOPPER_ACC8(d, 24), HOPPER_ACC8(d, 32), HOPPER_ACC8(d, 40),
        HOPPER_ACC8(d, 48), HOPPER_ACC8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The same with N = 256 (B spans four 64-column blocks LBO apart).
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
      "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "
      "%122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
      "}\n"
      : HOPPER_ACC8(d, 0), HOPPER_ACC8(d, 8), HOPPER_ACC8(d, 16),
        HOPPER_ACC8(d, 24), HOPPER_ACC8(d, 32), HOPPER_ACC8(d, 40),
        HOPPER_ACC8(d, 48), HOPPER_ACC8(d, 56), HOPPER_ACC8(d, 64),
        HOPPER_ACC8(d, 72), HOPPER_ACC8(d, 80), HOPPER_ACC8(d, 88),
        HOPPER_ACC8(d, 96), HOPPER_ACC8(d, 104), HOPPER_ACC8(d, 112),
        HOPPER_ACC8(d, 120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef HOPPER_ACC8

// acc (+)= A * B for one 16-deep step with A in registers, N = 64, 128 or
// 256.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&acc)[N / 2], const uint32_t* a,
                                         uint64_t db) {
  if constexpr (N == 256)
    wgmma_rs_n256(acc, a, db);
  else if constexpr (N == 128)
    wgmma_rs_n128(acc, a, db);
  else
    wgmma_rs_n64(acc, a, db);
}

// acc (+)= A * B^T for one 16-deep step, both K-major in shared memory,
// N = 32, 64 or 128.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&acc)[N / 2], uint64_t da,
                                         uint64_t db, int accumulate) {
  if constexpr (N == 128)
    wgmma_ss_n128(acc, da, db, accumulate);
  else if constexpr (N == 64)
    wgmma_ss_n64(acc, da, db, accumulate);
  else
    wgmma_ss_n32(acc, da, db, accumulate);
}

// The two bf16 halves of a packed register, widened to float exactly.
__device__ __forceinline__ float bf16_lo(uint32_t r) {
  return __uint_as_float(r << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t r) {
  return __uint_as_float(r & 0xffff0000u);
}

// ---- split TF32 on the tensor cores (mma.sync) ----------------------------
//
// A float32 product at float32-class precision: x = x_hi + x_lo with both
// parts TF32 values (10 explicit mantissa bits), rounded explicitly by
// cvt.rna (to nearest, ties away from zero), and
//   A·B ≈ A_lo·B_hi + A_hi·B_lo + A_hi·B_hi,
// accumulated in float32; A_lo·B_lo (~2^-22 relative) is dropped.  Each
// term of the sum is exact in float32 (two 11-bit significands), so the
// float32 accumulation is the only rounding besides x_lo's (~2^-22).  One
// TF32 product alone errs by ~2^-11 per operand.

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x_lo is rounded by the same rule in two integer operations (add half of
// the dropped bits' weight to the magnitude, clear them): x - x_hi is exact
// and finite for finite x, and a NaN or an infinity in x reaches the sum
// through x_hi, which cvt.rna keeps.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xFFFFE000u;
}

// d[16 x 8] += A[16 x 8] B[8 x 8] in TF32 (one tensor-core instruction).
// Thread t of the warp, g = t / 4, c = t % 4:
//   A: a0 (g, c), a1 (g + 8, c), a2 (g, c + 4), a3 (g + 8, c + 4)
//   B: b0 (k = c, n = g), b1 (k = c + 4, n = g)
//   d: d0 (g, 2c), d1 (g, 2c + 1), d2 (g + 8, 2c), d3 (g + 8, 2c + 1)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of four floats (in a0..a3 order), split.
__device__ __forceinline__ void split_frag(float x0, float x1, float x2,
                                           float x3, uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  split_tf32(x0, hi[0], lo[0]);
  split_tf32(x1, hi[1], lo[1]);
  split_tf32(x2, hi[2], lo[2]);
  split_tf32(x3, hi[3], lo[3]);
}

// ---- split TF32 on wgmma ---------------------------------------------------
//
// Operands written by plain stores in the core-matrix layout, without
// swizzle: an R-row (M or N) by K-column float32 plane is (K / 4) x (R / 8)
// core matrices of 8 rows x 4 columns, 128 contiguous bytes each (element
// (r, k) at byte 16 (r % 8) + 4 (k % 4)), core (k / 4, r / 8) at byte
// 128 ((k / 4) (R / 8) + r / 8).  Both operands are K-major (a tf32 wgmma
// has no transpose), so LBO (the next core along K) = 16 R bytes and SBO
// (the next 8 rows) = 128 bytes; an 8-deep k-step is two cores along K.

__device__ __forceinline__ uint64_t desc_plain(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32);
}

#define HOPPER_ACC8(d, i)                                                   \
  "+f"(d[i + 0]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64 x 16] (+)= A[64 x 8] B[16 x 8]^T in TF32, A from registers (as
// below), B from shared memory.
__device__ __forceinline__ void wgmma_tf32_rs_n16(float (&d)[8],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n"
      "}\n"
      : HOPPER_ACC8(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d[64 x 64] (+)= A[64 x 8] B[64 x 8]^T in TF32, A from registers (the
// fragment of mma.sync m16n8k8 per warp: a0 (g, c), a1 (g + 8, c), a2 (g,
// c + 4), a3 (g + 8, c + 4) of the warp's 16 rows), B from shared memory.
__device__ __forceinline__ void wgmma_tf32_rs_n64(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : HOPPER_ACC8(d, 0), HOPPER_ACC8(d, 8), HOPPER_ACC8(d, 16),
        HOPPER_ACC8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d[64 x 32] (+)= A[64 x 8] B[32 x 8]^T in TF32, both from shared memory
// (K-major planes as above).
__device__ __forceinline__ void wgmma_tf32_ss_n32(float (&d)[16], uint64_t da,
                                                  uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1;\n"
      "}\n"
      : HOPPER_ACC8(d, 0), HOPPER_ACC8(d, 8)
      : "l"(da), "l"(db), "r"(accumulate));
}

// The same with N = 16 (B is 16 x 8).
__device__ __forceinline__ void wgmma_tf32_ss_n16(float (&d)[8], uint64_t da,
                                                  uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n"
      "}\n"
      : HOPPER_ACC8(d, 0)
      : "l"(da), "l"(db), "r"(accumulate));
}

#undef HOPPER_ACC8

// acc (+)= A B^T for one 8-deep TF32 step, both from shared memory, N = 16
// or 32.
template <int N>
__device__ __forceinline__ void wgmma_tf32_ss(float (&acc)[N / 2], uint64_t da,
                                              uint64_t db, int accumulate) {
  if constexpr (N == 32)
    wgmma_tf32_ss_n32(acc, da, db, accumulate);
  else
    wgmma_tf32_ss_n16(acc, da, db, accumulate);
}

// Order this thread's plain shared-memory stores before later reads by
// wgmma (the async proxy); a barrier then publishes them to the warpgroup.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// ---- cp.async ---------------------------------------------------------------

// Copy 16 (or 4) bytes to shared memory; the bytes past src_bytes (0 or
// the whole copy) are filled with zeros, and nothing is read for them.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// ---- named barriers ----------------------------------------------------------

// Barrier `id` (1-15; __syncthreads takes 0) over n threads, a multiple of
// 32: bar_sync waits until n threads have arrived, itself included;
// bar_arrive counts this warp's threads and goes on.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// ---- register reallocation between warpgroups ----------------------------

template <int N>
__device__ __forceinline__ void regs_release() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_claim() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}

}  // namespace hopper

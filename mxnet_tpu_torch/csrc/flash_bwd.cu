// Flash-attention backward for Hopper (sm_90a): K2 (dQ) and K3 (dK, dV),
// two kernels in one library, each in a bfloat16 tensor-core version and a
// float32 CUDA-core version.
//
// Replaces: mxnet_tpu/ops/attention.py::_bwd_dq_kernel (K2) and
// ::_bwd_dkv_kernel (K3), both launched by _flash_backward.  Same function:
// with P recomputed from the forward's logsumexp,
//   P  = exp(scale * Q Kᵀ - lse)            (masked entries 0)
//   dS = P ∘ (dO Vᵀ - Δ) · scale,  Δ = rowsum(dO ∘ O)  (given, float32)
//   dQ = dS K     (K2)       dK = dSᵀ Q,  dV = Pᵀ dO     (K3)
//
//   q, dO   [b, sq, h, d]   read through their strides (unit stride in d)
//   k, v    [b, sk, h, d]   read through their strides (unit stride in d)
//   lse, Δ  [b*h, sq]       contiguous float32; lse is a natural log
//   dq      [b, sq, h, d]   contiguous, the input dtype
//   dk, dv  [b, sk, h, d]   contiguous, the input dtype
//   d       64 or 128
//
// Both versions keep the split of the TPU kernels: one thread block owns
// one output tile and loops over the other axis inside the block (the TPU
// carries the accumulator across a sequential grid axis instead), so there
// are no atomics and the result is the same bits on every run.  S and dP
// are computed in both kernels: 14·d operations per visible (query, key)
// pair against the 10·d of a fused backward.  Causal mode is top-left
// aligned (query i sees keys j <= i, also when sq != sk); tiles wholly above
// the diagonal are skipped and only tiles that cross it, or the ragged end
// of either sequence, are masked; keys past sk and queries past sq get
// P = dS = 0, and a key tile that no query sees writes dK = dV = 0.  Scores
// live in the base-2 domain (scale * log2(e) folded into one FMA with
// lse * log2(e) subtracted, exp2f).  The heaviest causal tiles are
// scheduled first.
//
// bfloat16: the tensor cores (the main path; `Module` trains in bf16).
//   K3 runs one block of 384 threads per (b*h, 128-key tile): warpgroups 0
//   and 1 each own 64 of the keys, and one warp of warpgroup 2 feeds them.
//   That producer loads the K and V tiles once with TMA, then streams
//   64-query tiles of Q and dO through a ring of kStages shared-memory slots
//   guarded by mbarriers (a "full" barrier per slot, on which TMA counts its
//   bytes, and an "empty" one on which every consumer warp arrives when the
//   products reading the slot are done); its 32 lanes also stage the tile's
//   lse * log2(e) and Δ in the slot.  Per tile each consumer warpgroup
//   computes Sᵀ = K Qᵀ and dPᵀ = V dOᵀ with wgmma (both operands K-major
//   in shared memory), forms Pᵀ and dSᵀ in float32 registers, rounds them to
//   bf16 (where the JAX kernels round P and dS), and feeds them straight
//   from the accumulator registers as the A operand of dV += Pᵀ dO and
//   dK += dSᵀ Q, with dO and Q read MN-major through the transpose bit:
//   P never returns to shared memory, which is why the kernel computes the
//   transposes.  dK and dV stay in float32 registers and are rounded once.
//   K2 mirrors it per (b*h, 128-query tile): Q, dO and the rows' lse and Δ
//   are loaded once, K and V stream, S = Q Kᵀ and dP = dO Vᵀ, and dS feeds
//   dQ += dS K (K MN-major).  All tiles arrive by TMA with the 128-byte
//   swizzle that the wgmma descriptors read (hopper.cuh); TMA fills rows
//   past the end of a sequence with zeros, and those rows are masked
//   explicitly (a zero score is not a masked score).  The producer
//   warpgroup gives up registers (setmaxnreg 24) so that each consumer
//   thread can hold 240: K3 at d=128 keeps two 64 x 128 float32
//   accumulators (128 registers) and the two 64 x 64 score tiles (64).
//   What bounds it: operations.  At b=4, s=4096, h=16, d=128 causal the
//   pair does 14·d operations per visible pair, ~0.96 TFLOP, 0.97 ms at the
//   989 TFLOP/s bf16 dense peak, while its bytes take ~0.1 ms at 3.35 TB/s.
//   Left on the table: overlap of one tile's products with the next tile's
//   (each warpgroup waits for its own wgmma groups; the two warpgroups
//   interleave only as the scheduler lets them), a fused 10·d kernel with
//   dQ by atomics, fp8.
//
// float32: the CUDA cores (TF32 would break the float32 contract).  K2: one
//   block (256 threads, 16 x 16) per (b*h, 64-row query tile); its Q and dO
//   tiles are staged once, and a loop walks the 64-row K/V tiles up to the
//   causal diagonal.  K3: one block per (b*h, 64-row key tile); its K and V
//   tiles are staged once, and a loop walks the query tiles from the
//   diagonal down.  Each iteration recomputes the 64 x 64 score tile S and
//   dP = dO Vᵀ (K3 computes their transposes, so the rows it owns are
//   keys), forms P and dS in registers, writes them to shared memory and
//   adds the tile's contribution to the float32 accumulators held in
//   registers.  Thread (ty, tx) owns score rows ty + 16a and columns
//   tx + 16b (a, b < 4) and accumulator rows ty + 16a, columns
//   64g + 4tx .. 64g + 4tx + 3.  All tiles are staged row-major at a row
//   stride of d + 4 floats, so every product reads 16-byte vectors: an
//   operand row shared by a quarter-warp is a broadcast, and eight
//   different rows at that stride fall in eight different bank groups
//   (d/4 + 1 is odd).  What bounds it: the 67 TFLOP/s float32 peak, and
//   inside the SM shared memory (a score tile step issues eight 16-byte
//   loads per 64 FMAs), with one block of 8 warps per SM that waits at a
//   barrier while the next tile is staged.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

// ===========================================================================
// bfloat16: tensor cores
// ===========================================================================

constexpr int kRes = 128;  // resident rows per block: 2 consumer warpgroups
constexpr int kStr = 64;   // streamed rows per tile
constexpr int kStages = 3;
constexpr int kTcThreads = 384;  // warpgroups 0, 1 consume; 2 loads

// Shared memory, in bytes from a 1024-aligned base: the two resident
// tensors, kStages slots of the two streamed tensors, kStages x 128 floats
// of per-query lse * log2(e) and Δ (K3), the barriers.
template <int D>
struct TcSmem {
  static constexpr int kResBytes = D / 64 * kRes * 128;
  static constexpr int kStrBytes = D / 64 * kStr * 128;
  static constexpr int kRes1 = kResBytes;
  static constexpr int kStr0 = 2 * kResBytes;
  static constexpr int kRows = kStr0 + kStages * 2 * kStrBytes;
  static constexpr int kBars = kRows + kStages * 2 * kStr * 4;
  static constexpr int kBytes = kBars + (2 * kStages + 1) * 8;
  static constexpr int kAlloc = kBytes + 1024;
};

// The body of both kernels.  Resident tensors r0, r1 (kRes rows of the
// block, loaded once) and streamed tensors t0, t1 (kStr rows per tile):
//   K3 (kDKV): r0 = K, r1 = V, t0 = Q, t1 = dO; out0 = dK, out1 = dV
//   K2:        r0 = Q, r1 = dO, t0 = K, t1 = V; out0 = dQ
template <int D, bool kDKV>
__device__ __forceinline__ void bwd_tc(
    const CUtensorMap* map_r0, const CUtensorMap* map_r1,
    const CUtensorMap* map_t0, const CUtensorMap* map_t1,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ out0, __nv_bfloat16* __restrict__ out1,
    int h, int sq, int sk, float scale, float scale_log2, int causal) {
  using L = TcSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm =
      smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* res_bar = empty + kStages;

  const int bh = blockIdx.x;
  const int bi = bh / h;
  const int hi = bh % h;
  const int s_res = kDKV ? sk : sq;  // rows of the resident (output) side
  // K3: the heaviest causal tiles (first keys) have the lowest index;
  // K2: the heaviest (last queries) are scheduled first
  const int r_begin = kRes * (kDKV ? blockIdx.y : gridDim.y - 1 - blockIdx.y);
  int t_begin = 0, t_end;
  if (kDKV) {
    t_begin = causal ? r_begin : 0;  // queries before k0 see none of the keys
    t_end = sq;
  } else {
    t_end = causal ? min(sk, r_begin + kRes) : sk;
  }
  const int n_tiles = t_end > t_begin ? (t_end - t_begin + kStr - 1) / kStr : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], kDKV ? 32 : 1);
      hopper::mbar_init(&empty[s], 8);  // each consumer warp
    }
    hopper::mbar_init(res_bar, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one warp issues the TMA loads ----
    hopper::regs_release<24>();
    const int lane = threadIdx.x % 128;
    if (lane >= 32 || (!kDKV && lane > 0)) return;
    if (lane == 0) {
      hopper::mbar_arrive_expect_tx(res_bar, 2 * L::kResBytes);
      for (int c = 0; c < D / 64; ++c) {
        hopper::tma_load_4d(sm + c * kRes * 128, map_r0, res_bar, 64 * c, hi,
                            r_begin, bi);
        hopper::tma_load_4d(sm + L::kRes1 + c * kRes * 128, map_r1, res_bar,
                            64 * c, hi, r_begin, bi);
      }
    }
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      const int t0 = t_begin + t * kStr;
      hopper::mbar_wait(&empty[s], ((t / kStages) & 1) ^ 1);
      if (kDKV) {
        float* rows = reinterpret_cast<float*>(sm + L::kRows) + s * 2 * kStr;
        for (int i = lane; i < kStr; i += 32) {
          const int q = t0 + i;
          const bool ok = q < sq;
          rows[i] = ok ? lse[(int64_t)bh * sq + q] * kLog2e : 0.f;
          rows[kStr + i] = ok ? delta[(int64_t)bh * sq + q] : 0.f;
        }
      }
      if (lane == 0) {
        uint8_t* slot = sm + L::kStr0 + s * 2 * L::kStrBytes;
        hopper::mbar_arrive_expect_tx(&full[s], 2 * L::kStrBytes);
        for (int c = 0; c < D / 64; ++c) {
          hopper::tma_load_4d(slot + c * kStr * 128, map_t0, &full[s], 64 * c,
                              hi, t0, bi);
          hopper::tma_load_4d(slot + L::kStrBytes + c * kStr * 128, map_t1,
                              &full[s], 64 * c, hi, t0, bi);
        }
      } else {
        hopper::mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns resident rows rw .. rw + 63 ----
  hopper::regs_claim<240>();
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int c4 = lane % 4;
  const int rw = r_begin + 64 * wg;
  const bool live = rw < s_res;  // else no row of this warpgroup exists

  float acc0[D / 2];
  float acc1[kDKV ? D / 2 : 1];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc0[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (kDKV ? D / 2 : 1); ++i) acc1[i] = 0.f;

  // K2: lse * log2(e) and Δ of this thread's two query rows
  float lse2[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
  if (!kDKV) {
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int q = rw + 16 * warp + g + 8 * x;
      if (q < sq) {
        lse2[x] = lse[(int64_t)bh * sq + q] * kLog2e;
        dl[x] = delta[(int64_t)bh * sq + q];
      }
    }
  }

  // descriptors of this warpgroup's 64 resident rows (K-major); the step
  // offsets below are added in 16-byte units
  const uint64_t da0 = hopper::desc_sw128(
      hopper::smem_addr(sm) + 64 * wg * 128, 16, 1024);
  const uint64_t da1 = hopper::desc_sw128(
      hopper::smem_addr(sm + L::kRes1) + 64 * wg * 128, 16, 1024);

  hopper::mbar_wait(res_bar, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    const int t0 = t_begin + t * kStr;
    hopper::mbar_wait(&full[s], (t / kStages) & 1);
    bool skip, masked;
    if (kDKV) {  // rows are keys rw.., columns queries t0..
      skip = !live || (causal && t0 + kStr <= rw);
      masked = (causal && t0 < rw + 64) || t0 + kStr > sq;
    } else {  // rows are queries rw.., columns keys t0..
      skip = !live || (causal && t0 >= rw + 64);
      masked = (causal && t0 + kStr > rw) || t0 + kStr > sk;
    }
    if (!skip) {
      const uint32_t slot = hopper::smem_addr(sm + L::kStr0 + s * 2 * L::kStrBytes);
      const uint64_t db0 = hopper::desc_sw128(slot, 16, 1024);
      const uint64_t db1 = hopper::desc_sw128(slot + L::kStrBytes, 16, 1024);

      // S (K3: Sᵀ) and dP (K3: dPᵀ), 64 x 64, reduced over d
      float sc[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
      hopper::fence_regs(sc);
      hopper::fence_regs(dp);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t oa = ((kk / 4) * kRes * 128 + (kk % 4) * 32) >> 4;
        const uint32_t ob = ((kk / 4) * kStr * 128 + (kk % 4) * 32) >> 4;
        hopper::wgmma_ss_n64(sc, da0 + oa, db0 + ob, kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t oa = ((kk / 4) * kRes * 128 + (kk % 4) * 32) >> 4;
        const uint32_t ob = ((kk / 4) * kStr * 128 + (kk % 4) * 32) >> 4;
        hopper::wgmma_ss_n64(dp, da1 + oa, db1 + ob, kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(sc);
      hopper::fence_regs(dp);

      // P and dS (without the scale, applied to the sums at the end);
      // element i of a score tile: row 16 warp + g + 8 ((i >> 1) & 1),
      // column 8 (i >> 2) + 2 c4 + (i & 1)
      const float* rows =
          reinterpret_cast<const float*>(sm + L::kRows) + s * 2 * kStr;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 8 * j + 2 * c4;
        float2 cl = make_float2(0.f, 0.f), cd = make_float2(0.f, 0.f);
        if (kDKV) {
          cl = *reinterpret_cast<const float2*>(rows + col);
          cd = *reinterpret_cast<const float2*>(rows + kStr + col);
        }
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int row = rw + 16 * warp + g + 8 * x;
#pragma unroll
          for (int y = 0; y < 2; ++y) {
            const int i = 4 * j + 2 * x + y;
            const int cidx = t0 + col + y;
            const float l = kDKV ? (y ? cl.y : cl.x) : lse2[x];
            const float dd = kDKV ? (y ? cd.y : cd.x) : dl[x];
            float p = exp2f(fmaf(sc[i], scale_log2, -l));
            if (masked) {
              // K3: query cidx, key row; K2: query row, key cidx
              const bool visible =
                  kDKV ? (cidx < sq && (!causal || cidx >= row))
                       : (cidx < sk && (!causal || cidx <= row));
              if (!visible) p = 0.f;
            }
            sc[i] = p;
            dp[i] = p * (dp[i] - dd);
          }
        }
      }
      // rounded to bf16: the accumulator layout of columns 16k .. 16k + 15
      // is the A-operand layout of reduction step k
      uint32_t pf[16], dsf[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        pf[i] = hopper::pack_bf16(sc[2 * i], sc[2 * i + 1]);
        dsf[i] = hopper::pack_bf16(dp[2 * i], dp[2 * i + 1]);
      }

      // the streamed tiles as MN-major B: 16 rows per step, 64-column
      // blocks kStr * 128 bytes apart
      const uint64_t mb0 = hopper::desc_sw128(slot, kStr * 128, 1024);
      const uint64_t mb1 = hopper::desc_sw128(slot + L::kStrBytes, kStr * 128, 1024);
      hopper::fence_regs(acc0);
      hopper::fence_regs(acc1);
      hopper::fence_regs(pf);
      hopper::fence_regs(dsf);
      hopper::wgmma_fence();
      if constexpr (kDKV) {
#pragma unroll
        for (int kk = 0; kk < kStr / 16; ++kk)
          hopper::wgmma_rs<D>(acc1, &pf[4 * kk], mb1 + ((kk * 2048) >> 4));  // dV += Pᵀ dO
      }
#pragma unroll
      for (int kk = 0; kk < kStr / 16; ++kk)
        hopper::wgmma_rs<D>(acc0, &dsf[4 * kk], mb0 + ((kk * 2048) >> 4));  // dK += dSᵀ Q; dQ += dS K
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(acc0);
      hopper::fence_regs(acc1);
      hopper::fence_regs(pf);
      hopper::fence_regs(dsf);
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
  }

  if (!live) return;
  // rows 16 warp + g + 8x of the warpgroup, columns 8j + 2 c4 (+1): the
  // accumulator layout, stored as bf16 pairs
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int row = rw + 16 * warp + g + 8 * x;
    if (row >= s_res) continue;
    const int64_t off = (((int64_t)bi * s_res + row) * h + hi) * D + 2 * c4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(out0 + off + 8 * j) = hopper::pack_bf16(
          acc0[4 * j + 2 * x] * scale, acc0[4 * j + 2 * x + 1] * scale);
      if constexpr (kDKV)
        *reinterpret_cast<uint32_t*>(out1 + off + 8 * j) =
            hopper::pack_bf16(acc1[4 * j + 2 * x], acc1[4 * j + 2 * x + 1]);
    }
  }
}

// K2, bf16: dQ for one (b*h, 128-query tile).
template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_do,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dq, int h, int sq, int sk,
                       float scale, float scale_log2, int causal) {
  bwd_tc<D, false>(&map_q, &map_do, &map_k, &map_v, lse, delta, dq, nullptr,
                   h, sq, sk, scale, scale_log2, causal);
}

// K3, bf16: dK and dV for one (b*h, 128-key tile).
template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_dkv_tc_kernel(const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_do,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dk,
                        __nv_bfloat16* __restrict__ dv, int h, int sq, int sk,
                        float scale, float scale_log2, int causal) {
  bwd_tc<D, true>(&map_k, &map_v, &map_q, &map_do, lse, delta, dk, dv, h, sq,
                  sk, scale, scale_log2, causal);
}

// strides: q, k, v, dO, each (b, s, h), in elements.  The resident tensors'
// maps take boxes of kRes rows, the streamed ones kStr.
template <int D, bool kDKV>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* out0, void* out1, int b, int h, int sq, int sk,
                      const int64_t* st, float scale, int causal,
                      cudaStream_t stream) {
  if (kDKV && sq == 0) {  // no query: dK = dV = 0
    const size_t bytes = (size_t)b * sk * h * D * sizeof(__nv_bfloat16);
    cudaError_t err = cudaMemsetAsync(out0, 0, bytes, stream);
    if (err == cudaSuccess) err = cudaMemsetAsync(out1, 0, bytes, stream);
    return err;
  }
  const int q_rows = kDKV ? kStr : kRes;
  const int kv_rows = kDKV ? kRes : kStr;
  CUtensorMap mq, mk, mv, mo;
  if (!hopper::encode_bshd_bf16(&mq, q, b, sq, h, D, st[0], st[1], st[2], q_rows) ||
      !hopper::encode_bshd_bf16(&mk, k, b, sk, h, D, st[3], st[4], st[5], kv_rows) ||
      !hopper::encode_bshd_bf16(&mv, v, b, sk, h, D, st[6], st[7], st[8], kv_rows) ||
      !hopper::encode_bshd_bf16(&mo, dout, b, sq, h, D, st[9], st[10], st[11], q_rows))
    return cudaErrorInvalidValue;
  const int smem = TcSmem<D>::kAlloc;
  const dim3 grid(b * h, ((kDKV ? sk : sq) + kRes - 1) / kRes);
  const float scale_log2 = scale * kLog2e;
  cudaError_t err;
  if (kDKV) {
    err = cudaFuncSetAttribute(flash_bwd_dkv_tc_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    flash_bwd_dkv_tc_kernel<D><<<grid, kTcThreads, smem, stream>>>(
        mk, mv, mq, mo, lse, delta, static_cast<__nv_bfloat16*>(out0),
        static_cast<__nv_bfloat16*>(out1), h, sq, sk, scale, scale_log2,
        causal);
  } else {
    err = cudaFuncSetAttribute(flash_bwd_dq_tc_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    flash_bwd_dq_tc_kernel<D><<<grid, kTcThreads, smem, stream>>>(
        mq, mo, mk, mv, lse, delta, static_cast<__nv_bfloat16*>(out0), h, sq,
        sk, scale, scale_log2, causal);
  }
  return cudaGetLastError();
}

// ===========================================================================
// float32: CUDA cores
// ===========================================================================

constexpr int kB = 64;           // query rows and key rows per tile
constexpr int kThreads = 256;    // 16 x 16 threads
constexpr int kPS = kB + 4;      // row stride of the P / dS tiles

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// dst[r * (D + 4) + c] = src[(row0 + r) * ss + c] for r < 64, c < D; rows
// at or past nrows are zero.  Consecutive threads read consecutive columns.
template <int D>
__device__ __forceinline__ void stage(float* dst, const float* src, int64_t ss,
                                      int row0, int nrows) {
  for (int e = threadIdx.x; e < kB * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const int row = row0 + r;
    dst[r * (D + 4) + c] = row < nrows ? src[row * ss + c] : 0.f;
  }
}

// acc[a][b] = sum_d A[ty + 16a][d] * B[tx + 16b][d]; A and B are row-major
// 64 x D tiles at row stride D + 4.
template <int D>
__device__ __forceinline__ void tile_abt(float acc[4][4], const float* A,
                                         const float* B, int ty, int tx) {
  constexpr int S = D + 4;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) av[a] = ld4(&A[(ty + 16 * a) * S + d]);
#pragma unroll
    for (int b = 0; b < 4; ++b) bv[b] = ld4(&B[(tx + 16 * b) * S + d]);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        float t = acc[a][b];
        t = fmaf(av[a].x, bv[b].x, t);
        t = fmaf(av[a].y, bv[b].y, t);
        t = fmaf(av[a].z, bv[b].z, t);
        t = fmaf(av[a].w, bv[b].w, t);
        acc[a][b] = t;
      }
  }
}

// acc[a][4g + c] += sum_k P[ty + 16a][k] * B[k][64g + 4tx + c]; P is a
// 64 x 64 tile at row stride kPS, B a row-major 64 x D tile at stride D + 4.
template <int D>
__device__ __forceinline__ void tile_ab(float acc[4][D / 16], const float* P,
                                        const float* B, int ty, int tx) {
  constexpr int S = D + 4;
  constexpr int kG = D / 64;
#pragma unroll 2
  for (int k = 0; k < kB; k += 4) {
    float p[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float4 t = ld4(&P[(ty + 16 * a) * kPS + k]);
      p[a][0] = t.x;
      p[a][1] = t.y;
      p[a][2] = t.z;
      p[a][3] = t.w;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        const float4 w = ld4(&B[(k + kk) * S + 64 * g + 4 * tx]);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          acc[a][4 * g + 0] = fmaf(p[a][kk], w.x, acc[a][4 * g + 0]);
          acc[a][4 * g + 1] = fmaf(p[a][kk], w.y, acc[a][4 * g + 1]);
          acc[a][4 * g + 2] = fmaf(p[a][kk], w.z, acc[a][4 * g + 2]);
          acc[a][4 * g + 3] = fmaf(p[a][kk], w.w, acc[a][4 * g + 3]);
        }
      }
  }
}

// Rows ty + 16a of a [b, s, h, D] contiguous gradient, columns 64g + 4tx + c.
template <int D>
__device__ __forceinline__ void write_rows(float* out, float acc[4][D / 16],
                                           int bi, int hi, int h, int s,
                                           int row0, int ty, int tx) {
  constexpr int kG = D / 64;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = row0 + ty + 16 * a;
    if (row >= s) continue;
    float* orow = out + ((int64_t)(bi * (int64_t)s + row) * h + hi) * D;
#pragma unroll
    for (int g = 0; g < kG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) orow[64 * g + 4 * tx + c] = acc[a][4 * g + c];
  }
}

struct Strides {  // in elements: batch, sequence, head
  int64_t q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_s, o_h;
};

template <int D>
constexpr size_t dq_smem_bytes() {
  // Q, dO, K, V tiles [kB][D + 4], the dS tile [kB][kPS]
  return sizeof(float) * (4 * kB * (D + 4) + kB * kPS);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  // K, V, Q, dO tiles [kB][D + 4], the P and dS tiles [kB][kPS], lse and Δ
  return sizeof(float) * (4 * kB * (D + 4) + 2 * kB * kPS + 2 * kB);
}

// K2, float32: dQ for one (b*h, 64-row query tile).
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int h, int sq, int sk, Strides st, float scale,
                    float scale_log2, int causal) {
  constexpr int S = D + 4;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kB][S]
  float* dos = qs + kB * S;                      // [kB][S]
  float* ks = dos + kB * S;                      // [kB][S]
  float* vs = ks + kB * S;                       // [kB][S]
  float* dss = vs + kB * S;                      // [kB][kPS]

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int bh = blockIdx.x;
  const int bi = bh / h;
  const int hi = bh % h;
  // the heaviest causal tiles (last rows) are scheduled first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kB;

  const float* qb = q + bi * st.q_b + hi * st.q_h;
  const float* kb = k + bi * st.k_b + hi * st.k_h;
  const float* vb = v + bi * st.v_b + hi * st.v_h;
  const float* ob = dout + bi * st.o_b + hi * st.o_h;

  stage<D>(qs, qb, st.q_s, q0, sq);
  stage<D>(dos, ob, st.o_s, q0, sq);

  float lse2[4], dl[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q0 + ty + 16 * a;
    const bool ok = row < sq;
    lse2[a] = ok ? lse[(int64_t)bh * sq + row] * kLog2e : 0.f;
    dl[a] = ok ? delta[(int64_t)bh * sq + row] : 0.f;
  }

  float acc[4][D / 16];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[a][c] = 0.f;

  const int k_end = causal ? min(sk, q0 + kB) : sk;
  for (int k0 = 0; k0 < k_end; k0 += kB) {
    __syncthreads();  // the previous tile's K and dS reads are done
    stage<D>(ks, kb, st.k_s, k0, sk);
    stage<D>(vs, vb, st.v_s, k0, sk);
    __syncthreads();  // Q, dO (first tile), K and V staged

    float s[4][4], dp[4][4];
    tile_abt<D>(s, qs, ks, ty, tx);
    tile_abt<D>(dp, dos, vs, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int row = q0 + ty + 16 * a;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int col = k0 + tx + 16 * b;
        const bool visible = row < sq && col < sk && (!causal || row >= col);
        const float p = visible ? exp2f(s[a][b] * scale_log2 - lse2[a]) : 0.f;
        dss[(ty + 16 * a) * kPS + tx + 16 * b] = p * (dp[a][b] - dl[a]) * scale;
      }
    }
    __syncthreads();  // dS written
    tile_ab<D>(acc, dss, ks, ty, tx);
  }
  write_rows<D>(dq, acc, bi, hi, h, sq, q0, ty, tx);
}

// K3, float32: dK and dV for one (b*h, 64-row key tile).
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int h, int sq, int sk, Strides st,
                     float scale, float scale_log2, int causal) {
  constexpr int S = D + 4;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [kB][S]
  float* vs = ks + kB * S;                       // [kB][S]
  float* qs = vs + kB * S;                       // [kB][S]
  float* dos = qs + kB * S;                      // [kB][S]
  float* pts = dos + kB * S;                     // Pᵀ [kB][kPS]
  float* dsts = pts + kB * kPS;                  // dSᵀ [kB][kPS]
  float* lse2s = dsts + kB * kPS;                // [kB]
  float* dls = lse2s + kB;                       // [kB]

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int bh = blockIdx.x;
  const int bi = bh / h;
  const int hi = bh % h;
  // the heaviest causal tiles (first keys) have the lowest index
  const int k0 = blockIdx.y * kB;

  const float* qb = q + bi * st.q_b + hi * st.q_h;
  const float* kb = k + bi * st.k_b + hi * st.k_h;
  const float* vb = v + bi * st.v_b + hi * st.v_h;
  const float* ob = dout + bi * st.o_b + hi * st.o_h;

  stage<D>(ks, kb, st.k_s, k0, sk);
  stage<D>(vs, vb, st.v_s, k0, sk);

  float dka[4][D / 16], dva[4][D / 16];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      dka[a][c] = 0.f;
      dva[a][c] = 0.f;
    }

  // queries before k0 see none of this tile's keys
  const int i_begin = causal ? k0 : 0;
  for (int i0 = i_begin; i0 < sq; i0 += kB) {
    __syncthreads();  // the previous tile's Q, dO, Pᵀ and dSᵀ reads are done
    stage<D>(qs, qb, st.q_s, i0, sq);
    stage<D>(dos, ob, st.o_s, i0, sq);
    if (tid < kB) {
      const int row = i0 + tid;
      const bool ok = row < sq;
      lse2s[tid] = ok ? lse[(int64_t)bh * sq + row] * kLog2e : 0.f;
      dls[tid] = ok ? delta[(int64_t)bh * sq + row] : 0.f;
    }
    __syncthreads();  // K, V (first tile), Q, dO, lse and Δ staged

    float st_[4][4], dpt[4][4];
    tile_abt<D>(st_, ks, qs, ty, tx);   // Sᵀ: rows are keys, columns queries
    tile_abt<D>(dpt, vs, dos, ty, tx);  // dPᵀ
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int col = k0 + ty + 16 * a;  // key
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int r = tx + 16 * b;
        const int row = i0 + r;  // query
        const bool visible = row < sq && col < sk && (!causal || row >= col);
        const float p = visible ? exp2f(st_[a][b] * scale_log2 - lse2s[r]) : 0.f;
        pts[(ty + 16 * a) * kPS + r] = p;
        dsts[(ty + 16 * a) * kPS + r] = p * (dpt[a][b] - dls[r]) * scale;
      }
    }
    __syncthreads();  // Pᵀ and dSᵀ written
    tile_ab<D>(dva, pts, dos, ty, tx);
    tile_ab<D>(dka, dsts, qs, ty, tx);
  }
  write_rows<D>(dk, dka, bi, hi, h, sk, k0, ty, tx);
  write_rows<D>(dv, dva, bi, hi, h, sk, k0, ty, tx);
}

Strides unpack(const int64_t* s) {
  return Strides{s[0], s[1], s[2], s[3], s[4],  s[5],
                 s[6], s[7], s[8], s[9], s[10], s[11]};
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, int b, int h, int sq, int sk,
                      const int64_t* strides, float scale, int causal,
                      cudaStream_t stream) {
  const size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(b * h, (sq + kB - 1) / kB);
  flash_bwd_dq_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, static_cast<float*>(dq), h, sq, sk, unpack(strides), scale,
      scale * kLog2e, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       void* dk, void* dv, int b, int h, int sq, int sk,
                       const int64_t* strides, float scale, int causal,
                       cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(b * h, (sk + kB - 1) / kB);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, static_cast<float*>(dk), static_cast<float*>(dv), h, sq, sk,
      unpack(strides), scale, scale * kLog2e, causal);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores; every view
// needs a 16-byte aligned base and (b, s, h) strides that are multiples of
// 8 elements, or the entry returns cudaErrorInvalidValue).  strides: q, k,
// v, dO, each (b, s, h), in elements (12 values, host memory).  scale is the
// softmax scale (not yet multiplied by log2(e)).  Each entry launches on
// `stream` without synchronising and returns cudaGetLastError() of the
// launch (0 on success).
extern "C" int mxtt_flash_bwd_dq(int dtype, int d, const void* q,
                                 const void* k, const void* v,
                                 const void* dout, const float* lse,
                                 const float* delta, void* dq, int b, int h,
                                 int sq, int sk, const int64_t* strides,
                                 float scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && d == 64)
    return (int)launch_dq<64>(q, k, v, dout, lse, delta, dq, b, h, sq, sk, strides, scale, causal, s);
  if (dtype == 0 && d == 128)
    return (int)launch_dq<128>(q, k, v, dout, lse, delta, dq, b, h, sq, sk, strides, scale, causal, s);
  if (dtype == 1 && d == 64)
    return (int)launch_tc<64, false>(q, k, v, dout, lse, delta, dq, nullptr, b, h, sq, sk, strides, scale, causal, s);
  if (dtype == 1 && d == 128)
    return (int)launch_tc<128, false>(q, k, v, dout, lse, delta, dq, nullptr, b, h, sq, sk, strides, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int mxtt_flash_bwd_dkv(int dtype, int d, const void* q,
                                  const void* k, const void* v,
                                  const void* dout, const float* lse,
                                  const float* delta, void* dk, void* dv,
                                  int b, int h, int sq, int sk,
                                  const int64_t* strides, float scale,
                                  int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && d == 64)
    return (int)launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, b, h, sq, sk, strides, scale, causal, s);
  if (dtype == 0 && d == 128)
    return (int)launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, b, h, sq, sk, strides, scale, causal, s);
  if (dtype == 1 && d == 64)
    return (int)launch_tc<64, true>(q, k, v, dout, lse, delta, dk, dv, b, h, sq, sk, strides, scale, causal, s);
  if (dtype == 1 && d == 128)
    return (int)launch_tc<128, true>(q, k, v, dout, lse, delta, dk, dv, b, h, sq, sk, strides, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

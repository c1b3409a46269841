// Flash-attention backward for Hopper (sm_90a): K2 (dQ) and K3 (dK, dV),
// two kernels in one library, each in a bfloat16 version (wgmma fed by TMA)
// and a float32 version (split TF32, fed by cp.async; wgmma at the widths
// 64 and 128, mma.sync at 256), both on the tensor cores.
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
//   d       32, 64, 96, 128 or 256
//
// Head dims: each kernel is instantiated at the widths D = 64, 128 and 256
// and takes the real d as an argument; d = 32 runs at D = 64 and d = 96 at
// D = 128 with the columns past d zero in shared memory (TMA fills them in
// bf16, cp.async's zero fill in float32) and the stores masked to d columns.
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
//   At D=256 the ring has one slot (the two resident 128-row tiles take
//   128 KB, one slot of two 64-row tiles 64 KB), and K3's two m64n256
//   accumulators (256 registers) do not fit beside the score tiles, so K3
//   runs as two launches: dV (Sᵀ and Pᵀ dO only) and then dK (Sᵀ, dPᵀ and
//   dSᵀ Q), 5 products where the fused K3 does 4.
//   What bounds it: operations.  At b=4, s=4096, h=16, d=128 causal the
//   pair does 14·d operations per visible pair, ~0.96 TFLOP, 0.97 ms at the
//   989 TFLOP/s bf16 dense peak, while its bytes take ~0.1 ms at 3.35 TB/s.
//   Left on the table: overlap of one tile's products with the next tile's
//   (each warpgroup waits for its own wgmma groups; the two warpgroups
//   interleave only as the scheduler lets them), a fused 10·d kernel with
//   dQ by atomics, fp8.
//
// float32: the tensor cores, by the split-TF32 product (hopper.cuh), the
//   route of the yardstick too: PyTorch's memory-efficient attention runs
//   float32 as OpMultiplyAddFastF32 on m16n8k8.  One TF32 product (~2^-11
//   relative per operand) would break the float32 contract; the three-term
//   split (x = x_hi + x_lo, both rounded to TF32 to nearest, ties away;
//   A_lo B_hi + A_hi B_lo + A_hi B_hi accumulated in float32, A_lo B_lo
//   dropped) errs by ~2^-21 to 2^-23, the class of a float32 sum.  Every
//   product of K2 (S, dP, dQ) and K3 (Sᵀ, dPᵀ, dV, dK) takes it; exp2 of
//   the scores against lse * log2(e), the masks, Δ and the scale stay
//   float32 on the CUDA cores.  The tensor cores' float32 accumulation
//   truncates, so no accumulator chains more than 12 products: each chunk
//   sums in a zeroed register set that a float32 add (rounding to nearest)
//   carries into the running sum.  Without that the error grew to several
//   times the plain version's already at a few hundred keys.
//   Widths 64 and 128 (256 threads): the bf16 kernels' split (resident r0,
//   r1; streamed t0, t1) with two warpgroups over 128 resident rows, kept
//   raw, and 16-row streamed tiles.  All threads land a tile by cp.async
//   (16-byte copies when every base and stride allows, else 4-byte ones,
//   so any view with unit stride in d runs; zero fill past the sequence and
//   past d) and split it once into hi and lo planes of two K-major copies
//   (a tf32 wgmma reads shared memory K-major only): natural (rows = the
//   tile's rows, K = d) for S and dP, transposed (rows = d, K = the tile's
//   rows) for dV, dK and dQ.  Every product runs on wgmma with A from
//   registers: S and dP as m64n16k8 with the resident rows' fragments split
//   per 8-column step (two steps' fragments alternate, so one step's split
//   overlaps the other's products); P and dS form in the accumulator
//   registers and feed dV += Pᵀ dO, dK += dSᵀ Q and dQ += dS K as
//   m64n64k8, two 64-column parts in flight.  The registers of an
//   accumulator read as an A fragment put columns 2c, 2c + 1 in k-slots c,
//   c + 4; both copies store their K in that order.
//   Why the resident rows are split per tile: as a wgmma operand in shared
//   memory their hi and lo would take 2 x 2 x 128 x 128 floats, 256 KB of
//   the 227.  The split of the A fragments, 8 elements per thread and step,
//   sets the pace of S and dP.
//   Budget (shared memory; registers per thread from ptxas): D=64 115,456
//   B; D=128 221,952 B (resident 139,264, planes 65,536, raw tile 16,896);
//   K3 at 128 holds dK and dV (64 + 64), two parts (32 + 32), the P and dS
//   fragments (32) and, in S and dP, two steps' A fragments (32).
//   Width 256 (128 threads): mma.sync for every product.  Four warps own 64
//   resident rows (266 KB for 128); one slot of 16-row tiles, each split
//   into row-major hi and lo planes at a stride of D + 4 floats; K3 runs as
//   two launches, dV then dK (two 64 x 256 accumulators do not fit beside
//   the score tiles).  199,808 B of shared memory.
//   What bounds it: operations, three tensor-core products per product:
//   3 x 14·d per visible pair over 495 TFLOP/s (TF32 dense), at b=4,
//   s=4096, h=16, d=128 causal 2.4996 ms (K2) and 3.3326 ms (K3).  S and
//   dP (N = 16) run well below wgmma's rate at larger N, and take most of
//   the time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "tf32.cuh"

namespace {

// View, make_views, stage_async, kChunkK, mma3, split_natural,
// split_transposed, score_wg, issue_part, add_part
using namespace tf32;

constexpr float kLog2e = 1.4426950408889634f;

// ===========================================================================
// bfloat16: tensor cores
// ===========================================================================

constexpr int kRes = 128;  // resident rows per block: 2 consumer warpgroups
constexpr int kStr = 64;   // streamed rows per tile
constexpr int kTcThreads = 384;  // warpgroups 0, 1 consume; 2 loads

// What K3 accumulates in one launch (K2 always dQ).
constexpr int kOutDK = 1, kOutDV = 2, kOutBoth = 3;

// Shared memory, in bytes from a 1024-aligned base: the two resident
// tensors, kStages slots of the two streamed tensors, kStages x 128 floats
// of per-query lse * log2(e) and Δ (K3), the barriers.  Three slots, one
// at D = 256.
template <int D>
struct TcSmem {
  static constexpr int kStages = D > 128 ? 1 : 3;
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
// kOut (K3): which of dK and dV this launch accumulates.  d <= D is the
// real head dim.
template <int D, bool kDKV, int kOut>
__device__ __forceinline__ void bwd_tc(
    const CUtensorMap* map_r0, const CUtensorMap* map_r1,
    const CUtensorMap* map_t0, const CUtensorMap* map_t1,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ out0, __nv_bfloat16* __restrict__ out1,
    int h, int d, int sq, int sk, float scale, float scale_log2, int causal) {
  using L = TcSmem<D>;
  constexpr int kStages = L::kStages;
  constexpr bool kA0 = !kDKV || (kOut & kOutDK);  // dQ or dK: needs dS
  constexpr bool kA1 = kDKV && (kOut & kOutDV);   // dV: needs P only
  // streamed rows per score tile: 64, or 32 for K2 at D = 256, where dQ's
  // m64n256 accumulator (128 registers) leaves no room for two 64 x 64
  // score tiles
  constexpr int kSc = !kDKV && D > 128 ? 32 : 64;
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

  float acc0[kA0 ? D / 2 : 1];
  float acc1[kA1 ? D / 2 : 1];
#pragma unroll
  for (int i = 0; i < (kA0 ? D / 2 : 1); ++i) acc0[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (kA1 ? D / 2 : 1); ++i) acc1[i] = 0.f;

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
      // At D = 256 the compiler would keep the 16 step descriptors of each
      // resident operand (64-bit each) live across the tile loop and spill;
      // pinning the bases per tile makes it add each step's offset at its
      // use.
      uint64_t da0_t = da0, da1_t = da1;
      if constexpr (D > 128) asm volatile("" : "+l"(da0_t), "+l"(da1_t));
      // the streamed tiles as MN-major B: 16 rows per step, 64-column
      // blocks kStr * 128 bytes apart
      const uint64_t mb0 = hopper::desc_sw128(slot, kStr * 128, 1024);
      const uint64_t mb1 = hopper::desc_sw128(slot + L::kStrBytes, kStr * 128, 1024);
      const float* rows =
          reinterpret_cast<const float*>(sm + L::kRows) + s * 2 * kStr;
#pragma unroll
      for (int hf = 0; hf < kStr / kSc; ++hf) {
        // streamed rows hf * kSc .. + kSc - 1: 8-row groups 1024 bytes apart
        const uint64_t db0 = hopper::desc_sw128(slot + hf * kSc * 128, 16, 1024);
        const uint64_t db1 = hopper::desc_sw128(
            slot + L::kStrBytes + hf * kSc * 128, 16, 1024);

        // S (K3: Sᵀ) and dP (K3: dPᵀ), 64 x kSc, reduced over d
        // (a launch that accumulates dV alone needs no dP)
        float sc[kSc / 2], dp[kA0 ? kSc / 2 : 1];
#pragma unroll
        for (int i = 0; i < kSc / 2; ++i) sc[i] = 0.f;
#pragma unroll
        for (int i = 0; i < (kA0 ? kSc / 2 : 1); ++i) dp[i] = 0.f;
        hopper::fence_regs(sc);
        if constexpr (kA0) hopper::fence_regs(dp);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t oa = ((kk / 4) * kRes * 128 + (kk % 4) * 32) >> 4;
          const uint32_t ob = ((kk / 4) * kStr * 128 + (kk % 4) * 32) >> 4;
          hopper::wgmma_ss<kSc>(sc, da0_t + oa, db0 + ob, kk > 0);
        }
        if constexpr (kA0) {
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const uint32_t oa = ((kk / 4) * kRes * 128 + (kk % 4) * 32) >> 4;
            const uint32_t ob = ((kk / 4) * kStr * 128 + (kk % 4) * 32) >> 4;
            hopper::wgmma_ss<kSc>(dp, da1_t + oa, db1 + ob, kk > 0);
          }
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait_all();
        hopper::fence_regs(sc);
        if constexpr (kA0) hopper::fence_regs(dp);

        // P and dS (without the scale, applied to the sums at the end);
        // element i of a score tile: row 16 warp + g + 8 ((i >> 1) & 1),
        // column 8 (i >> 2) + 2 c4 + (i & 1)
#pragma unroll
        for (int j = 0; j < kSc / 8; ++j) {
          const int col = hf * kSc + 8 * j + 2 * c4;
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
              if constexpr (kA0) dp[i] = p * (dp[i] - dd);
            }
          }
        }
        // rounded to bf16: the accumulator layout of columns 16k .. 16k + 15
        // is the A-operand layout of reduction step k
        uint32_t pf[kA1 ? kSc / 4 : 1], dsf[kA0 ? kSc / 4 : 1];
#pragma unroll
        for (int i = 0; i < kSc / 4; ++i) {
          if constexpr (kA1) pf[i] = hopper::pack_bf16(sc[2 * i], sc[2 * i + 1]);
          if constexpr (kA0) dsf[i] = hopper::pack_bf16(dp[2 * i], dp[2 * i + 1]);
        }

        if constexpr (kA0) {
          hopper::fence_regs(acc0);
          hopper::fence_regs(dsf);
        }
        if constexpr (kA1) {
          hopper::fence_regs(acc1);
          hopper::fence_regs(pf);
        }
        hopper::wgmma_fence();
        // reduction steps hf * kSc / 16 .. of the streamed rows
        constexpr int kSteps = kSc / 16;
        if constexpr (kA1) {
#pragma unroll
          for (int kk = 0; kk < kSteps; ++kk)
            hopper::wgmma_rs<D>(acc1, &pf[4 * kk],
                                mb1 + (((hf * kSteps + kk) * 2048) >> 4));  // dV += Pᵀ dO
        }
        if constexpr (kA0) {
#pragma unroll
          for (int kk = 0; kk < kSteps; ++kk)
            hopper::wgmma_rs<D>(acc0, &dsf[4 * kk],
                                mb0 + (((hf * kSteps + kk) * 2048) >> 4));  // dK += dSᵀ Q; dQ += dS K
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait_all();
        if constexpr (kA0) {
          hopper::fence_regs(acc0);
          hopper::fence_regs(dsf);
        }
        if constexpr (kA1) {
          hopper::fence_regs(acc1);
          hopper::fence_regs(pf);
        }
      }
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
    const int64_t off = (((int64_t)bi * s_res + row) * h + hi) * d + 2 * c4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (8 * j >= d) continue;  // columns 8j + 2c4 (+1); d % 32 == 0
      if constexpr (kA0)
        *reinterpret_cast<uint32_t*>(out0 + off + 8 * j) = hopper::pack_bf16(
            acc0[4 * j + 2 * x] * scale, acc0[4 * j + 2 * x + 1] * scale);
      if constexpr (kA1)
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
                       __nv_bfloat16* __restrict__ dq, int h, int d, int sq,
                       int sk, float scale, float scale_log2, int causal) {
  bwd_tc<D, false, kOutDK>(&map_q, &map_do, &map_k, &map_v, lse, delta, dq,
                           nullptr, h, d, sq, sk, scale, scale_log2, causal);
}

// K3, bf16: dK and dV (kOut: or one of them) for one (b*h, 128-key tile).
template <int D, int kOut>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_dkv_tc_kernel(const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_do,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dk,
                        __nv_bfloat16* __restrict__ dv, int h, int d, int sq,
                        int sk, float scale, float scale_log2, int causal) {
  bwd_tc<D, true, kOut>(&map_k, &map_v, &map_q, &map_do, lse, delta, dk, dv,
                        h, d, sq, sk, scale, scale_log2, causal);
}

// One launch of K3 (bf16) accumulating kOut.
template <int D, int kOut>
cudaError_t launch_dkv_tc(const CUtensorMap& mk, const CUtensorMap& mv,
                          const CUtensorMap& mq, const CUtensorMap& mo,
                          const float* lse, const float* delta,
                          __nv_bfloat16* dk, __nv_bfloat16* dv, dim3 grid,
                          int smem, int h, int d, int sq, int sk, float scale,
                          int causal, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_tc_kernel<D, kOut>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_tc_kernel<D, kOut><<<grid, kTcThreads, smem, stream>>>(
      mk, mv, mq, mo, lse, delta, dk, dv, h, d, sq, sk, scale,
      scale * kLog2e, causal);
  return cudaGetLastError();
}

// strides: q, k, v, dO, each (b, s, h), in elements.  The resident tensors'
// maps take boxes of kRes rows, the streamed ones kStr; every map has the
// real head dim d.
template <int D, bool kDKV>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* out0, void* out1, int b, int h, int d, int sq,
                      int sk, const int64_t* st, float scale, int causal,
                      cudaStream_t stream) {
  if (kDKV && sq == 0) {  // no query: dK = dV = 0
    const size_t bytes = (size_t)b * sk * h * d * sizeof(__nv_bfloat16);
    cudaError_t err = cudaMemsetAsync(out0, 0, bytes, stream);
    if (err == cudaSuccess) err = cudaMemsetAsync(out1, 0, bytes, stream);
    return err;
  }
  const int q_rows = kDKV ? kStr : kRes;
  const int kv_rows = kDKV ? kRes : kStr;
  CUtensorMap mq, mk, mv, mo;
  if (!hopper::encode_bshd_bf16(&mq, q, b, sq, h, d, st[0], st[1], st[2], q_rows) ||
      !hopper::encode_bshd_bf16(&mk, k, b, sk, h, d, st[3], st[4], st[5], kv_rows) ||
      !hopper::encode_bshd_bf16(&mv, v, b, sk, h, d, st[6], st[7], st[8], kv_rows) ||
      !hopper::encode_bshd_bf16(&mo, dout, b, sq, h, d, st[9], st[10], st[11], q_rows))
    return cudaErrorInvalidValue;
  const int smem = TcSmem<D>::kAlloc;
  const dim3 grid(b * h, ((kDKV ? sk : sq) + kRes - 1) / kRes);
  const float scale_log2 = scale * kLog2e;
  cudaError_t err;
  if constexpr (kDKV) {
    // D <= 128: dK and dV in one launch; D = 256: dV, then dK
    __nv_bfloat16* dk = static_cast<__nv_bfloat16*>(out0);
    __nv_bfloat16* dv = static_cast<__nv_bfloat16*>(out1);
    if constexpr (D > 128) {
      err = launch_dkv_tc<D, kOutDV>(mk, mv, mq, mo, lse, delta, dk, dv, grid,
                                     smem, h, d, sq, sk, scale, causal, stream);
      if (err != cudaSuccess) return err;
      return launch_dkv_tc<D, kOutDK>(mk, mv, mq, mo, lse, delta, dk, dv, grid,
                                      smem, h, d, sq, sk, scale, causal, stream);
    } else {
      return launch_dkv_tc<D, kOutBoth>(mk, mv, mq, mo, lse, delta, dk, dv,
                                        grid, smem, h, d, sq, sk, scale, causal,
                                        stream);
    }
  }
  err = cudaFuncSetAttribute(flash_bwd_dq_tc_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_tc_kernel<D><<<grid, kTcThreads, smem, stream>>>(
      mq, mo, mk, mv, lse, delta, static_cast<__nv_bfloat16*>(out0), h, d, sq,
      sk, scale, scale_log2, causal);
  return cudaGetLastError();
}

// ===========================================================================
// float32: tensor cores, split TF32
// ===========================================================================

// ---- float32 at the width 256: mma.sync m16n8k8 ---------------------------

// Tile sizes (instantiated at the width 256 only).  The block owns kRes
// resident rows, 16 per warp, kept as loaded.  The streamed tensors arrive
// kStr rows per tile in one cp.async slot, and each tile is split once
// into TF32 hi and lo planes there, so that no warp splits a streamed
// operand.  Every tile and plane is row-major at a row stride of kSD = D +
// 4 floats (kSD % 8 == 4), which makes every fragment load below free of
// bank conflicts.
template <int D>
struct F32Tile {
  static constexpr int kWarps = 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRes = 16 * kWarps;
  static constexpr int kStr = 16;
  static constexpr int kSD = D + 4;
  static constexpr int kResF = kRes * kSD;  // floats of one resident tensor
  static constexpr int kStrF = kStr * kSD;  // floats of one plane
  // a slot: t0 hi, t0 lo, t1 hi, t1 lo, then kStr floats each of
  // lse * log2(e) and Δ (K3's columns are queries)
  static constexpr int kSlotF = 4 * kStrF + 2 * kStr;
  static constexpr int kBytes = 4 * (2 * kResF + kSlotF);
};

// Split the elements this thread staged with stage_async (the same loop,
// so its own cp.async copies are all it reads: no barrier needed before):
// hi[i] = x_hi in place of x, lo[i] = x_lo.
template <int D, int kThreads>
__device__ __forceinline__ void split_staged(float* hi, float* lo, int rows,
                                             bool vec) {
  constexpr int kSD = D + 4;
  if (vec) {
    for (int e = threadIdx.x; e < rows * (D / 4); e += kThreads) {
      const int i = e / (D / 4) * kSD + e % (D / 4) * 4;
      float4 x = *reinterpret_cast<float4*>(hi + i);
      uint32_t h[4], l[4];
      hopper::split_frag(x.x, x.y, x.z, x.w, h, l);
      *reinterpret_cast<uint4*>(hi + i) = make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(lo + i) = make_uint4(l[0], l[1], l[2], l[3]);
    }
  } else {
    for (int e = threadIdx.x; e < rows * D; e += kThreads) {
      const int i = e / D * kSD + e % D;
      uint32_t h, l;
      hopper::split_tf32(hi[i], h, l);
      hi[i] = __uint_as_float(h);
      lo[i] = __uint_as_float(l);
    }
  }
}

template <int kJ>
__device__ __forceinline__ void zero(float (&x)[kJ][4]) {
#pragma unroll
  for (int j = 0; j < kJ; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) x[j][i] = 0.f;
}

// acc += small, then big (the small terms first)
template <int kJ>
__device__ __forceinline__ void add_parts(float (&acc)[kJ][4],
                                          const float (&big)[kJ][4],
                                          const float (&small)[kJ][4]) {
#pragma unroll
  for (int j = 0; j < kJ; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = (acc[j][i] + small[j][i]) + big[j][i];
}

// acc[j] += A B over D columns: A the warp's 16 rows of a resident tile (a
// = row g, column c; split here), B the kJ 8-row blocks of a streamed
// tile's hi and lo planes (row g, column c), both read as rows; in chunks
// of kChunkK columns.
template <int D, int kJ, int kSD>
__device__ __forceinline__ void score_tile(float (&acc)[kJ][4], const float* a,
                                           const float* bh, const float* bl) {
#pragma unroll 1
  for (int k0 = 0; k0 < D; k0 += kChunkK) {
    float big[kJ][4], small[kJ][4];
    zero(big);
    zero(small);
#pragma unroll
    for (int kk = k0; kk < k0 + kChunkK; kk += 8) {
      uint32_t ah[4], al[4];
      hopper::split_frag(a[kk], a[8 * kSD + kk], a[kk + 4],
                         a[8 * kSD + kk + 4], ah, al);
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int o = 8 * j * kSD + kk;
        mma3(big[j], small[j], ah, al, bh[o], bh[o + 4], bl[o], bl[o + 4]);
      }
    }
    add_parts(acc, big, small);
  }
}

// acc[n] += X B over the tile's streamed rows: X a score tile in the
// accumulator layout (split here), B the streamed tile's hi and lo planes
// (bh, bl = row 2c, column g).  Block j's registers, read as an A
// fragment, put streamed row 8j + 2c in k-slot c and row 8j + 2c + 1 in
// slot c + 4 (a0 = d0, a1 = d2, a2 = d1, a3 = d3), and B takes the same
// rows.
template <int kJ, int kN, int kSD>
__device__ __forceinline__ void accumulate_tile(float (&acc)[kN][4],
                                                const float (&x)[kJ][4],
                                                const float* bh,
                                                const float* bl) {
  constexpr int kJC = kJ < kChunkK / 8 ? kJ : kChunkK / 8;
  uint32_t hi[kJ][4], lo[kJ][4];
#pragma unroll
  for (int j = 0; j < kJ; ++j)
    hopper::split_frag(x[j][0], x[j][2], x[j][1], x[j][3], hi[j], lo[j]);
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int j0 = 0; j0 < kJ; j0 += kJC) {
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = j0; j < j0 + kJC; ++j) {
        const int o = 8 * j * kSD + 8 * n;
        mma3(part, part, hi[j], lo[j], bh[o], bh[o + kSD], bl[o],
             bl[o + kSD]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i] += part[i];
    }
}

// The body of both kernels, as bwd_tc's: resident r0, r1 (kRes rows of
// the block), streamed t0, t1 (kStr rows per tile):
//   K3 (kDKV): r0 = K, r1 = V, t0 = Q, t1 = dO; out0 = dK, out1 = dV
//   K2:        r0 = Q, r1 = dO, t0 = K, t1 = V; out0 = dQ
// Warp w owns resident rows 16w .. 16w + 15 of the block.  Per tile it
// computes S (K3: Sᵀ) and dP (dPᵀ), 16 x kStr, over d; forms P and dS in
// the accumulator registers; and adds dS t0 (and P t1) to its 16 x D
// accumulators, with P and dS fed from those registers as A fragments.
template <int D, bool kDKV, int kOut>
__device__ __forceinline__ void bwd_tf32(View r0, View r1, View t0, View t1,
                                         const float* __restrict__ lse,
                                         const float* __restrict__ delta,
                                         float* __restrict__ out0,
                                         float* __restrict__ out1, int h,
                                         int d, int sq, int sk, float scale,
                                         float scale_log2, int causal,
                                         bool vec) {
  using L = F32Tile<D>;
  constexpr int kSD = L::kSD, kStr = L::kStr;
  constexpr bool kA0 = !kDKV || (kOut & kOutDK);  // dQ or dK: needs dS
  constexpr bool kA1 = kDKV && (kOut & kOutDV);   // dV: needs P only
  constexpr int kJ = kStr / 8;  // 8-column blocks of a score tile
  constexpr int kN = D / 8;     // 8-column blocks of an accumulator
  extern __shared__ float4 smem4[];
  float* const res0 = reinterpret_cast<float*>(smem4);
  float* const res1 = res0 + L::kResF;
  float* const slot = res1 + L::kResF;

  const int bh = blockIdx.x;
  const int bi = bh / h;
  const int hi = bh % h;
  const int s_res = kDKV ? sk : sq;
  const int s_str = kDKV ? sq : sk;
  // K3: the heaviest causal tiles (first keys) have the lowest index;
  // K2: the heaviest (last queries) are scheduled first
  const int r_begin =
      L::kRes * (kDKV ? blockIdx.y : gridDim.y - 1 - blockIdx.y);
  int t_begin = 0, t_end;
  if (kDKV) {
    t_begin = causal ? r_begin : 0;  // queries before k0 see none of the keys
    t_end = sq;
  } else {
    t_end = causal ? min(sk, r_begin + L::kRes) : sk;
  }
  const int n_tiles = t_end > t_begin ? (t_end - t_begin + kStr - 1) / kStr : 0;

  const float* pr0 = r0.p + bi * r0.b + hi * r0.h;
  const float* pr1 = r1.p + bi * r1.b + hi * r1.h;
  const float* pt0 = t0.p + bi * t0.b + hi * t0.h;
  const float* pt1 = t1.p + bi * t1.b + hi * t1.h;

  // tile t into the slot, one cp.async group (the first also carries the
  // resident rows); K3's per-query lse * log2(e) and Δ by plain stores
  auto load_tile = [&](int t) {
    const int row0 = t_begin + t * kStr;
    stage_async<D, L::kThreads>(slot, pt0, t0.s, row0, s_str, kStr, d, vec);
    stage_async<D, L::kThreads>(slot + 2 * L::kStrF, pt1, t1.s, row0, s_str,
                                kStr, d, vec);
    if (kDKV) {
      for (int i = threadIdx.x; i < kStr; i += L::kThreads) {
        const int q = row0 + i;
        const bool ok = q < sq;
        slot[4 * L::kStrF + i] = ok ? lse[(int64_t)bh * sq + q] * kLog2e : 0.f;
        slot[4 * L::kStrF + kStr + i] = ok ? delta[(int64_t)bh * sq + q] : 0.f;
      }
    }
    hopper::cp_async_commit();
  };

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int c = lane % 4;
  const int rw = r_begin + 16 * warp;  // the warp's first resident row
  const bool live = rw < s_res;

  float acc0[kA0 ? kN : 1][4], acc1[kA1 ? kN : 1][4];
#pragma unroll
  for (int n = 0; n < (kA0 ? kN : 1); ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc0[n][i] = 0.f;
#pragma unroll
  for (int n = 0; n < (kA1 ? kN : 1); ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc1[n][i] = 0.f;

  // K2: lse * log2(e) and Δ of this thread's two query rows
  float lse2[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
  if (!kDKV) {
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int q = rw + g + 8 * x;
      if (q < sq) {
        lse2[x] = lse[(int64_t)bh * sq + q] * kLog2e;
        dl[x] = delta[(int64_t)bh * sq + q];
      }
    }
  }

  if (n_tiles > 0) {
    stage_async<D, L::kThreads>(res0, pr0, r0.s, r_begin, s_res, L::kRes, d,
                                vec);
    stage_async<D, L::kThreads>(res1, pr1, r1.s, r_begin, s_res, L::kRes, d,
                                vec);
    load_tile(0);
  }
  // this thread's A rows (g, g + 8) and B rows of the resident tiles
  const float* a0p = res0 + (16 * warp + g) * kSD + c;
  const float* a1p = res1 + (16 * warp + g) * kSD + c;

  for (int t = 0; t < n_tiles; ++t) {
    // this thread's copies of tile t have landed: split them
    hopper::cp_async_wait<0>();
    split_staged<D, L::kThreads>(slot, slot + L::kStrF, kStr, vec);
    split_staged<D, L::kThreads>(slot + 2 * L::kStrF, slot + 3 * L::kStrF,
                                 kStr, vec);
    __syncthreads();  // tile t split (and the resident rows landed) for all

    const int q0 = t_begin + t * kStr;
    bool skip, masked;
    if (kDKV) {  // rows are keys rw.., columns queries q0..
      skip = !live || (causal && q0 + kStr <= rw);
      masked = (causal && q0 < rw + 16) || q0 + kStr > sq;
    } else {  // rows are queries rw.., columns keys q0..
      skip = !live || (causal && q0 >= rw + 16);
      masked = (causal && q0 + kStr > rw) || q0 + kStr > sk;
    }
    if (!skip) {
      // S (K3: Sᵀ) = r0 t0ᵀ and dP (dPᵀ) = r1 t1ᵀ, 16 x kStr, over d
      float sc[kJ][4], dp[kA0 ? kJ : 1][4];
#pragma unroll
      for (int j = 0; j < kJ; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          sc[j][i] = 0.f;
          if constexpr (kA0) dp[j][i] = 0.f;
        }
      const float* t0h = slot;  // the planes of t0 and t1
      const float* t0l = slot + L::kStrF;
      const float* t1h = slot + 2 * L::kStrF;
      const float* t1l = slot + 3 * L::kStrF;
      const int oa = g * kSD + c;
      score_tile<D, kJ, kSD>(sc, a0p, t0h + oa, t0l + oa);
      if constexpr (kA0) score_tile<D, kJ, kSD>(dp, a1p, t1h + oa, t1l + oa);

      // P and dS (without the scale, applied to the sums at the end);
      // element i of block j: row g + 8 (i >> 1), column 8j + 2c + (i & 1)
      const float* lrow = slot + 4 * L::kStrF;
#pragma unroll
      for (int j = 0; j < kJ; ++j)
#pragma unroll
        for (int x = 0; x < 2; ++x)
#pragma unroll
          for (int y = 0; y < 2; ++y) {
            const int i = 2 * x + y;
            const int col = 8 * j + 2 * c + y;
            const float l = kDKV ? lrow[col] : lse2[x];
            float p = exp2f(fmaf(sc[j][i], scale_log2, -l));
            if (masked) {
              // K3: query q0 + col, key row; K2: query row, key q0 + col
              const int row = rw + g + 8 * x;
              const int cidx = q0 + col;
              const bool visible =
                  kDKV ? (cidx < sq && (!causal || cidx >= row))
                       : (cidx < sk && (!causal || cidx <= row));
              if (!visible) p = 0.f;
            }
            sc[j][i] = p;
            if constexpr (kA0) {
              const float dd = kDKV ? lrow[kStr + col] : dl[x];
              dp[j][i] = p * (dp[j][i] - dd);
            }
          }

      // dV += Pᵀ dO, then dK += dSᵀ Q (K2: dQ += dS K)
      const int ob = 2 * c * kSD + g;
      if constexpr (kA1) accumulate_tile<kJ, kN, kSD>(acc1, sc, t1h + ob, t1l + ob);
      if constexpr (kA0) accumulate_tile<kJ, kN, kSD>(acc0, dp, t0h + ob, t0l + ob);
    }
    __syncthreads();  // the slot read by every warp
    if (t + 1 < n_tiles) load_tile(t + 1);
  }

  if (!live) return;
  // rows g + 8x of the warp, columns 8n + 2c (+1), as float2
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int row = rw + g + 8 * x;
    if (row >= s_res) continue;
    const int64_t off = (((int64_t)bi * s_res + row) * h + hi) * d + 2 * c;
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      if (8 * n >= d) continue;  // d % 32 == 0
      if constexpr (kA0)
        *reinterpret_cast<float2*>(out0 + off + 8 * n) = make_float2(
            acc0[n][2 * x] * scale, acc0[n][2 * x + 1] * scale);
      if constexpr (kA1)
        *reinterpret_cast<float2*>(out1 + off + 8 * n) =
            make_float2(acc1[n][2 * x], acc1[n][2 * x + 1]);
    }
  }
}

// ---- float32 at the widths 64 and 128: wgmma -------------------------------

// Two warpgroups own kRes = 128 resident rows (warp w rows 16w .. 16w +
// 15), kept raw.  The streamed tiles are kStr = 16 rows.  Shared memory, in
// bytes: the two resident tensors, raw, at a row stride of D + 8 floats
// (8-byte fragment loads free of bank conflicts); each streamed tile split
// into TF32 hi and lo planes in the core-matrix layout (hopper.cuh), once
// as the B operand of S and dP ("natural": rows are streamed rows, K = d)
// and once as the B operand of the accumulating products ("transposed":
// rows are d columns, K = the tile's rows in the k-slot order of the A
// fragments: slot c of 8-row block j is row 8j + 2c, slot c + 4 row 8j +
// 2c + 1); the raw tile as cp.async lands it; K3's per-query lse *
// log2(e) and Δ in two slots.
template <int D>
struct WgTile {
  static constexpr int kRes = 128;
  static constexpr int kStr = 16;
  static constexpr int kThreads = 256;
  static constexpr int kSDr = D + 4;   // row stride of a raw tile, floats
  static constexpr int kSDres = D + 8;  // of the resident rows (% 32 == 8)
  static constexpr int kResB = kRes * kSDres * 4;  // one resident tensor
  static constexpr int kStrB = kStr * D * 4;     // one plane
  static constexpr int kNat = 2 * kResB;      // t0 hi, t0 lo, t1 hi, t1 lo
  static constexpr int kTr = kNat + 4 * kStrB;
  static constexpr int kRaw = kTr + 4 * kStrB;  // raw t0, t1
  static constexpr int kRows = kRaw + 2 * kStr * kSDr * 4;
  static constexpr int kBytes = kRows + 2 * 2 * kStr * 4;
};

template <int D, bool kDKV>
__device__ __forceinline__ void bwd_wg(View r0, View r1, View t0, View t1,
                                       const float* __restrict__ lse,
                                       const float* __restrict__ delta,
                                       float* __restrict__ out0,
                                       float* __restrict__ out1, int h, int d,
                                       int sq, int sk, float scale,
                                       float scale_log2, int causal,
                                       bool vec) {
  using L = WgTile<D>;
  constexpr int kStr = L::kStr, kSDr = L::kSDr;
  extern __shared__ float4 smem4[];
  uint8_t* const sm = reinterpret_cast<uint8_t*>(smem4);
  float* const res0 = reinterpret_cast<float*>(sm);
  float* const res1 = reinterpret_cast<float*>(sm + L::kResB);
  float* const raw = reinterpret_cast<float*>(sm + L::kRaw);
  float* const rows = reinterpret_cast<float*>(sm + L::kRows);

  const int bh = blockIdx.x;
  const int bi = bh / h;
  const int hi = bh % h;
  const int s_res = kDKV ? sk : sq;
  const int s_str = kDKV ? sq : sk;
  const int r_begin =
      L::kRes * (kDKV ? blockIdx.y : gridDim.y - 1 - blockIdx.y);
  int t_begin = 0, t_end;
  if (kDKV) {
    t_begin = causal ? r_begin : 0;
    t_end = sq;
  } else {
    t_end = causal ? min(sk, r_begin + L::kRes) : sk;
  }
  const int n_tiles = t_end > t_begin ? (t_end - t_begin + kStr - 1) / kStr : 0;

  const float* pr0 = r0.p + bi * r0.b + hi * r0.h;
  const float* pr1 = r1.p + bi * r1.b + hi * r1.h;
  const float* pt0 = t0.p + bi * t0.b + hi * t0.h;
  const float* pt1 = t1.p + bi * t1.b + hi * t1.h;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int c = lane % 4;
  const int rw = r_begin + 16 * warp;         // the warp's first row
  const int rg = r_begin + 64 * (warp / 4);   // its warpgroup's first row
  const bool live = rg < s_res;

  float acc0[D / 2], acc1[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc0[i] = acc1[i] = 0.f;

  // K2: lse * log2(e) and Δ of this thread's two query rows
  float lse2[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
  if (!kDKV) {
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int q = rw + g + 8 * x;
      if (q < sq) {
        lse2[x] = lse[(int64_t)bh * sq + q] * kLog2e;
        dl[x] = delta[(int64_t)bh * sq + q];
      }
    }
  }

  auto load_tile = [&](int t) {
    const int row0 = t_begin + t * kStr;
    stage_async<D, L::kThreads>(raw, pt0, t0.s, row0, s_str, kStr, d, vec);
    stage_async<D, L::kThreads>(raw + kStr * kSDr, pt1, t1.s, row0, s_str,
                                kStr, d, vec);
    hopper::cp_async_commit();
    if (kDKV && threadIdx.x < kStr) {
      float* slot = rows + (t & 1) * 2 * kStr;
      const int q = row0 + threadIdx.x;
      const bool ok = q < sq;
      slot[threadIdx.x] = ok ? lse[(int64_t)bh * sq + q] * kLog2e : 0.f;
      slot[kStr + threadIdx.x] = ok ? delta[(int64_t)bh * sq + q] : 0.f;
    }
  };

  if (n_tiles > 0) {
    stage_async<D, L::kThreads, L::kSDres>(res0, pr0, r0.s, r_begin, s_res,
                                           L::kRes, d, vec);
    stage_async<D, L::kThreads, L::kSDres>(res1, pr1, r1.s, r_begin, s_res,
                                           L::kRes, d, vec);
    load_tile(0);  // one group with the resident rows
  }

  const uint32_t base = hopper::smem_addr(sm);
  constexpr uint32_t kLboTr = 16 * D;
  const uint64_t dt0h = hopper::desc_plain(base + L::kTr, kLboTr, 128);
  const uint64_t dt0l = hopper::desc_plain(base + L::kTr + L::kStrB, kLboTr, 128);
  const uint64_t dt1h = hopper::desc_plain(base + L::kTr + 2 * L::kStrB, kLboTr, 128);
  const uint64_t dt1l = hopper::desc_plain(base + L::kTr + 3 * L::kStrB, kLboTr, 128);
  const float* a0p = res0 + (16 * warp + g) * L::kSDres + 2 * c;
  const float* a1p = res1 + (16 * warp + g) * L::kSDres + 2 * c;
  constexpr uint32_t kLboNat = 16 * kStr;
  const uint64_t dn0h = hopper::desc_plain(base + L::kNat, kLboNat, 128);
  const uint64_t dn0l = hopper::desc_plain(base + L::kNat + L::kStrB, kLboNat, 128);
  const uint64_t dn1h = hopper::desc_plain(base + L::kNat + 2 * L::kStrB, kLboNat, 128);
  const uint64_t dn1l = hopper::desc_plain(base + L::kNat + 3 * L::kStrB, kLboNat, 128);

  for (int t = 0; t < n_tiles; ++t) {
    hopper::cp_async_wait<0>();
    __syncthreads();  // raw tile t landed; every read of tile t - 1 done
    // split it: natural planes of t0 and t1, transposed planes of t0 (and
    // of t1 in K3)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float* rq = raw + q * kStr * kSDr;
      split_natural<D>(sm + L::kNat + 2 * q * L::kStrB,
                       sm + L::kNat + (2 * q + 1) * L::kStrB, rq);
      if (q == 0 || kDKV)
        split_transposed<D>(sm + L::kTr + 2 * q * L::kStrB,
                            sm + L::kTr + (2 * q + 1) * L::kStrB, rq);
    }
    hopper::fence_proxy_async();
    __syncthreads();  // the planes of tile t are written; raw is free
    if (t + 1 < n_tiles) load_tile(t + 1);

    const int q0 = t_begin + t * kStr;
    bool skip, masked;  // per warpgroup (wgmma is warpgroup-wide)
    if (kDKV) {  // rows are keys rg.., columns queries q0..
      skip = !live || (causal && q0 + kStr <= rg);
      masked = (causal && q0 < rg + 64) || q0 + kStr > sq;
    } else {  // rows are queries rg.., columns keys q0..
      skip = !live || (causal && q0 >= rg + 64);
      masked = (causal && q0 + kStr > rg) || q0 + kStr > sk;
    }
    if (skip) continue;

    // S (K3: Sᵀ) = r0 t0ᵀ and dP (dPᵀ) = r1 t1ᵀ, 64 x 16 per warpgroup;
    // register 4j + i of the accumulator is element i of 8-column block j
    float s8[8] = {}, d8[8] = {};
    score_wg<D, L::kSDres>(s8, d8, a0p, a1p, dn0h, dn0l, dn1h, dn1l);
    float sc[2][4], dp[2][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      sc[i / 4][i % 4] = s8[i];
      dp[i / 4][i % 4] = d8[i];
    }

    // P and dS (without the scale, applied to the sums at the end);
    // element i of block j: row g + 8 (i >> 1), column 8j + 2c + (i & 1)
    const float* lrow = rows + (t & 1) * 2 * kStr;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int x = i >> 1, col = 8 * j + 2 * c + (i & 1);
        const float l = kDKV ? lrow[col] : lse2[x];
        float p = exp2f(fmaf(sc[j][i], scale_log2, -l));
        if (masked) {
          // K3: query q0 + col, key row; K2: query row, key q0 + col
          const int row = rw + g + 8 * x;
          const int cidx = q0 + col;
          const bool visible = kDKV ? (cidx < sq && (!causal || cidx >= row))
                                    : (cidx < sk && (!causal || cidx <= row));
          if (!visible) p = 0.f;
        }
        const float dd = kDKV ? lrow[kStr + col] : dl[x];
        sc[j][i] = p;
        dp[j][i] = p * (dp[j][i] - dd);
      }
    // as A fragments of the two 8-row k-steps: a0 = d0, a1 = d2, a2 = d1,
    // a3 = d3 (k-slots c, c + 4 hold rows 2c, 2c + 1, as in the
    // transposed planes)
    uint32_t ph[2][4], pl[2][4], dh[2][4], dlo[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      hopper::split_frag(sc[j][0], sc[j][2], sc[j][1], sc[j][3], ph[j], pl[j]);
      hopper::split_frag(dp[j][0], dp[j][2], dp[j][1], dp[j][3], dh[j], dlo[j]);
    }
    // K3: dV += Pᵀ dO, then dK += dSᵀ Q; K2: dQ += dS K; per 64 columns
    // the six products of a tile sum in a zeroed part, added in float32.
    // Two parts alternate, so one is added while the next is computed.
    constexpr int kParts = (kDKV ? 2 : 1) * (D / 64);
    auto issue = [&](int i, float(&part)[32]) {
      if (kDKV && i < D / 64)
        issue_part<D>(part, ph, pl, dt1h, dt1l, i);
      else
        issue_part<D>(part, dh, dlo, dt0h, dt0l, i % (D / 64));
    };
    auto add = [&](int i, float(&part)[32]) {
      if (kDKV && i < D / 64)
        add_part<D>(acc1, part, i);
      else
        add_part<D>(acc0, part, i % (D / 64));
    };
    float pa[32], pb[32];
    issue(0, pa);
#pragma unroll
    for (int i = 1; i < kParts; ++i) {
      if (i & 1)
        issue(i, pb);
      else
        issue(i, pa);
      hopper::wgmma_wait<1>();
      if (i & 1)
        add(i - 1, pa);
      else
        add(i - 1, pb);
    }
    hopper::wgmma_wait<0>();
    if ((kParts - 1) & 1)
      add(kParts - 1, pb);
    else
      add(kParts - 1, pa);
  }

  // rows g + 8x of the warp, columns 8j + 2c (+1), as float2
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int row = rw + g + 8 * x;
    if (row >= s_res) continue;
    const int64_t off = (((int64_t)bi * s_res + row) * h + hi) * d + 2 * c;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (8 * j >= d) continue;  // d % 32 == 0
      *reinterpret_cast<float2*>(out0 + off + 8 * j) = make_float2(
          acc0[4 * j + 2 * x] * scale, acc0[4 * j + 2 * x + 1] * scale);
      if constexpr (kDKV)
        *reinterpret_cast<float2*>(out1 + off + 8 * j) =
            make_float2(acc1[4 * j + 2 * x], acc1[4 * j + 2 * x + 1]);
    }
  }
}

// K2, float32: dQ for one (b*h, 128-query tile) on wgmma at the widths 64
// and 128, or one 64-query tile on mma.sync at 256.
template <int D>
__global__ void __launch_bounds__(D > 128 ? 128 : 256, 1)
flash_bwd_dq_tf32_kernel(View q, View dout, View k, View v,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dq, int h, int d, int sq, int sk,
                         float scale, float scale_log2, int causal, int vec) {
  if constexpr (D > 128)
    bwd_tf32<D, false, kOutDK>(q, dout, k, v, lse, delta, dq, nullptr, h, d,
                               sq, sk, scale, scale_log2, causal, vec != 0);
  else
    bwd_wg<D, false>(q, dout, k, v, lse, delta, dq, nullptr, h, d, sq, sk,
                     scale, scale_log2, causal, vec != 0);
}

// K3, float32: dK and dV for one (b*h, 128-key tile) at the widths 64 and
// 128; at 256 dK or dV (kOut) for one 64-key tile.
template <int D, int kOut>
__global__ void __launch_bounds__(D > 128 ? 128 : 256, 1)
flash_bwd_dkv_tf32_kernel(View k, View v, View q, View dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int h, int d, int sq, int sk, float scale,
                          float scale_log2, int causal, int vec) {
  if constexpr (D > 128)
    bwd_tf32<D, true, kOut>(k, v, q, dout, lse, delta, dk, dv, h, d, sq, sk,
                            scale, scale_log2, causal, vec != 0);
  else
    bwd_wg<D, true>(k, v, q, dout, lse, delta, dk, dv, h, d, sq, sk, scale,
                    scale_log2, causal, vec != 0);
}

// Shared memory, threads and resident rows per block of the float32
// kernels.
template <int D>
struct F32Launch {
  static constexpr int kBytes = D > 128 ? F32Tile<D>::kBytes : WgTile<D>::kBytes;
  static constexpr int kThreads = D > 128 ? F32Tile<D>::kThreads : WgTile<D>::kThreads;
  static constexpr int kRows = D > 128 ? F32Tile<D>::kRes : WgTile<D>::kRes;
};

// The four views in the order q, k, v, dO; vec if every base is 16-byte
// aligned and every (b, s, h) stride a multiple of 4 elements.
struct Views {
  View q, k, v, o;
  int vec;
};

Views views(const void* q, const void* k, const void* v, const void* dout,
            const int64_t* st) {
  const void* base[4] = {q, k, v, dout};
  View out[4];
  const int vec = make_views(4, base, st, out);
  return Views{out[0], out[1], out[2], out[3], vec};
}

template <int D>
cudaError_t launch_dq_tf32(const Views& w, const float* lse,
                           const float* delta, void* dq, int b, int h, int d,
                           int sq, int sk, float scale, int causal,
                           cudaStream_t stream) {
  using L = F32Launch<D>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_tf32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(b * h, (sq + L::kRows - 1) / L::kRows);
  flash_bwd_dq_tf32_kernel<D><<<grid, L::kThreads, L::kBytes, stream>>>(
      w.q, w.o, w.k, w.v, lse, delta, static_cast<float*>(dq), h, d, sq, sk,
      scale, scale * kLog2e, causal, w.vec);
  return cudaGetLastError();
}

// One launch of K3 (float32) accumulating kOut.
template <int D, int kOut>
cudaError_t launch_dkv_tf32(const Views& w, const float* lse,
                            const float* delta, void* dk, void* dv, int b,
                            int h, int d, int sq, int sk, float scale,
                            int causal, cudaStream_t stream) {
  using L = F32Launch<D>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_tf32_kernel<D, kOut>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(b * h, (sk + L::kRows - 1) / L::kRows);
  flash_bwd_dkv_tf32_kernel<D, kOut><<<grid, L::kThreads, L::kBytes, stream>>>(
      w.k, w.v, w.q, w.o, lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), h, d, sq, sk, scale, scale * kLog2e, causal,
      w.vec);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_any(int dtype, const void* q, const void* k,
                          const void* v, const void* dout, const float* lse,
                          const float* delta, void* dq, int b, int h, int d,
                          int sq, int sk, const int64_t* st, float scale,
                          int causal, cudaStream_t s) {
  if (dtype == 0)
    return launch_dq_tf32<D>(views(q, k, v, dout, st), lse, delta, dq, b, h, d, sq, sk, scale, causal, s);
  return launch_tc<D, false>(q, k, v, dout, lse, delta, dq, nullptr, b, h, d, sq, sk, st, scale, causal, s);
}

template <int D>
cudaError_t launch_dkv_any(int dtype, const void* q, const void* k,
                           const void* v, const void* dout, const float* lse,
                           const float* delta, void* dk, void* dv, int b,
                           int h, int d, int sq, int sk, const int64_t* st,
                           float scale, int causal, cudaStream_t s,
                           int* launched) {
  if (dtype == 0) {
    // D = 256: dV, then dK (two 64 x 256 accumulators do not fit beside
    // the score tiles); no query still launches (the blocks write zeros)
    const Views w = views(q, k, v, dout, st);
    *launched = D > 128 ? 2 : 1;
    if constexpr (D > 128) {
      cudaError_t err = launch_dkv_tf32<D, kOutDV>(w, lse, delta, dk, dv, b, h, d, sq, sk, scale, causal, s);
      if (err != cudaSuccess) return err;
      return launch_dkv_tf32<D, kOutDK>(w, lse, delta, dk, dv, b, h, d, sq, sk, scale, causal, s);
    } else {
      return launch_dkv_tf32<D, kOutBoth>(w, lse, delta, dk, dv, b, h, d, sq, sk, scale, causal, s);
    }
  }
  // launch_tc: no query is two memsets; D = 256 is dV, then dK
  *launched = sq == 0 ? 0 : (D > 128 ? 2 : 1);
  return launch_tc<D, true>(q, k, v, dout, lse, delta, dk, dv, b, h, d, sq, sk, st, scale, causal, s);
}

}  // namespace

// dtype: 0 = float32 (split TF32 on the tensor cores; any view with unit
// stride in d), 1 = bfloat16 (wgmma; every view needs a 16-byte
// aligned base and (b, s, h) strides that are multiples of 8 elements, or
// the entry returns cudaErrorInvalidValue).  d: the head dim;
// width: the instantiated width it runs at (64, 128 or 256, d <= width; the
// caller's ops/attention.py::kernel_width picks it, columns past d are
// zeros).  strides: q, k, v, dO, each (b, s, h), in elements (12 values,
// host memory).  scale is the softmax scale (not yet multiplied by
// log2(e)).  Each entry launches on `stream` without synchronising and
// returns cudaGetLastError() of the launch (0 on success).  K3 writes the
// number of kernels it launched to *launched: two at width 256 (dV, then
// dK), none in bf16 without a query (two memsets), else one.
extern "C" int mxtt_flash_bwd_dq(int dtype, int d, int width, const void* q,
                                 const void* k, const void* v,
                                 const void* dout, const float* lse,
                                 const float* delta, void* dq, int b, int h,
                                 int sq, int sk, const int64_t* strides,
                                 float scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((dtype != 0 && dtype != 1) || d <= 0 || d > width)
    return (int)cudaErrorInvalidValue;
  switch (width) {
    case 64:
      return (int)launch_dq_any<64>(dtype, q, k, v, dout, lse, delta, dq, b, h, d, sq, sk, strides, scale, causal, s);
    case 128:
      return (int)launch_dq_any<128>(dtype, q, k, v, dout, lse, delta, dq, b, h, d, sq, sk, strides, scale, causal, s);
    case 256:
      return (int)launch_dq_any<256>(dtype, q, k, v, dout, lse, delta, dq, b, h, d, sq, sk, strides, scale, causal, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int mxtt_flash_bwd_dkv(int dtype, int d, int width, const void* q,
                                  const void* k, const void* v,
                                  const void* dout, const float* lse,
                                  const float* delta, void* dk, void* dv,
                                  int b, int h, int sq, int sk,
                                  const int64_t* strides, float scale,
                                  int causal, void* stream, int* launched) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((dtype != 0 && dtype != 1) || d <= 0 || d > width)
    return (int)cudaErrorInvalidValue;
  switch (width) {
    case 64:
      return (int)launch_dkv_any<64>(dtype, q, k, v, dout, lse, delta, dk, dv, b, h, d, sq, sk, strides, scale, causal, s, launched);
    case 128:
      return (int)launch_dkv_any<128>(dtype, q, k, v, dout, lse, delta, dk, dv, b, h, d, sq, sk, strides, scale, causal, s, launched);
    case 256:
      return (int)launch_dkv_any<256>(dtype, q, k, v, dout, lse, delta, dk, dv, b, h, d, sq, sk, strides, scale, causal, s, launched);
  }
  return (int)cudaErrorInvalidValue;
}

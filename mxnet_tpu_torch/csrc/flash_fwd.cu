// Flash-attention forward for Hopper (sm_90a): a bfloat16 tensor-core
// kernel and a float32 CUDA-core kernel in one library.
//
// Replaces: mxnet_tpu/ops/attention.py::_fwd_kernel (launched by
// _flash_forward).  Same function: O = softmax(scale * Q Kᵀ) V with an
// online softmax, plus the natural-log logsumexp of every query row.
//
//   q       [b, sq, h, d]   read through its strides (unit stride in d)
//   k, v    [b, sk, h, d]   read through their strides (unit stride in d)
//   o       [b, sq, h, d]   contiguous, the input dtype
//   lse     [b*h, sq]       contiguous float32, natural log
//   d       32, 64, 96, 128 or 256
//
// Head dims: each kernel is instantiated at the widths D = 64, 128 and 256
// and takes the real d as an argument.  d = 32 runs at D = 64 and d = 96 at
// D = 128: the columns past d are zeros in shared memory (TMA fills them in
// bf16, the staging loops in float32), so the products are exact, and the
// stores of O are masked to the d columns.  The padding costs the products
// 2x at d = 32 and 1.33x at d = 96.
//
// Splash (`_contrib_SplashAttention`, upstream JAX's splash kernel) is the
// same function with q pre-scaled by the caller and scale 1; it keeps P in
// float32 for P V where K1 rounds it to bf16.  The bf16 kernel's kSplitP
// variant does that: P = P_hi + P_lo, both bf16 (P_lo the rounded
// remainder, so the pair carries ~16 bits of mantissa), and
// O += P_hi V + P_lo V as two groups of register-fed products.  The float32
// kernel keeps P in float32 already and serves splash unchanged.
//
// Both versions: one thread block owns one query tile and walks the key /
// value tiles in a loop inside the block, which takes the place of the TPU
// kernel's sequential third grid dimension.  The running max m, the running
// sum l and the O accumulator stay in float32 registers.  Scores live in
// the base-2 domain (scale * log2(e) folded into one multiply or FMA, then
// 2^x); the logsumexp goes back to natural log when it is written.  Causal mode is
// top-left aligned (query i sees keys j <= i, also when sq != sk): tiles
// wholly above the diagonal are never loaded, tiles that cross it or the
// ragged end of sk are masked.  Query rows past sq are computed but not
// written; a row with no visible key writes O = 0 and never divides by 0.
// The heaviest causal tiles (the last queries) are scheduled first.
//
// bfloat16: the tensor cores (the main path; `Module` trains in bf16).
//   One block of 384 threads per (b*h, 128-query tile): warpgroups 0 and 1
//   each own 64 of the queries, and one warp of warpgroup 2 feeds them.
//   That producer loads the block's Q once with TMA, then streams 128-key
//   tiles of K and V through a ring of two shared-memory slots guarded by
//   mbarriers (a "full" barrier per slot, on which TMA counts its bytes,
//   and an "empty" one on which every consumer warp arrives when the
//   products reading the slot are done).  Per tile each consumer warpgroup
//   computes S = Q Kᵀ (64 x 128) with wgmma (both operands K-major in
//   shared memory), takes the online softmax in registers (each thread
//   holds two rows of the score tile; a row's max reduces over the four
//   lanes of a quad, its sum stays a per-thread share until the end; the
//   exponentials are one FMA and one SFU ex2 each), rescales the O
//   accumulator, rounds P to bf16 and feeds it straight from the registers
//   as the A operand of O += P V, with V read MN-major through the
//   transpose bit: P never goes to shared memory.  The rounding places are
//   the JAX kernel's: the products read bf16 and sum in float32, l sums the
//   float32 P, P is rounded to the value dtype before P V, and O is rounded
//   once at the end.  All tiles arrive by TMA with the 128-byte swizzle
//   that the wgmma descriptors read (hopper.cuh); TMA fills rows past the
//   end of a sequence with zeros, and a tile that crosses sk is masked with
//   -inf explicitly (a zero score is not a masked score).  The producer
//   warpgroup gives up registers (setmaxnreg 24) so that each consumer
//   thread can hold 240: at d=128 the O accumulator takes 64 registers,
//   the score tile 64 and P 32 (split-P: 64).  Shared memory at d=128: Q
//   32 KB, two slots of K and V at 32 KB each, 160 KB in all, one block per
//   SM.  At D=256 the key tiles are 64 rows (S is m64n64): Q 64 KB and two
//   slots of 64-key K and V tiles (32 KB each) take 192 KB, where 128-key
//   tiles would need 320 KB; the O accumulator (m64n256) takes 128
//   registers.  What
//   bounds it: operations.  At b=4, s=4096, h=16, d=128 causal it does 4·d
//   operations per visible pair, ~0.275 TFLOP, 0.278 ms at the 989 TFLOP/s
//   bf16 dense peak, while its bytes (Q, K, V, O, lse, ~0.54 GB) take ~0.16
//   ms at 3.35 TB/s.  Inside the SM the softmax competes with the products:
//   each warpgroup waits for its own products and runs its softmax between
//   them, and the two warpgroups overlap only as the scheduler interleaves
//   them; the wider 128-key tile halves the waits and barriers per key.
//
// float32: the CUDA cores (TF32 would break the float32 contract).  One
//   block (256 threads, 16 x 16) per (b*h, 64-row query tile), 64-row key
//   tiles staged through shared memory.  Thread (ty, tx) owns query rows
//   4ty..4ty+3: a 4x4 block of scores (keys 4tx..4tx+3 of the tile) and a
//   4 x d/16 block of the O accumulator (columns 64g+4tx..64g+4tx+3).  Q
//   and K are staged transposed ([d][row]) so each step of the QKᵀ loop
//   reads the thread's four queries and four keys as two 16-byte loads;
//   the PV loop reads four probabilities and four values of V the same
//   way; the 16 threads that share a row reduce with warp shuffles.  What
//   bounds it: the 67 TFLOP/s float32 peak (4.1 ms at the shape above),
//   and inside the SM shared memory: a warp's QKᵀ step issues two 16-byte
//   loads per 16 FMAs, and a 16-byte warp load costs up to four wavefronts
//   against four warp-FMAs per clock, so the loop runs at no more than half
//   the FMA peak; the block waits at a barrier while it stages the next
//   tile.  Q and K are staged in 4-row x 8-column warp patches so the
//   global reads stay coalesced and, at row stride 68, the transposed
//   shared-memory writes stay conflict-free.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kNeg = -1e30f;   // initial running max (finite, as in the TPU kernel)
constexpr float kLn2 = 0.6931471805599453f;

// ===========================================================================
// bfloat16: tensor cores
// ===========================================================================

constexpr int kRes = 128;  // query rows per block: 2 consumer warpgroups
constexpr int kStages = 2;
constexpr int kTcThreads = 384;  // warpgroups 0, 1 consume; 2 loads

// Shared memory, in bytes from a 1024-aligned base: Q, kStages slots of a
// K tile and a V tile, the barriers.  kStr key rows per streamed tile: 128
// (S is m64n128), 64 at D = 256 so that the ring fits.
template <int D>
struct TcSmem {
  static constexpr int kStr = D > 128 ? 64 : 128;
  static constexpr int kQBytes = D / 64 * kRes * 128;
  static constexpr int kTileBytes = D / 64 * kStr * 128;
  static constexpr int kSlots = kQBytes;
  static constexpr int kBars = kSlots + kStages * 2 * kTileBytes;
  static constexpr int kBytes = kBars + (2 * kStages + 1) * 8;
  static constexpr int kAlloc = kBytes + 1024;
};

// O and lse for one (b*h, 128-query tile); d <= D is the real head dim.
template <int D, bool kSplitP>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                    int h, int d, int sq, int sk, float scale_log2,
                    int causal) {
  using L = TcSmem<D>;
  constexpr int kStr = L::kStr;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm =
      smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* q_bar = empty + kStages;

  const int bh = blockIdx.x;
  const int bi = bh / h;
  const int hi = bh % h;
  const int q0 = kRes * (gridDim.y - 1 - blockIdx.y);
  const int k_end = causal ? min(sk, q0 + kRes) : sk;
  const int n_tiles = (k_end + kStr - 1) / kStr;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);  // each consumer warp
    }
    hopper::mbar_init(q_bar, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread issues the TMA loads ----
    hopper::regs_release<24>();
    if (threadIdx.x % 128 != 0) return;
    hopper::mbar_arrive_expect_tx(q_bar, L::kQBytes);
    for (int c = 0; c < D / 64; ++c)
      hopper::tma_load_4d(sm + c * kRes * 128, &map_q, q_bar, 64 * c, hi, q0,
                          bi);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      hopper::mbar_wait(&empty[s], ((t / kStages) & 1) ^ 1);
      uint8_t* slot = sm + L::kSlots + s * 2 * L::kTileBytes;
      hopper::mbar_arrive_expect_tx(&full[s], 2 * L::kTileBytes);
      for (int c = 0; c < D / 64; ++c) {
        hopper::tma_load_4d(slot + c * kStr * 128, &map_k, &full[s], 64 * c,
                            hi, t * kStr, bi);
        hopper::tma_load_4d(slot + L::kTileBytes + c * kStr * 128, &map_v,
                            &full[s], 64 * c, hi, t * kStr, bi);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns queries rw .. rw + 63 ----
  hopper::regs_claim<240>();
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int c4 = lane % 4;
  const int rw = q0 + 64 * wg;
  const bool live = rw < sq;  // else no row of this warpgroup exists

  // accumulator layout (hopper.cuh): element 4j + 2x + y of a 64-row tile
  // is row 16 warp + g + 8x, column 8j + 2 c4 + y; this thread's two rows
  // are x = 0, 1.  l is this thread's share of the row sum (its 16 columns
  // per tile); the quad's four shares are added at the end.
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};

  // this warpgroup's 64 rows of Q (K-major); step offsets in 16-byte units
  const uint64_t da =
      hopper::desc_sw128(hopper::smem_addr(sm) + 64 * wg * 128, 16, 1024);

  hopper::mbar_wait(q_bar, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    const int k0 = t * kStr;
    hopper::mbar_wait(&full[s], (t / kStages) & 1);
    if (live && !(causal && k0 >= rw + 64)) {
      const bool masked = (causal && k0 + kStr > rw) || k0 + kStr > sk;
      const uint32_t slot =
          hopper::smem_addr(sm + L::kSlots + s * 2 * L::kTileBytes);
      const uint64_t db = hopper::desc_sw128(slot, 16, 1024);

      // S = Q Kᵀ, 64 x kStr, reduced over d
      float sc[kStr / 2];
#pragma unroll
      for (int i = 0; i < kStr / 2; ++i) sc[i] = 0.f;
      hopper::fence_regs(sc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t oa = ((kk / 4) * kRes * 128 + (kk % 4) * 32) >> 4;
        const uint32_t ob = ((kk / 4) * kStr * 128 + (kk % 4) * 32) >> 4;
        hopper::wgmma_ss<kStr>(sc, da + oa, db + ob, kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(sc);

      // online softmax over the tile, in float32: the max over the raw
      // scores (scale_log2 > 0), then 2^(s * scale_log2 - m) as one FMA
      // and one SFU instruction per score
      float corr[2];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int row = rw + 16 * warp + g + 8 * x;
        float mx = -CUDART_INF_F;
#pragma unroll
        for (int j = 0; j < kStr / 8; ++j)
#pragma unroll
          for (int y = 0; y < 2; ++y) {
            const int i = 4 * j + 2 * x + y;
            const int col = k0 + 8 * j + 2 * c4 + y;
            if (masked && !(col < sk && (!causal || col <= row)))
              sc[i] = -CUDART_INF_F;
            mx = fmaxf(mx, sc[i]);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[x], mx * scale_log2);
        corr[x] = hopper::exp2_approx(m[x] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < kStr / 8; ++j)
#pragma unroll
          for (int y = 0; y < 2; ++y) {
            const int i = 4 * j + 2 * x + y;
            // masked: 2^-inf = 0
            sc[i] = hopper::exp2_approx(fmaf(sc[i], scale_log2, -m_new));
            sum += sc[i];
          }
        l[x] = l[x] * corr[x] + sum;
        m[x] = m_new;
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i >> 1) & 1];

      // P rounded to bf16: the accumulator layout of columns 16k .. 16k + 15
      // is the A-operand layout of reduction step k
      uint32_t pf[kStr / 4];
#pragma unroll
      for (int i = 0; i < kStr / 4; ++i)
        pf[i] = hopper::pack_bf16(sc[2 * i], sc[2 * i + 1]);
      // split-P: the remainder P - P_hi (exact in float32), rounded to bf16
      uint32_t pl[kSplitP ? kStr / 4 : 1];
      if constexpr (kSplitP) {
#pragma unroll
        for (int i = 0; i < kStr / 4; ++i)
          pl[i] = hopper::pack_bf16(sc[2 * i] - hopper::bf16_lo(pf[i]),
                                    sc[2 * i + 1] - hopper::bf16_hi(pf[i]));
      }

      // O += P V: V as MN-major B, 16 keys per step, 64-column blocks
      // kStr * 128 bytes apart
      const uint64_t mb =
          hopper::desc_sw128(slot + L::kTileBytes, kStr * 128, 1024);
      hopper::fence_regs(acc);
      hopper::fence_regs(pf);
      if constexpr (kSplitP) hopper::fence_regs(pl);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kStr / 16; ++kk)
        hopper::wgmma_rs<D>(acc, &pf[4 * kk], mb + ((kk * 2048) >> 4));
      if constexpr (kSplitP) {
#pragma unroll
        for (int kk = 0; kk < kStr / 16; ++kk)
          hopper::wgmma_rs<D>(acc, &pl[4 * kk], mb + ((kk * 2048) >> 4));
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(acc);
      hopper::fence_regs(pf);
      if constexpr (kSplitP) hopper::fence_regs(pl);
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
  }

  if (!live) return;
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    float lt = l[x] + __shfl_xor_sync(0xffffffffu, l[x], 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int row = rw + 16 * warp + g + 8 * x;
    if (row >= sq) continue;
    const float lsafe = lt > 0.f ? lt : 1.f;
    const float inv = 1.f / lsafe;
    const int64_t off = (((int64_t)bi * sq + row) * h + hi) * d + 2 * c4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      if (8 * j < d)  // columns 8j + 2c4 (+1); d is a multiple of 32
        *reinterpret_cast<uint32_t*>(o + off + 8 * j) = hopper::pack_bf16(
            acc[4 * j + 2 * x] * inv, acc[4 * j + 2 * x + 1] * inv);
    if (c4 == 0) lse[(int64_t)bh * sq + row] = (m[x] + log2f(lsafe)) * kLn2;
  }
}

// strides: q, k, v, each (b, s, h), in elements.  Q's map takes boxes of
// kRes rows, K's and V's kStr; every map has the real head dim d.
template <int D, bool kSplitP>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      float* lse, int b, int h, int d, int sq, int sk,
                      const int64_t* st, float scale_log2, int causal,
                      cudaStream_t stream) {
  using L = TcSmem<D>;
  CUtensorMap mq, mk, mv;
  if (!hopper::encode_bshd_bf16(&mq, q, b, sq, h, d, st[0], st[1], st[2], kRes) ||
      !hopper::encode_bshd_bf16(&mk, k, b, sk, h, d, st[3], st[4], st[5], L::kStr) ||
      !hopper::encode_bshd_bf16(&mv, v, b, sk, h, d, st[6], st[7], st[8], L::kStr))
    return cudaErrorInvalidValue;
  const int smem = L::kAlloc;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<D, kSplitP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(b * h, (sq + kRes - 1) / kRes);
  flash_fwd_tc_kernel<D, kSplitP><<<grid, kTcThreads, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), lse, h, d, sq, sk,
      scale_log2, causal);
  return cudaGetLastError();
}

// ===========================================================================
// float32: CUDA cores
// ===========================================================================

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // key rows per inner tile
constexpr int kThreads = 256;    // 16 x 16 threads
constexpr int kTS = 68;          // row stride of the transposed Q, K, P tiles

// Max / sum across the 16 lanes that share one query row.
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// dst[c * kTS + r] = src[(row0 + r) * ss + c] for r < 64, c < D; rows at
// or past nrows, and with kPad columns at or past d, are zero.  A warp's 32
// elements are 4 rows x 8 consecutive columns: one 32-byte sector per row
// on the read side, and, as kTS = 4 (mod 32), 32 distinct banks on the
// transposed write side.
template <int D, bool kPad>
__device__ __forceinline__ void stage_transposed(float* dst, const float* src,
                                                 int64_t ss, int row0,
                                                 int nrows, int d) {
  for (int e = threadIdx.x; e < 64 * D; e += kThreads) {
    const int chunk = e >> 5;
    const int c = (chunk % (D / 8)) * 8 + (e & 7);
    const int r = (chunk / (D / 8)) * 4 + ((e >> 3) & 3);
    const int row = row0 + r;
    const bool in = kPad ? row < nrows && c < d : row < nrows;
    dst[c * kTS + r] = in ? src[row * ss + c] : 0.f;
  }
}

template <int D>
constexpr size_t smem_bytes() {
  // Q and K transposed ([D][kTS]; P [kBK][kTS] reuses the K tile once the
  // scores are taken), V row-major [kBK][D]
  return sizeof(float) * (2 * D * kTS + kBK * D);
}

// At D = 256 the tiles take 204,800 bytes: one block per SM.  kPad: d < D
// (the staging loops zero the columns past d, the stores skip them); the
// full-width instantiations carry no column test.
template <int D, bool kPad>
__global__ void __launch_bounds__(kThreads, D > 128 ? 1 : 2)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int h, int d, int sq, int sk,
                 int64_t q_sb, int64_t q_ss, int64_t q_sh,
                 int64_t k_sb, int64_t k_ss, int64_t k_sh,
                 int64_t v_sb, int64_t v_ss, int64_t v_sh,
                 float scale_log2, int causal) {
  constexpr int kG = D / 64;  // 4-column groups of O per thread
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // [D][kTS]
  float* kt = qt + D * kTS;                      // [D][kTS]
  float* pt = kt;                                // [kBK][kTS], after the scores
  float* vs = kt + D * kTS;                      // [kBK][D]

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int bh = blockIdx.x;
  const int bi = bh / h;
  const int hi = bh % h;
  // the heaviest causal tiles (last rows) are scheduled first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;

  const float* qb = q + bi * q_sb + hi * q_sh;
  const float* kb = k + bi * k_sb + hi * k_sh;
  const float* vb = v + bi * v_sb + hi * v_sh;

  stage_transposed<D, kPad>(qt, qb, q_ss, q0, sq, d);

  float m[4], l[4], acc[4][4 * kG];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * kG; ++c) acc[i][c] = 0.f;
  }

  const int k_end = causal ? min(sk, q0 + kBQ) : sk;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's P and V reads are done
    stage_transposed<D, kPad>(kt, kb, k_ss, k0, sk, d);
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, c = e % D;
      const int row = k0 + r;
      const bool in = kPad ? row < sk && c < d : row < sk;
      vs[e] = in ? vb[row * v_ss + c] : 0.f;
    }
    __syncthreads();  // Q (first tile), K and V staged

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 a = ld4(&qt[d * kTS + 4 * ty]);
      const float4 b = ld4(&kt[d * kTS + 4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + 4 * tx + j;
        const bool visible = col < sk && (!causal || row >= col);
        s[i][j] = visible ? s[i][j] * scale_log2 : -CUDART_INF_F;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = exp2f(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = exp2f(s[i][j] - m_new);  // masked: exp2(-inf) = 0
        sum += s[i][j];
      }
      l[i] = l[i] * corr + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * kG; ++c) acc[i][c] *= corr;
    }
    __syncthreads();  // every warp is done reading the K tile
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&pt[(4 * tx + j) * kTS + 4 * ty]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();  // P written

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 p = ld4(&pt[kk * kTS + 4 * ty]);
      const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        const float4 w = ld4(&vs[kk * D + 64 * g + 4 * tx]);
        const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[i][4 * g + c] = fmaf(pv[i], wv[c], acc[i][4 * g + c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= sq) continue;
    const float lsafe = l[i] > 0.f ? l[i] : 1.f;
    const float inv = 1.f / lsafe;
    float* orow = o + ((int64_t)(bi * sq + row) * h + hi) * d;
#pragma unroll
    for (int g = 0; g < kG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (!kPad || 64 * g + 4 * tx + c < d)
          orow[64 * g + 4 * tx + c] = acc[i][4 * g + c] * inv;
    if (tx == 0) lse[(int64_t)bh * sq + row] = (m[i] + log2f(lsafe)) * kLn2;
  }
}

template <int D, bool kPad>
cudaError_t launch_f32_at(const void* q, const void* k, const void* v,
                          void* o, float* lse, int b, int h, int d, int sq,
                          int sk, const int64_t* st, float scale_log2,
                          int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D, kPad>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(b * h, (sq + kBQ - 1) / kBQ);
  flash_fwd_kernel<D, kPad><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, h, d, sq, sk,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      scale_log2, causal);
  return cudaGetLastError();
}

// d = D, or (D = 64, 128) the padded d = 32, 96.
template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       float* lse, int b, int h, int d, int sq, int sk,
                       const int64_t* st, float scale_log2, int causal,
                       cudaStream_t stream) {
  if (d == D)
    return launch_f32_at<D, false>(q, k, v, o, lse, b, h, d, sq, sk, st,
                                   scale_log2, causal, stream);
  if constexpr (D < 256)
    return launch_f32_at<D, true>(q, k, v, o, lse, b, h, d, sq, sk, st,
                                  scale_log2, causal, stream);
  return cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v,
                   void* o, float* lse, int b, int h, int d, int sq, int sk,
                   const int64_t* st, float scale_log2, int causal,
                   int split_p, cudaStream_t s) {
  if (dtype == 0)
    return launch_f32<D>(q, k, v, o, lse, b, h, d, sq, sk, st, scale_log2, causal, s);
  if (split_p)
    return launch_tc<D, true>(q, k, v, o, lse, b, h, d, sq, sk, st, scale_log2, causal, s);
  return launch_tc<D, false>(q, k, v, o, lse, b, h, d, sq, sk, st, scale_log2, causal, s);
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores; every view
// needs a 16-byte aligned base and (b, s, h) strides that are multiples of
// 8 elements, or the entry returns cudaErrorInvalidValue).  d: the head dim;
// width: the instantiated width it runs at (64, 128 or 256, d <= width; the
// caller's ops/attention.py::kernel_width picks it, columns past d are
// zeros).  strides: q (b, s, h), k (b, s, h), v (b, s, h) in elements
// (9 values, host memory).  split_p (bf16 only): keep P in float32
// precision for P V as the split bf16 pair (splash).  Launches on `stream`
// without synchronising and returns cudaGetLastError() of the launch (0 on
// success).
extern "C" int mxtt_flash_fwd(int dtype, int d, int width, const void* q,
                              const void* k, const void* v, void* o,
                              float* lse, int b, int h, int sq, int sk,
                              const int64_t* strides, float scale_log2,
                              int causal, int split_p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((dtype != 0 && dtype != 1) || d <= 0 || d > width)
    return (int)cudaErrorInvalidValue;
  switch (width) {
    case 64:
      return (int)launch<64>(dtype, q, k, v, o, lse, b, h, d, sq, sk, strides, scale_log2, causal, split_p, s);
    case 128:
      return (int)launch<128>(dtype, q, k, v, o, lse, b, h, d, sq, sk, strides, scale_log2, causal, split_p, s);
    case 256:
      return (int)launch<256>(dtype, q, k, v, o, lse, b, h, d, sq, sk, strides, scale_log2, causal, split_p, s);
  }
  return (int)cudaErrorInvalidValue;
}

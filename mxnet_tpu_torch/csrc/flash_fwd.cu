// Flash-attention forward for Hopper (sm_90a): two tensor-core kernels in
// one library, bfloat16 (wgmma fed by TMA) and float32 (split TF32 on
// wgmma, fed by cp.async).
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
// bf16, cp.async's zero fill and the Q loader in float32), so the products
// are exact, and the
// stores of O are masked to the d columns.  The padding costs the products
// 2x at d = 32 and 1.33x at d = 96.
//
// Splash (`_contrib_SplashAttention`, upstream JAX's splash kernel) is the
// same function with q pre-scaled by the caller and scale 1; it keeps P in
// float32 for P V where K1 rounds it to bf16.  The bf16 kernel's kSplitP
// variant does that: P = P_hi + P_lo, both bf16 (P_lo the rounded
// remainder, so the pair carries ~16 bits of mantissa), and
// O += P_hi V + P_lo V as two groups of register-fed products: 6·d
// operations per visible pair where the function needs 4·d.  The float32
// kernel keeps P at float32 precision already (split TF32) and serves
// splash unchanged.
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
//   tiles of K and V through a ring of two shared-memory slots each, K and
//   V apart, guarded by mbarriers (a "full" barrier per slot, on which TMA
//   counts its bytes, and an "empty" one on which every consumer warp
//   arrives when the products reading the slot are done: a K tile is
//   released once its S is done, a V tile once its P V is).  Per tile each
//   consumer warpgroup computes S = Q Kᵀ (64 x 128) with wgmma (both
//   operands K-major in shared memory), takes the online softmax in
//   registers (each thread holds two rows of the score tile; a row's max
//   reduces over the four lanes of a quad, its sum stays a per-thread share
//   until the end; the exponentials are one FMA and one SFU ex2 each),
//   rounds P to bf16 pairs in place, rescales the O accumulator and feeds P
//   straight from the registers as the A operand of O += P V, with V read
//   MN-major through the transpose bit: P never goes to shared memory.  The
//   rounding places are the JAX kernel's: the products read bf16 and sum in
//   float32, l sums the float32 P, P is rounded to the value dtype before
//   P V, and O is rounded once at the end.  All tiles arrive by TMA with
//   the 128-byte swizzle that the wgmma descriptors read (hopper.cuh); TMA
//   fills rows past the end of a sequence with zeros, and a tile that
//   crosses sk is masked with -inf explicitly (a zero score is not a masked
//   score).  At D=256 the key tiles are 64 rows (S is m64n64).
//
//   The schedule, the same at every width for K1 and split-P:
//   - pipelined: each warpgroup issues S_{t+1} before P·V_t, waits for S
//     alone (wgmma.wait_group 1), and takes the softmax of tile t+1 while
//     P·V_t runs; then O is rescaled and the next P taken into the A
//     registers.  The exponentials, the sums and the bf16 packing of P all
//     run under the products in flight; what follows the wait is the
//     rescale and one permute per register of P (a plain copy there the
//     assembler folds into the registers of the products in flight, and
//     then it serializes every wgmma; so do mbarrier spins between the
//     wgmma fence and the products, which is why every wait on a tile
//     comes before the fence).
//   - ping-pong: the two warpgroups take turns at issuing their products
//     (named barriers 1 and 2), so that one's softmax runs under the
//     other's products.  Both then run the same tiles, the busier one's (a
//     tile wholly masked for a warpgroup leaves its O, l and m as they
//     were), so that their turns pair up.
//   - block order: kHeadGroup = 4 heads at a time, each group's query
//     tiles heaviest first across its heads, so that the ~132 blocks in
//     flight share the K and V of 4 heads in L2.  One grid row per query
//     tile across every head had the blocks in flight stream ~132 heads'
//     K and V (128 MB at b=4, s=4096, h=16, d=128, past the 50 MB L2), and
//     the loads alone then took about as long as the whole kernel (measured
//     with parts of the tile loop compiled out).
//   - ring: two slots of K and two of V.  A third (D <= 128: 224 KB of the
//     232,448 bytes a block may use) reads within 3% of two either way,
//     since K and V released apart already give each load a tile of slack.
//   Each setting was chosen by timing the alternatives against it in one
//   call (chip_smoke.py --parent-csrc, each on a build of this file with
//   that one setting changed, all giving these bits; PERF.md §6 has the
//   times).  At b=4, s=4096, h=16, d=128 causal on an H100 80GB HBM3 at
//   700 W, split-P / K1 took, relative to this schedule: the products and
//   the softmax in turn +13% / +10%; pipelined without ping-pong +8% /
//   +8%; one grid row per query tile +1% / +6%; groups of 1 head +5% /
//   +4%, of 16 heads -1% / -1%; three slots -1% / +0%.
//   Registers per consumer thread (setmaxnreg: the producer gives up its
//   own, 24, so that each consumer thread holds 240): at D = 128 O 64, S /
//   P 64 and P's A registers 32 (split-P: 64, P_lo too), 192 of 240 with
//   both live across the softmax; D = 64: 160; D = 256 (O 128, S 32, P 16
//   + 16): 192.  Shared memory: Q 16 / 32 / 64 KB and two slots of K and V
//   (16 / 32 / 32 KB a tile) at D = 64 / 128 / 256: 80, 160 and 192 KB,
//   one block per SM.
//   What bounds it: operations.  At b=4, s=4096, h=16, d=128 causal K1
//   does 4·d operations per visible pair, ~0.275 TFLOP, 0.278 ms at the 989
//   TFLOP/s bf16 dense peak, and split-P issues 6·d (0.417 ms), while the
//   bytes (Q, K, V, O, lse, ~0.54 GB) take ~0.16 ms at 3.35 TB/s.  Split-P
//   is bound by its products: with the loads and the softmax compiled out
//   they alone took most of its time, so the 6·d count, not the 4·d
//   bound, is its floor on this card.
//
// float32: the tensor cores, by the split-TF32 product of the float32 K2/K3
//   (hopper.cuh, tf32.cuh): x = x_hi + x_lo, both rounded to TF32 by
//   cvt.rna, and A·B = A_lo·B_hi + A_hi·B_lo + A_hi·B_hi summed in float32
//   (A_lo·B_lo, ~2^-22 relative, dropped), which errs in the class of a
//   float32 sum; one TF32 product alone (~2^-11 per operand) would not.
//   The tensor cores' float32 accumulation truncates, so no chain of
//   products is longer than 12 before a float32 add that rounds to
//   nearest: S sums each 32 columns of d (4 k-steps x 3 terms) in a zeroed
//   part, and P V each tile's 32 keys (16 at D = 256) in a zeroed part per
//   64 columns of O.  The softmax is the float32 one of the JAX kernel, in
//   registers: accurate exp2f and log2f, masked keys -inf.
//   One block of 256 threads per (b*h, 128-query tile): each warpgroup owns
//   64 queries.  Q, the one resident tensor, is read once and split once
//   into hi and lo planes in shared memory (wgmma's no-swizzle core-matrix
//   layout, K = d), so that S = Q Kᵀ runs as SS wgmma m64n32k8 with no
//   split in the loop.  K and V stream in 32-key tiles: all threads land a
//   tile by cp.async (16-byte copies when every base and stride allows,
//   else 4-byte ones, so every float32 view with unit stride in d runs;
//   zero fill past sk and past d), split it once into natural planes of K
//   (B of S) and transposed planes of V (B of P V: a tf32 wgmma reads
//   shared memory K-major only), then issue the next tile's copies, which
//   land while this tile is computed.  P forms in the score accumulator,
//   whose registers are the A fragments of P V (keys 2c, 2c + 1 in k-slots
//   c, c + 4, as the transposed planes store them): P is split in
//   registers and never goes to shared memory; O += P V runs as RS wgmma
//   m64n64k8 per 64 columns, two parts in flight.
//   Budget at D = 128 (F32Fwd): Q planes 128 KB, the tile's planes 64 KB,
//   the raw tile 33 KB: 230,400 of the 232,448 bytes a block may use.
//   Registers: O 64, two P V parts 64, P's fragments 32, S 16 and two S
//   parts 32.  The alternatives that lost: 64-query blocks (160 KB at
//   32-key tiles, one warpgroup per SM, nothing to overlap its softmax
//   with); Q kept raw and split per step in registers, as K2/K3 keep their
//   resident rows (64-key tiles would still not fit, and the split per
//   step is what sets K2/K3's pace); 16-key tiles (S as m64n16 reads its A
//   operand from shared memory once per 16 keys, twice as often).  At
//   D = 256 two warpgroups' Q planes alone take 256 KB: one warpgroup, 64
//   queries and 16-key tiles (229,888 B), P V one part at a time (O takes
//   128 registers).
//   What bounds it: operations, three TF32 products per product: 4·d per
//   visible pair x 3 over 495 TFLOP/s, at b=4, s=4096, h=16, d=128 causal
//   1.666 ms; its bytes (q, k, v, o, lse: 0.54 GB) take 0.16 ms.  Inside the SM, S's SS products read
//   their A operand (Q) from shared memory at N = 32, near the 128 bytes a
//   clock shared memory gives, and the split of each tile and the softmax
//   run between the products: the block's two warpgroups overlap them only
//   as the scheduler interleaves them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper.cuh"
#include "tf32.cuh"

namespace {

// View, make_views, stage_async, kChunkK, store_natural, split_natural,
// split_transposed, issue_part, add_part
using namespace tf32;

constexpr float kNeg = -1e30f;   // initial running max (finite, as in the TPU kernel)
constexpr float kLn2 = 0.6931471805599453f;

// x, hidden from the optimizer, so that values formed from it (the
// descriptors of a tile's steps) are formed where they are used and not
// hoisted out of the tile loop into registers that stay live
template <class T>
__device__ __forceinline__ T opaque(T x) {
  if constexpr (sizeof(T) == 8)
    asm volatile("" : "+l"(x));
  else
    asm volatile("" : "+r"(x));
  return x;
}

// ===========================================================================
// bfloat16: tensor cores
// ===========================================================================

constexpr int kRes = 128;  // query rows per block: 2 consumer warpgroups
constexpr int kTcThreads = 384;  // warpgroups 0, 1 consume; 2 loads

constexpr int kStages = 2;  // ring slots for K and for V
constexpr int kHeadGroup = 4;  // heads whose query tiles run together

// Shared memory, in bytes from a 1024-aligned base: Q, kStages slots of a
// K tile and a V tile, the barriers (full and empty per slot, for K and V
// apart, and Q's).  kStr key rows per streamed tile: 128 (S is m64n128),
// 64 at D = 256 so that the ring fits.
template <int D>
struct TcSmem {
  static constexpr int kStr = D > 128 ? 64 : 128;
  static constexpr int kQBytes = D / 64 * kRes * 128;
  static constexpr int kTileBytes = D / 64 * kStr * 128;
  static constexpr int kSlots = kQBytes;
  static constexpr int kBars = kSlots + kStages * 2 * kTileBytes;
  static constexpr int kBytes = kBars + (4 * kStages + 1) * 8;
  static constexpr int kAlloc = kBytes + 1024;
  static_assert(kAlloc <= 232448, "the ring does not fit in shared memory");
};

// O and lse for one (b*h, 128-query tile); d <= D is the real head dim.
// The schedule is in the notes at the top.
template <int D, bool kSplitP>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                    int h, int d, int sq, int sk, float scale_log2,
                    int causal, int n_bh) {
  using L = TcSmem<D>;
  constexpr int kStr = L::kStr;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm =
      smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* fullk = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* fullv = fullk + kStages;
  uint64_t* emptyk = fullv + kStages;
  uint64_t* emptyv = emptyk + kStages;
  uint64_t* q_bar = emptyv + kStages;

  // this block's (b*h, query tile): kHeadGroup heads at a time, each
  // group's query tiles heaviest first across its heads
  const int nq = (sq + kRes - 1) / kRes;
  const int g0 = blockIdx.x / (kHeadGroup * nq) * kHeadGroup;
  const int gsz = min(kHeadGroup, n_bh - g0);
  const int within = blockIdx.x - g0 * nq;
  const int bh = g0 + within % gsz;
  const int qt = nq - 1 - within / gsz;
  const int bi = bh / h;
  const int hi = bh % h;
  const int q0 = kRes * qt;
  const int k_end = causal ? min(sk, q0 + kRes) : sk;
  const int n_tiles = (k_end + kStr - 1) / kStr;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&fullk[s], 1);
      hopper::mbar_init(&fullv[s], 1);
      hopper::mbar_init(&emptyk[s], 8);  // each consumer warp
      hopper::mbar_init(&emptyv[s], 8);
    }
    hopper::mbar_init(q_bar, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread issues the TMA loads, K then V per tile ----
    hopper::regs_release<24>();
    if (threadIdx.x % 128 != 0) return;
    hopper::mbar_arrive_expect_tx(q_bar, L::kQBytes);
    for (int c = 0; c < D / 64; ++c)
      hopper::tma_load_4d(sm + c * kRes * 128, &map_q, q_bar, 64 * c, hi, q0,
                          bi);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      const uint32_t ph = ((t / kStages) & 1) ^ 1;
      uint8_t* slot = sm + L::kSlots + s * 2 * L::kTileBytes;
      hopper::mbar_wait(&emptyk[s], ph);
      hopper::mbar_arrive_expect_tx(&fullk[s], L::kTileBytes);
      for (int c = 0; c < D / 64; ++c)
        hopper::tma_load_4d(slot + c * kStr * 128, &map_k, &fullk[s], 64 * c,
                            hi, t * kStr, bi);
      hopper::mbar_wait(&emptyv[s], ph);
      hopper::mbar_arrive_expect_tx(&fullv[s], L::kTileBytes);
      for (int c = 0; c < D / 64; ++c)
        hopper::tma_load_4d(slot + L::kTileBytes + c * kStr * 128, &map_v,
                            &fullv[s], 64 * c, hi, t * kStr, bi);
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
  // the tiles a warpgroup whose first row is r computes: a prefix of the
  // block's (causal tiles wholly above its rows come last), none if r >= sq.
  // Both warpgroups take the busier one's tiles, so that they take the
  // same ping-pong turns (a tile wholly masked for a warpgroup leaves its
  // O, l and m as they were; rows past sq are not written)
  const auto visible = [&](int r) {
    if (r >= sq) return 0;
    return causal ? min(n_tiles, (r + 64 + kStr - 1) / kStr) : n_tiles;
  };
  const int n_vis = max(visible(q0), visible(q0 + 64));

  // accumulator layout (hopper.cuh): element 4j + 2x + y of a 64-row tile
  // is row 16 warp + g + 8x, column 8j + 2 c4 + y; this thread's two rows
  // are x = 0, 1.  l is this thread's share of the row sum (its 16 columns
  // per tile); the quad's four shares are added at the end.
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  float sc[kStr / 2];  // S of one tile, then P packed in bf16 (softmax)
  // P rounded to bf16 (split-P: and the rounded remainder) as the A
  // operand of P·V: the accumulator layout of columns 16k .. 16k + 15 is
  // the A-operand layout of reduction step k
  uint32_t pf[kStr / 4];
  uint32_t pl[kSplitP ? kStr / 4 : 1];

  // this warpgroup's 64 rows of Q (K-major); step offsets in 16-byte units
  const uint64_t da =
      hopper::desc_sw128(hopper::smem_addr(sm) + 64 * wg * 128, 16, 1024);
  const uint32_t slots = hopper::smem_addr(sm + L::kSlots);

  // a tile's K and V as they land: waited on before the wgmma fence, so
  // that no spin loop stands between the fence and the products (ptxas
  // would serialize every wgmma of the kernel)
  auto wait_k = [&](int t) {
    hopper::mbar_wait(&fullk[t % kStages], (t / kStages) & 1);
  };
  auto wait_v = [&](int t) {
    hopper::mbar_wait(&fullv[t % kStages], (t / kStages) & 1);
  };
  // S = Q K_tᵀ, 64 x kStr, reduced over d (the first step overwrites sc)
  auto issue_s = [&](int t) {
    const uint64_t a = opaque(da);
    const uint64_t db = hopper::desc_sw128(
        opaque(slots) + (t % kStages) * 2 * L::kTileBytes, 16, 1024);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t oa = ((kk / 4) * kRes * 128 + (kk % 4) * 32) >> 4;
      const uint32_t ob = ((kk / 4) * kStr * 128 + (kk % 4) * 32) >> 4;
      hopper::wgmma_ss<kStr>(sc, a + oa, db + ob, kk > 0);
    }
    hopper::wgmma_commit();
  };
  // O += P V_t: V as MN-major B, 16 keys per step, 64-column blocks
  // kStr * 128 bytes apart; split-P adds P_lo V as a second group of steps
  auto issue_pv = [&](int t) {
    const uint64_t mb = hopper::desc_sw128(
        opaque(slots) + (t % kStages) * 2 * L::kTileBytes + L::kTileBytes,
        kStr * 128, 1024);
#pragma unroll
    for (int kk = 0; kk < kStr / 16; ++kk)
      hopper::wgmma_rs<D>(acc, &pf[4 * kk], mb + ((kk * 2048) >> 4));
    if constexpr (kSplitP) {
#pragma unroll
      for (int kk = 0; kk < kStr / 16; ++kk)
        hopper::wgmma_rs<D>(acc, &pl[4 * kk], mb + ((kk * 2048) >> 4));
    }
    hopper::wgmma_commit();
  };
  // pin what an issued P·V reads and writes until its wait
  auto fence_pv = [&] {
    hopper::fence_regs(acc);
    hopper::fence_regs(pf);
    if constexpr (kSplitP) hopper::fence_regs(pl);
  };
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(bar);
  };
  // online softmax over tile t in sc, in float32: the max over the raw
  // scores (scale_log2 > 0), then 2^(s * scale_log2 - m) as one FMA and
  // one SFU instruction per score; corr rescales what O holds.  Each pair
  // of P (columns 2i, 2i + 1 of a row) is then rounded to bf16 in place:
  // sc[2i] holds the pair, and for split-P sc[2i + 1] the rounded
  // remainders P - P_hi (exact in float32), each with its halves swapped.
  // So the conversions run here, under the products in flight, and
  // rescale_pack swaps the halves back into pf and pl: one permute each,
  // an instruction of its own (a plain copy the assembler may fold into
  // the registers of the products in flight, and then it serializes them)
  auto softmax = [&](int t, float(&corr)[2]) {
    const int k0 = t * kStr;
    const bool masked = (causal && k0 + kStr > rw) || k0 + kStr > sk;
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      // keys at or past lim are masked: past sk, or above the diagonal
      const int row = rw + 16 * warp + g + 8 * x;
      const int lim = (causal ? min(sk, row + 1) : sk) - k0 - 2 * c4;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < kStr / 8; ++j)
#pragma unroll
        for (int y = 0; y < 2; ++y) {
          const int i = 4 * j + 2 * x + y;
          if (masked && 8 * j + y >= lim) sc[i] = -CUDART_INF_F;
          mx = fmaxf(mx, sc[i]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[x], mx * scale_log2);
      corr[x] = hopper::exp2_approx(m[x] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kStr / 8; ++j) {
        const int i = 4 * j + 2 * x;
        // masked: 2^-inf = 0
        const float p0 = hopper::exp2_approx(fmaf(sc[i], scale_log2, -m_new));
        const float p1 =
            hopper::exp2_approx(fmaf(sc[i + 1], scale_log2, -m_new));
        sum += p0;
        sum += p1;
        const uint32_t hi = hopper::pack_bf16(p1, p0);  // swapped
        sc[i] = __uint_as_float(hi);
        if constexpr (kSplitP)
          sc[i + 1] = __uint_as_float(hopper::pack_bf16(
              p1 - hopper::bf16_lo(hi), p0 - hopper::bf16_hi(hi)));
      }
      l[x] = l[x] * corr[x] + sum;
      m[x] = m_new;
    }
  };
  // O *= corr, then softmax's packed P into pf (and pl), halves swapped
  // back: pf[i] as pack_bf16(P[2i], P[2i + 1])
  auto rescale_pack = [&](const float(&corr)[2]) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
#pragma unroll
    for (int i = 0; i < kStr / 4; ++i) {
      pf[i] = __byte_perm(__float_as_uint(sc[2 * i]), 0u, 0x1032);
      if constexpr (kSplitP)
        pl[i] = __byte_perm(__float_as_uint(sc[2 * i + 1]), 0u, 0x1032);
    }
  };

  // ping-pong: a turn is one issue of products, n_vis + 1 of them.
  // Warpgroup 0 waits on barrier 1 and hands over on 2, warpgroup 1 the
  // reverse; warpgroup 1 opens with a hand-over and skips its last, so
  // that the barriers pair up.
  int turn = 0;
  if (wg == 1 && n_vis > 0) hopper::bar_arrive(1, 256);
  auto turn_begin = [&] { hopper::bar_sync(1 + wg, 256); };
  auto turn_end = [&] {
    if (wg == 0 || turn < n_vis) hopper::bar_arrive(2 - wg, 256);
    ++turn;
  };

  hopper::mbar_wait(q_bar, 0);
  float corr[2];
  if (n_vis > 0) {
    wait_k(0);
    turn_begin();
    hopper::wgmma_fence();
    issue_s(0);
    turn_end();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);
    release(&emptyk[0]);
    softmax(0, corr);
    rescale_pack(corr);
    for (int t = 0; t + 1 < n_vis; ++t) {
      wait_k(t + 1);
      wait_v(t);
      fence_pv();
      turn_begin();
      hopper::wgmma_fence();
      issue_s(t + 1);
      issue_pv(t);
      turn_end();
      hopper::wgmma_wait<1>();  // S_{t+1} done, P·V_t in flight
      hopper::fence_regs(sc);
      release(&emptyk[(t + 1) % kStages]);
      softmax(t + 1, corr);
      hopper::wgmma_wait<0>();
      fence_pv();
      release(&emptyv[t % kStages]);
      rescale_pack(corr);
    }
    wait_v(n_vis - 1);
    fence_pv();
    turn_begin();
    hopper::wgmma_fence();
    issue_pv(n_vis - 1);
    turn_end();
    hopper::wgmma_wait<0>();
    fence_pv();
    release(&emptyv[(n_vis - 1) % kStages]);
  }
  // the tiles this warpgroup skips: their slots are released in turn
  for (int t = n_vis; t < n_tiles; ++t) {
    wait_k(t);
    wait_v(t);
    release(&emptyk[t % kStages]);
    release(&emptyv[t % kStages]);
  }

  if (n_vis == 0) return;
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
  const int nq = (sq + kRes - 1) / kRes;
  flash_fwd_tc_kernel<D, kSplitP><<<b * h * nq, kTcThreads, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), lse, h, d, sq, sk,
      scale_log2, causal, b * h);
  return cudaGetLastError();
}

// ===========================================================================
// float32: tensor cores, split TF32
// ===========================================================================

// Tile sizes and shared memory, in bytes.  kWgs consumer warpgroups own
// 64 query rows each; key tiles of kStr rows stream through one raw slot.
// Q's hi and lo planes (natural, R = kRows, K = D), the streamed K tile's
// (natural, R = kStr) and V tile's (transposed, R = D, K = kStr), then the
// raw K and V tiles as cp.async lands them (row stride D + 4 floats).
//   D = 64:  2 warpgroups, 32-key tiles: 115,712 B
//   D = 128: 2 warpgroups, 32-key tiles: Q 131,072 + planes 65,536 + raw
//            33,792 = 230,400 B of the 232,448 a block may use
//   D = 256: 1 warpgroup,  16-key tiles: Q 131,072 + planes 65,536 + raw
//            33,280 = 229,888 B (two warpgroups' Q planes alone are 256 KB)
template <int D>
struct F32Fwd {
  static constexpr int kWgs = D > 128 ? 1 : 2;
  static constexpr int kThreads = 128 * kWgs;
  static constexpr int kRows = 64 * kWgs;         // query rows per block
  static constexpr int kStr = D > 128 ? 16 : 32;  // keys per streamed tile
  static constexpr int kSDr = D + 4;              // raw tile row stride
  static constexpr int kQB = kRows * D * 4;       // one Q plane
  static constexpr int kTB = kStr * D * 4;        // one tile plane
  static constexpr int kK = 2 * kQB;              // K hi, lo
  static constexpr int kV = kK + 2 * kTB;         // V hi, lo
  static constexpr int kRaw = kV + 2 * kTB;       // raw K, raw V
  static constexpr int kBytes = kRaw + 2 * kStr * kSDr * 4;
};

// s = Q Kᵀ for one warpgroup's 64 rows and kStr keys by SS wgmma
// (m64nkStr k8), A = the Q planes, B = the K planes (descriptors of their
// first 8-column step; a step is 32 R bytes into a plane of R rows).  The
// three terms of kChunkK columns (12 products) sum in a zeroed part, added
// to s in float32; two parts alternate, so one is added while the next is
// computed.
template <int D, int kRows, int kStr>
__device__ __forceinline__ void score_ss(float (&s)[kStr / 2], uint64_t qh,
                                         uint64_t ql, uint64_t kh,
                                         uint64_t kl) {
  constexpr int kSteps = kChunkK / 8, kChunks = D / kChunkK;
  auto issue = [&](int ch, float(&part)[kStr / 2]) {
    hopper::fence_regs(part);
    hopper::wgmma_fence();
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      const int kk = ch * kSteps + i;
      const uint32_t oq = (kk * 32 * kRows) >> 4, ok = (kk * 32 * kStr) >> 4;
      hopper::wgmma_tf32_ss<kStr>(part, ql + oq, kh + ok, i > 0);
      hopper::wgmma_tf32_ss<kStr>(part, qh + oq, kl + ok, 1);
      hopper::wgmma_tf32_ss<kStr>(part, qh + oq, kh + ok, 1);
    }
    hopper::wgmma_commit();
  };
  auto add = [&](float(&part)[kStr / 2]) {
    hopper::fence_regs(part);
#pragma unroll
    for (int i = 0; i < kStr / 2; ++i) s[i] += part[i];
  };
  float pa[kStr / 2], pb[kStr / 2];
  issue(0, pa);
#pragma unroll
  for (int ch = 1; ch < kChunks; ++ch) {
    if (ch & 1)
      issue(ch, pb);
    else
      issue(ch, pa);
    hopper::wgmma_wait<1>();
    if (ch & 1)
      add(pa);
    else
      add(pb);
  }
  hopper::wgmma_wait<0>();
  if constexpr ((kChunks - 1) & 1)
    add(pb);
  else
    add(pa);
}

// O and lse for one (b*h, kRows-query tile); d <= D is the real head dim.
template <int D>
__global__ void __launch_bounds__(F32Fwd<D>::kThreads, 1)
flash_fwd_tf32_kernel(View q, View k, View v, float* __restrict__ o,
                      float* __restrict__ lse, int h, int d, int sq, int sk,
                      float scale_log2, int causal, int vec) {
  using L = F32Fwd<D>;
  constexpr int kRows = L::kRows, kStr = L::kStr, kSDr = L::kSDr;
  constexpr int kJ = kStr / 8;  // 8-key blocks of a score tile
  extern __shared__ float4 smem4[];
  uint8_t* const sm = reinterpret_cast<uint8_t*>(smem4);
  float* const raw = reinterpret_cast<float*>(sm + L::kRaw);

  const int bh = blockIdx.x;
  const int bi = bh / h;
  const int hi = bh % h;
  const int q0 = kRows * (gridDim.y - 1 - blockIdx.y);
  const int k_end = causal ? min(sk, q0 + kRows) : sk;
  const int n_tiles = (k_end + kStr - 1) / kStr;
  const bool vecb = vec != 0;
  const float* pq = q.p + bi * q.b + hi * q.h;
  const float* pk = k.p + bi * k.b + hi * k.h;
  const float* pv = v.p + bi * v.b + hi * v.h;

  auto load_tile = [&](int t) {
    stage_async<D, L::kThreads>(raw, pk, k.s, t * kStr, sk, kStr, d, vecb);
    stage_async<D, L::kThreads>(raw + kStr * kSDr, pv, v.s, t * kStr, sk,
                                kStr, d, vecb);
    hopper::cp_async_commit();
  };
  load_tile(0);  // in flight while Q is split

  // Q once, straight from device memory into its hi and lo planes: rows
  // past sq and columns past d are zeros
  for (int e = threadIdx.x; e < kRows * D / 4; e += L::kThreads) {
    const int r = e / (D / 4), c4 = e % (D / 4);
    const int row = q0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < sq && 4 * c4 < d) {  // d % 32 == 0
      const float* src = pq + row * q.s + 4 * c4;
      x = vecb ? *reinterpret_cast<const float4*>(src)
               : make_float4(src[0], src[1], src[2], src[3]);
    }
    store_natural<kRows>(sm, sm + L::kQB, r, c4, x);
  }

  const int tid = threadIdx.x % 128;
  const int wg = threadIdx.x / 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int c = lane % 4;
  const int rg = q0 + 64 * wg;  // the warpgroup's first query row
  const bool live = rg < sq;

  const uint32_t base = hopper::smem_addr(sm);
  const uint64_t dqh =
      hopper::desc_plain(base + 1024 * wg, 16 * kRows, 128);  // its 64 rows
  const uint64_t dql =
      hopper::desc_plain(base + L::kQB + 1024 * wg, 16 * kRows, 128);
  const uint64_t dkh = hopper::desc_plain(base + L::kK, 16 * kStr, 128);
  const uint64_t dkl = hopper::desc_plain(base + L::kK + L::kTB, 16 * kStr, 128);
  const uint64_t dvh = hopper::desc_plain(base + L::kV, 16 * D, 128);
  const uint64_t dvl = hopper::desc_plain(base + L::kV + L::kTB, 16 * D, 128);

  // accumulator layout (hopper.cuh): element 4j + 2x + y is row 16 warp +
  // g + 8x, column 8j + 2c + y; l is this thread's share of the row sum
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    hopper::cp_async_wait<0>();
    __syncthreads();  // raw tile t landed; every read of tile t - 1 done
    split_natural<D, kStr, L::kThreads>(sm + L::kK, sm + L::kK + L::kTB, raw);
    split_transposed<D, kStr, L::kThreads>(sm + L::kV, sm + L::kV + L::kTB,
                                           raw + kStr * kSDr);
    hopper::fence_proxy_async();
    __syncthreads();  // the planes of tile t (and Q's) written; raw free
    if (t + 1 < n_tiles) load_tile(t + 1);

    const int k0 = t * kStr;
    if (!live || (causal && k0 >= rg + 64)) continue;  // per warpgroup
    const bool masked = (causal && k0 + kStr > rg) || k0 + kStr > sk;

    float sc[kStr / 2];
#pragma unroll
    for (int i = 0; i < kStr / 2; ++i) sc[i] = 0.f;
    score_ss<D, kRows, kStr>(sc, dqh, dql, dkh, dkl);

    // online softmax in float32: the max over the raw scores (scale_log2
    // > 0), then exp2f(s * scale_log2 - m) with one rounding (FMA); keys
    // past sk and above the diagonal are -inf (a zero-filled key is not a
    // masked one)
    float corr[2];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int row = rg + 16 * warp + g + 8 * x;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < kJ; ++j)
#pragma unroll
        for (int y = 0; y < 2; ++y) {
          const int i = 4 * j + 2 * x + y;
          const int col = k0 + 8 * j + 2 * c + y;
          if (masked && !(col < sk && (!causal || col <= row)))
            sc[i] = -CUDART_INF_F;
          mx = fmaxf(mx, sc[i]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[x], mx * scale_log2);
      corr[x] = exp2f(m[x] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kJ; ++j)
#pragma unroll
        for (int y = 0; y < 2; ++y) {
          const int i = 4 * j + 2 * x + y;
          sc[i] = exp2f(fmaf(sc[i], scale_log2, -m_new));  // masked: 0
          sum += sc[i];
        }
      l[x] = l[x] * corr[x] + sum;
      m[x] = m_new;
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i >> 1) & 1];

    // P as A fragments of the kJ 8-key steps (a0 = d0, a1 = d2, a2 = d1,
    // a3 = d3: k-slots c, c + 4 hold keys 2c, 2c + 1, as in the
    // transposed V planes), split
    uint32_t ph[kJ][4], pl[kJ][4];
#pragma unroll
    for (int j = 0; j < kJ; ++j)
      hopper::split_frag(sc[4 * j], sc[4 * j + 2], sc[4 * j + 1],
                         sc[4 * j + 3], ph[j], pl[j]);
    // O += P V per 64 columns: the 3 kJ products of a part sum in zeroed
    // registers, added in float32: at D = 128 two parts in flight, at 256
    // one at a time (O takes 128 registers there)
    float pa[32], pb[32];
    if constexpr (D > 128) {
#pragma unroll
      for (int n = 0; n < D / 64; ++n) {
        issue_part<D, kJ>(pa, ph, pl, dvh, dvl, n);
        hopper::wgmma_wait<0>();
        add_part<D>(acc, pa, n);
      }
    } else if constexpr (D > 64) {
      issue_part<D, kJ>(pa, ph, pl, dvh, dvl, 0);
      issue_part<D, kJ>(pb, ph, pl, dvh, dvl, 1);
      hopper::wgmma_wait<1>();
      add_part<D>(acc, pa, 0);
      hopper::wgmma_wait<0>();
      add_part<D>(acc, pb, 1);
    } else {
      issue_part<D, kJ>(pa, ph, pl, dvh, dvl, 0);
      hopper::wgmma_wait<0>();
      add_part<D>(acc, pa, 0);
    }
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      hopper::fence_regs(ph[j]);
      hopper::fence_regs(pl[j]);
    }
  }

  if (!live) return;
  // rows g + 8x of the warp, columns 8j + 2c (+1), as float2
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    float lt = l[x] + __shfl_xor_sync(0xffffffffu, l[x], 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int row = rg + 16 * warp + g + 8 * x;
    if (row >= sq) continue;
    const float lsafe = lt > 0.f ? lt : 1.f;
    const int64_t off = (((int64_t)bi * sq + row) * h + hi) * d + 2 * c;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      if (8 * j < d)  // d % 32 == 0
        *reinterpret_cast<float2*>(o + off + 8 * j) = make_float2(
            acc[4 * j + 2 * x] / lsafe, acc[4 * j + 2 * x + 1] / lsafe);
    if (c == 0) lse[(int64_t)bh * sq + row] = (m[x] + log2f(lsafe)) * kLn2;
  }
}

// strides: q, k, v, each (b, s, h), in elements; any view with unit
// stride in d (16-byte copies when every base and stride allows)
template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       float* lse, int b, int h, int d, int sq, int sk,
                       const int64_t* st, float scale_log2, int causal,
                       cudaStream_t stream) {
  using L = F32Fwd<D>;
  const void* base[3] = {q, k, v};
  View w[3];
  const int vec = make_views(3, base, st, w);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tf32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(b * h, (sq + L::kRows - 1) / L::kRows);
  flash_fwd_tf32_kernel<D><<<grid, L::kThreads, L::kBytes, stream>>>(
      w[0], w[1], w[2], static_cast<float*>(o), lse, h, d, sq, sk,
      scale_log2, causal, vec);
  return cudaGetLastError();
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

// dtype: 0 = float32 (split TF32 on the tensor cores; any view with unit
// stride in d), 1 = bfloat16 (tensor cores; every view
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

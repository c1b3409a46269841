// Flash-attention forward for Hopper (sm_90a), float32 and bfloat16.
//
// Replaces: mxnet_tpu/ops/attention.py::_fwd_kernel (launched by
// _flash_forward).  Same function: O = softmax(scale * Q Kᵀ) V with an
// online softmax, plus the natural-log logsumexp of every query row.
//
//   q       [b, sq, h, d]   read through its strides (unit stride in d)
//   k, v    [b, sk, h, d]   read through their strides (unit stride in d)
//   o       [b, sq, h, d]   contiguous, the input dtype
//   lse     [b*h, sq]       contiguous float32, natural log
//   d       64 or 128
//
// Design.  One thread block (256 threads, 16 x 16) per (b*h, 64-row query
// tile).  A loop inside the block walks the key/value tiles (64 rows each),
// staging them through shared memory; it takes the place of the TPU
// kernel's sequential third grid dimension.  Thread (ty, tx) owns query rows
// 4ty..4ty+3: a 4x4 block of scores (keys 4tx..4tx+3 of the tile) and a
// 4 x d/16 block of the O accumulator (columns 64g+4tx..64g+4tx+3).  Q and
// K are staged transposed ([d][row]) so each step of the QKᵀ loop reads the
// thread's four queries and four keys as two 16-byte loads; the PV loop
// reads four probabilities and four values of V the same way.  The running
// max m, the running sum l and the accumulator stay in float32 registers;
// the 16 threads that share a row reduce with warp shuffles.  Scores live in
// the base-2 domain (scale*log2(e) folded into one multiply, exponentials
// are exp2f); the logsumexp goes back to natural log when it is written.
// Causal mode is top-left aligned (query i sees keys j <= i, also when
// sq != sk): tiles wholly above the diagonal are never loaded, the diagonal
// tile is masked.  Keys past sk are masked, query rows past sq are computed
// but not written; a row with no visible key writes O = 0 and never divides
// by 0.  bfloat16 inputs are widened to float32 as they are staged, so both
// types run the same float32 arithmetic; O is rounded to the input type.
//
// What bounds it on this card.  Both products run on the float32 CUDA
// cores (no tensor cores), so the kernel is bound by operations: at
// b=4, s=4096, h=16, d=128 causal it does ~0.275 TFLOP against the H100
// SXM's 67 TFLOP/s float32 peak, while its bytes (Q, K, V, O, lse, ~0.54
// GB) take ~0.16 ms at 3.35 TB/s.  Inside the SM, shared memory sets the
// pace: a warp's QKᵀ step issues two 16-byte loads per 16 FMAs and its PV
// step 1 + d/64 per 16·d/64, and a 16-byte warp load costs up to four
// wavefronts (one per quarter-warp) even where half-warps read the same
// address, against four warp-FMAs per clock, so the QKᵀ loop can run at no
// more than half the FMA peak.  Q and K are staged in 4-row x 8-column warp
// patches so the global reads stay coalesced and, at row stride 68, the
// transposed shared-memory writes stay conflict-free.
//
// What the simple design leaves on the table: 8x8 per-thread register
// tiles, as SIMT GEMMs use, so each 16-byte load feeds twice the FMAs;
// wgmma on the tensor cores (bf16 at 989 TFLOP/s dense; tf32 would change
// the float32 numerics); TMA loads and a multi-stage pipeline overlapping the next K/V tile with
// the current products (the block waits at a barrier while it stages), and
// a persistent schedule balancing the causal triangle.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // key rows per inner tile
constexpr int kThreads = 256;    // 16 x 16 threads
constexpr int kTS = 68;          // row stride of the transposed Q, K, P tiles
constexpr float kNeg = -1e30f;   // initial running max (finite, as in the TPU kernel)
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

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
// or past nrows are zero.  A warp's 32 elements are 4 rows x 8 consecutive
// columns: one 32-byte sector per row on the read side (float32), and, as
// kTS = 4 (mod 32), 32 distinct banks on the transposed write side.
template <typename T, int D>
__device__ __forceinline__ void stage_transposed(float* dst, const T* src,
                                                 int64_t ss, int row0,
                                                 int nrows) {
  for (int e = threadIdx.x; e < 64 * D; e += kThreads) {
    const int chunk = e >> 5;
    const int c = (chunk % (D / 8)) * 8 + (e & 7);
    const int r = (chunk / (D / 8)) * 4 + ((e >> 3) & 3);
    const int row = row0 + r;
    dst[c * kTS + r] = row < nrows ? to_float(src[row * ss + c]) : 0.f;
  }
}

template <int D>
constexpr size_t smem_bytes() {
  // Q and K transposed ([D][kTS]; P [kBK][kTS] reuses the K tile once the
  // scores are taken), V row-major [kBK][D]
  return sizeof(float) * (2 * D * kTS + kBK * D);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int h, int sq, int sk,
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

  const T* qb = q + bi * q_sb + hi * q_sh;
  const T* kb = k + bi * k_sb + hi * k_sh;
  const T* vb = v + bi * v_sb + hi * v_sh;

  stage_transposed<T, D>(qt, qb, q_ss, q0, sq);

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
    stage_transposed<T, D>(kt, kb, k_ss, k0, sk);
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, c = e % D;
      const int row = k0 + r;
      vs[e] = row < sk ? to_float(vb[row * v_ss + c]) : 0.f;
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
    T* orow = o + ((int64_t)(bi * sq + row) * h + hi) * D;
#pragma unroll
    for (int g = 0; g < kG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        store(&orow[64 * g + 4 * tx + c], acc[i][4 * g + c] * inv);
    if (tx == 0) lse[(int64_t)bh * sq + row] = (m[i] + log2f(lsafe)) * kLn2;
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int b, int h, int sq, int sk,
                   const int64_t* st, float scale_log2, int causal,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(b * h, (sq + kBQ - 1) / kBQ);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, h, sq, sk,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      scale_log2, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v,
                       void* o, float* lse, int b, int h, int sq, int sk,
                       const int64_t* st, float scale_log2, int causal,
                       cudaStream_t stream) {
  switch (d) {
    case 64: return launch<T, 64>(q, k, v, o, lse, b, h, sq, sk, st, scale_log2, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, b, h, sq, sk, st, scale_log2, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  strides: q (b, s, h), k (b, s, h),
// v (b, s, h) in elements.  Launches on `stream` without synchronising and
// returns cudaGetLastError() of the launch (0 on success).
extern "C" int mxtt_flash_fwd(int dtype, int d, const void* q, const void* k,
                              const void* v, void* o, float* lse, int b, int h,
                              int sq, int sk, const int64_t* strides,
                              float scale_log2, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_d<float>(d, q, k, v, o, lse, b, h, sq, sk, strides,
                                  scale_log2, causal, s);
  if (dtype == 1)
    return (int)dispatch_d<__nv_bfloat16>(d, q, k, v, o, lse, b, h, sq, sk,
                                          strides, scale_log2, causal, s);
  return (int)cudaErrorInvalidValue;
}

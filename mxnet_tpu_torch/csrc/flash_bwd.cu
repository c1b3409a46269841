// Flash-attention backward for Hopper (sm_90a), float32 and bfloat16:
// K2 (dQ) and K3 (dK, dV), two kernels in one library.
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
// Design: the split of the TPU kernels, no atomics.  The TPU carries each
// accumulator across a sequential third grid axis; here one thread block
// owns one output tile and loops over the other axis inside the block.
// K2: one block (256 threads, 16 x 16) per (b*h, 64-row query tile); its Q
// and dO tiles are staged once, and a loop walks the 64-row K/V tiles up to
// the causal diagonal.  K3: one block per (b*h, 64-row key tile); its K and
// V tiles are staged once, and a loop walks the query tiles from the
// diagonal down.  Each iteration recomputes the 64 x 64 score tile S and
// dP = dO Vᵀ (K3 computes their transposes, so the rows it owns are keys),
// forms P and dS in registers, writes them to shared memory and adds the
// tile's contribution to the float32 accumulators held in registers.
// Thread (ty, tx) owns score rows ty + 16a and columns tx + 16b (a, b < 4)
// and accumulator rows ty + 16a, columns 64g + 4tx .. 64g + 4tx + 3.  All
// tiles are staged row-major at a row stride of d + 4 floats, so every
// product reads 16-byte vectors: an operand row shared by a quarter-warp is
// a broadcast, and eight different rows at that stride fall in eight
// different bank groups (d/4 + 1 is odd).  Scores live in the base-2 domain
// (scale * log2(e) folded into one multiply, lse * log2(e) subtracted,
// exp2f), as in the forward kernel.  Causal mode is top-left aligned (query
// i sees keys j <= i, also when sq != sk): K2 stops at the diagonal tile
// and K3 starts at it, and the tiles on it are masked; keys past sk and
// queries past sq are masked to P = dS = 0, and a key tile that no query
// sees writes dK = dV = 0.  bfloat16 inputs are widened to float32 as they
// are staged, so both types run the same float32 arithmetic; the gradients
// are rounded to the input type when written.
//
// What bounds it on this card.  All products run on the float32 CUDA
// cores: at b=4, s=4096, h=16, d=128 causal, K2 does 3 and K3 4 products
// of 2·d operations per visible (query, key) pair, ~0.41 and ~0.55 TFLOP,
// against the H100 SXM's 67 TFLOP/s float32 peak; their bytes (q, k, v,
// dO, lse, Δ in, one or two gradients out, ~0.3-0.4 GB) take ~0.1 ms at
// 3.35 TB/s.  Inside the SM, shared memory sets the pace: a score tile
// step issues eight 16-byte loads per 64 FMAs and a 16-byte warp load
// costs four wavefronts, so the loops can run at no more than about half
// the FMA rate.  The shared-memory tiles (K2 ~149 KB, K3 ~167 KB at d=128)
// leave room for one block of 8 warps per SM, which waits at a barrier
// while the next tile is staged.
//
// What the simple design leaves on the table: wgmma on the tensor cores
// (the bf16 function is bound at 989 TFLOP/s dense, ~1.5 ms at the shape
// above); larger per-thread register tiles; TMA loads and a multi-stage
// pipeline overlapping the next tile with the current products; a fused
// dK/dV + dQ kernel (FA2-style, with atomics or a second pass for dQ) that
// computes S and dP once instead of twice.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kB = 64;           // query rows and key rows per tile
constexpr int kThreads = 256;    // 16 x 16 threads
constexpr int kPS = kB + 4;      // row stride of the P / dS tiles
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// dst[r * (D + 4) + c] = src[(row0 + r) * ss + c] for r < 64, c < D; rows
// at or past nrows are zero.  Consecutive threads read consecutive columns.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* src, int64_t ss,
                                      int row0, int nrows) {
  for (int e = threadIdx.x; e < kB * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const int row = row0 + r;
    dst[r * (D + 4) + c] = row < nrows ? to_float(src[row * ss + c]) : 0.f;
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
template <typename T, int D>
__device__ __forceinline__ void write_rows(T* out, float acc[4][D / 16],
                                           int bi, int hi, int h, int s,
                                           int row0, int ty, int tx) {
  constexpr int kG = D / 64;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = row0 + ty + 16 * a;
    if (row >= s) continue;
    T* orow = out + ((int64_t)(bi * (int64_t)s + row) * h + hi) * D;
#pragma unroll
    for (int g = 0; g < kG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) store(&orow[64 * g + 4 * tx + c], acc[a][4 * g + c]);
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

// K2: dQ for one (b*h, 64-row query tile).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
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

  const T* qb = q + bi * st.q_b + hi * st.q_h;
  const T* kb = k + bi * st.k_b + hi * st.k_h;
  const T* vb = v + bi * st.v_b + hi * st.v_h;
  const T* ob = dout + bi * st.o_b + hi * st.o_h;

  stage<T, D>(qs, qb, st.q_s, q0, sq);
  stage<T, D>(dos, ob, st.o_s, q0, sq);

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
    stage<T, D>(ks, kb, st.k_s, k0, sk);
    stage<T, D>(vs, vb, st.v_s, k0, sk);
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
  write_rows<T, D>(dq, acc, bi, hi, h, sq, q0, ty, tx);
}

// K3: dK and dV for one (b*h, 64-row key tile).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int h, int sq, int sk, Strides st,
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

  const T* qb = q + bi * st.q_b + hi * st.q_h;
  const T* kb = k + bi * st.k_b + hi * st.k_h;
  const T* vb = v + bi * st.v_b + hi * st.v_h;
  const T* ob = dout + bi * st.o_b + hi * st.o_h;

  stage<T, D>(ks, kb, st.k_s, k0, sk);
  stage<T, D>(vs, vb, st.v_s, k0, sk);

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
    stage<T, D>(qs, qb, st.q_s, i0, sq);
    stage<T, D>(dos, ob, st.o_s, i0, sq);
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
  write_rows<T, D>(dk, dka, bi, hi, h, sk, k0, ty, tx);
  write_rows<T, D>(dv, dva, bi, hi, h, sk, k0, ty, tx);
}

Strides unpack(const int64_t* s) {
  return Strides{s[0], s[1], s[2], s[3], s[4],  s[5],
                 s[6], s[7], s[8], s[9], s[10], s[11]};
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, int b, int h, int sq, int sk,
                      const int64_t* strides, float scale, int causal,
                      cudaStream_t stream) {
  const size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(b * h, (sq + kB - 1) / kB);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), h, sq, sk, unpack(strides), scale,
      scale * kLog2e, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       void* dk, void* dv, int b, int h, int sq, int sk,
                       const int64_t* strides, float scale, int causal,
                       cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(b * h, (sk + kB - 1) / kB);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), h, sq, sk, unpack(strides),
      scale, scale * kLog2e, causal);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  strides: q, k, v, dO, each (b, s, h),
// in elements (12 values, host memory).  scale is the softmax scale (not
// yet multiplied by log2(e)).  Each entry launches on `stream` without
// synchronising and returns cudaGetLastError() of the launch (0 on success).
extern "C" int mxtt_flash_bwd_dq(int dtype, int d, const void* q,
                                 const void* k, const void* v,
                                 const void* dout, const float* lse,
                                 const float* delta, void* dq, int b, int h,
                                 int sq, int sk, const int64_t* strides,
                                 float scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && d == 64)
    return (int)launch_dq<float, 64>(q, k, v, dout, lse, delta, dq, b, h, sq, sk, strides, scale, causal, s);
  if (dtype == 0 && d == 128)
    return (int)launch_dq<float, 128>(q, k, v, dout, lse, delta, dq, b, h, sq, sk, strides, scale, causal, s);
  if (dtype == 1 && d == 64)
    return (int)launch_dq<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, dq, b, h, sq, sk, strides, scale, causal, s);
  if (dtype == 1 && d == 128)
    return (int)launch_dq<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, dq, b, h, sq, sk, strides, scale, causal, s);
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
    return (int)launch_dkv<float, 64>(q, k, v, dout, lse, delta, dk, dv, b, h, sq, sk, strides, scale, causal, s);
  if (dtype == 0 && d == 128)
    return (int)launch_dkv<float, 128>(q, k, v, dout, lse, delta, dk, dv, b, h, sq, sk, strides, scale, causal, s);
  if (dtype == 1 && d == 64)
    return (int)launch_dkv<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, dk, dv, b, h, sq, sk, strides, scale, causal, s);
  if (dtype == 1 && d == 128)
    return (int)launch_dkv<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, dk, dv, b, h, sq, sk, strides, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

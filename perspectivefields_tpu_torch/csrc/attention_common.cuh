// Device code shared by the attention kernels (fused_attention.cu,
// stage1_attention.cu, fused_block.cu): the K/V projection into a scratch
// tensor (their first launch; fused_attention.cu's bf16 path has its own on
// wgmma), the f32 scalar-FMA projection tiles and the row softmax.
//
// float32 sums every product as one FMA chain over k in order, and the
// softmax reduces each row in one warp's order, so the f32 kernels round as
// the plain PyTorch path does on the card (cuBLAS's non-TF32 SGEMM order).
#pragma once

#include "common.cuh"

namespace {

constexpr int kTQ = 32;           // query rows per block (and rows per KV tile)
constexpr int kMaxM = 128;        // most keys a block holds
constexpr int kHeadDim = 64;

// ---------------------------------------------------------------------------
// float32: scalar FMAs, 4 x 4 register tiles per thread
// ---------------------------------------------------------------------------

constexpr int kThreads = 128;     // 16 x 8 threads
constexpr int kWarps = kThreads / 32;

constexpr int kCols = 64;         // output columns per GEMM chunk (= head_dim)
constexpr int kKT = 32;           // reduction depth staged per step
constexpr int kWtLd = kCols + 1;  // padded row of the staged weight tile
constexpr int kKtLd = kMaxM + 1;  // padded row of the transposed K tile

// ws[kk][jj] = W[j0 + jj][k0 + kk] for a 64 x 32 slice of W (ld = ldw).
__device__ __forceinline__ void stage_w(float* ws, const float* __restrict__ w,
                                        int ldw, int j0, int k0) {
  for (int i = threadIdx.x; i < kCols * kKT; i += kThreads) {
    const int jj = i / kKT, kk = i % kKT;
    ws[kk * kWtLd + jj] = w[(size_t)(j0 + jj) * ldw + k0 + kk];
  }
}

// acc = A[0:32, 0:K] . W[j0:j0+64, 0:K]^T with A in shared memory (ld lda).
// Thread (tx, ty) owns rows ty + 8i and columns j0 + tx + 16c.
__device__ __forceinline__ void gemm_chunk(float (&acc)[4][4], const float* a,
                                           int lda, const float* __restrict__ w,
                                           int K, int j0, float* ws) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kKT) {
    __syncthreads();  // the previous weight tile is consumed
    stage_w(ws, w, K, j0, k0);
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kKT; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = a[(ty + 8 * i) * lda + k0 + kk];
#pragma unroll
      for (int c = 0; c < 4; ++c) bv[c] = ws[kk * kWtLd + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(av[i], bv[c], acc[i][c]);
    }
  }
}

// out[R, J] = a[R, K] . w[J, K]^T + bias; one block per 32 x 64 tile.
__global__ void __launch_bounds__(kThreads)
    kv_proj_f32(const float* __restrict__ a, const float* __restrict__ w,
                const float* __restrict__ bias, float* __restrict__ out, int R,
                int K, int J) {
  __shared__ float as[kTQ][kKT + 1];
  __shared__ float ws[kKT * kWtLd];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int r0 = blockIdx.x * kTQ, j0 = blockIdx.y * kCols;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kKT) {
    __syncthreads();
    for (int i = threadIdx.x; i < kTQ * kKT; i += kThreads) {
      const int r = i / kKT, kk = i % kKT;
      as[r][kk] = r0 + r < R ? a[(size_t)(r0 + r) * K + k0 + kk] : 0.f;
    }
    stage_w(ws, w, K, j0, k0);
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kKT; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[ty + 8 * i][kk];
#pragma unroll
      for (int c = 0; c < 4; ++c) bv[c] = ws[kk * kWtLd + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(av[i], bv[c], acc[i][c]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 8 * i;
    if (r >= R) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + tx + 16 * c;
      out[(size_t)r * J + j] = acc[i][c] + bias[j];
    }
  }
}

// Row softmax in place over kMaxM f32 logits per row (masked keys already
// -inf), one warp per row, for rows 0..rows-1 of s (ld kMaxM).
__device__ __forceinline__ void softmax_rows_f32(float* s, int rows) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += blockDim.x / 32) {
    float v[kMaxM / 32];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kMaxM / 32; ++j) {
      v[j] = s[r * kMaxM + lane + 32 * j];
      mx = fmaxf(mx, v[j]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxM / 32; ++j) {
      v[j] = expf(v[j] - mx);  // masked keys: exp(-inf) = 0
      sum += v[j];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
#pragma unroll
    for (int j = 0; j < kMaxM / 32; ++j) s[r * kMaxM + lane + 32 * j] = v[j] / sum;
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor-core 16x16x16 MMAs (WMMA), f32 accumulation
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 256;          // 8 warps
constexpr int kTcWarps = kTcThreads / 32;
constexpr int kPLd = kMaxM + kPad;       // rows of p
constexpr int kSLd = kMaxM + 4;          // rows of the f32 logits
constexpr int kKvK = 64;                 // K depth staged per step (kv proj)

// out[R, J] = bf16(a[R, K] . w[J, K]^T + bias); a block per 32 x 128 tile,
// one 16-column strip per warp.
__global__ void __launch_bounds__(kTcThreads)
    kv_proj_bf16(const bf16* __restrict__ a, const bf16* __restrict__ w,
                 const bf16* __restrict__ bias, bf16* __restrict__ out, int R,
                 int K, int J) {
  __shared__ __align__(128) bf16 as[kTQ * (kKvK + kPad)];
  __shared__ __align__(128) float scratch[kTcWarps * 256];
  const int warp = threadIdx.x / 32;
  const int r0 = blockIdx.x * kTQ, n0 = blockIdx.y * 16 * kTcWarps + warp * 16;
  constexpr int lda = kKvK + kPad;
  FragC acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);
  for (int k0 = 0; k0 < K; k0 += kKvK) {
    __syncthreads();
    for (int i = threadIdx.x; i < kTQ * kKvK / 8; i += kTcThreads) {
      const int r = i / (kKvK / 8), v = i % (kKvK / 8);
      uint4 val = make_uint4(0, 0, 0, 0);
      if (r0 + r < R)
        val = reinterpret_cast<const uint4*>(a + (size_t)(r0 + r) * K + k0)[v];
      *reinterpret_cast<uint4*>(as + r * lda + v * 8) = val;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kKvK; k += 16) {
      FragBCol bw;
      wmma::load_matrix_sync(bw, w + (size_t)n0 * K + k0 + k, K);
      FragA a0, a1;
      wmma::load_matrix_sync(a0, as + k, lda);
      wmma::load_matrix_sync(a1, as + 16 * lda + k, lda);
      wmma::mma_sync(acc[0], a0, bw, acc[0]);
      wmma::mma_sync(acc[1], a1, bw, acc[1]);
    }
  }
  float* sc = scratch + warp * 256;
  for (int i = 0; i < 2; ++i)
    for_each_acc(acc[i], sc, [&](int r, int c, float v) {
      const int row = r0 + 16 * i + r, col = n0 + c;
      if (row < R)
        out[(size_t)row * J + col] = __float2bfloat16(v + __bfloat162float(bias[col]));
    });
}

// p = bf16(softmax_f32(ss * scale)) row by row, one warp per row, for rows
// 0..rows-1: keys past M are masked, p is 0 from M to mp (the MMA padding).
__device__ __forceinline__ void softmax_rows_bf16(const float* ss, bf16* ps, int rows,
                                                  int M, int mp, float scale) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += blockDim.x / 32) {
    float v[kMaxM / 32];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kMaxM / 32; ++j) {
      const int m = lane + 32 * j;
      v[j] = m < M ? ss[r * kSLd + m] * scale : -INFINITY;
      mx = fmaxf(mx, v[j]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxM / 32; ++j) {
      v[j] = expf(v[j] - mx);  // masked keys: exp(-inf) = 0
      sum += v[j];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
#pragma unroll
    for (int j = 0; j < kMaxM / 32; ++j) {
      const int m = lane + 32 * j;
      if (m < mp) ps[r * kPLd + m] = __float2bfloat16(v[j] / sum);
    }
  }
}

// The K/V projection kv = T(kv_in . Wkv^T + bkv), (R = B*M, 2C), into the
// scratch tensor kv: the first launch of every attention kernel here. C is
// a multiple of 64, so 2C is a multiple of the bf16 tile's 128 columns.
template <typename T>
int launch_kv_proj(const void* kv_in, const void* wkv, const void* bkv, void* kv, int R,
                   int C, cudaStream_t stream) {
  const int J = 2 * C;
  if constexpr (sizeof(T) == 4) {
    kv_proj_f32<<<dim3((R + kTQ - 1) / kTQ, J / kCols), kThreads, 0, stream>>>(
        static_cast<const float*>(kv_in), static_cast<const float*>(wkv),
        static_cast<const float*>(bkv), static_cast<float*>(kv), R, C, J);
  } else {
    kv_proj_bf16<<<dim3((R + kTQ - 1) / kTQ, J / (16 * kTcWarps)), kTcThreads, 0, stream>>>(
        static_cast<const bf16*>(kv_in), static_cast<const bf16*>(wkv),
        static_cast<const bf16*>(bkv), static_cast<bf16*>(kv), R, C, J);
  }
  return (int)cudaGetLastError();
}

}  // namespace

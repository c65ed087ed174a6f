// Device helpers shared by the kernels in this directory: types, rounding,
// WMMA fragments and their epilogue.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stddef.h>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kPad = 8;  // bf16 row padding (16 bytes)

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__host__ __device__ constexpr int ceil16(int n) { return (n + 15) / 16 * 16; }
__host__ __device__ constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

__device__ __forceinline__ float rnd(float v) {
  return __bfloat162float(__float2bfloat16(v));  // round to nearest even
}

// Copy the warp's accumulator through its 16 x 16 f32 scratch; the caller's
// functor sees (row in tile, col in tile, value) once per element.
template <typename F>
__device__ __forceinline__ void for_each_acc(const FragC& acc, float* scratch, F&& f) {
  const int lane = threadIdx.x % 32;
  wmma::store_matrix_sync(scratch, acc, 16, wmma::mem_row_major);
  __syncwarp();
  for (int e = lane; e < 256; e += 32) f(e / 16, e % 16, scratch[e]);
  __syncwarp();
}

}  // namespace

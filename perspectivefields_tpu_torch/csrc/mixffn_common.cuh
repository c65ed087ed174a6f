// Device code shared by the fused MixFFN (mixffn.cu) and the fused MiT
// block (fused_block.cu): a block's halo'd token tile, its index tables,
// and the walk over the hidden dimension in 64-channel chunks (fc1, the
// hidden map's zero padding, the 3x3 depthwise taps, GELU, and that chunk's
// fc2 product added into the output accumulators).
#pragma once

#include <cuda_pipeline.h>

#include "common.cuh"

namespace {

constexpr int kThreadsF32 = 256;       // float32 kernel: 8 warps
constexpr int kThreadsTC = 512;        // bfloat16 kernel: 16 warps
constexpr int kWarpsTC = kThreadsTC / 32;
constexpr int kHC = 64;                // hidden channels per chunk
constexpr int kMaxHalo = 128;          // halo tokens per block, padded to 16
constexpr int kMaxOutFrags = 4;        // bf16: 16x16 output tiles per warp
constexpr int kHfLd = kHC + 4;         // row of the f32 hidden chunk
constexpr int kGsLd = kHC + kPad;      // row of the bf16 GELU chunk
constexpr int kWsLd = 33;              // row of a staged f32 weight tile

// GELU in f32, in the form the dtype rule picks (ops/activations.py).
template <typename T> __device__ __forceinline__ float gelu(float x);
template <> __device__ __forceinline__ float gelu<float>(float x) {
  return 0.5f * x * (1.f + erff(x * 0.7071067811865476f));
}
template <> __device__ __forceinline__ float gelu<bf16>(float x) {
  const float inner = 0.7978845608028654f * (x + 0.044715f * x * x * x);
  return 0.5f * x * (1.f + tanhf(inner));
}

// Geometry of one block's tile: outputs (TH x TW) at (y0, x0) of image b,
// halo (TH+2) x (TW+2) starting one pixel up and left.
struct Tile {
  int b, y0, x0, th, tw, hw, nhalo, nhp, no, nop;
  __device__ Tile(int H, int W, int th_, int tw_) : th(th_), tw(tw_) {
    const int tiles_w = (W + tw - 1) / tw;
    b = blockIdx.y;
    y0 = (blockIdx.x / tiles_w) * th;
    x0 = (blockIdx.x % tiles_w) * tw;
    hw = tw + 2;
    nhalo = (th + 2) * hw;
    nhp = ceil16(nhalo);
    no = th * tw;
    nop = ceil16(no);
  }
  // image coordinates of halo token t; false outside the image
  __device__ bool halo_pixel(int t, int H, int W, int& y, int& x) const {
    y = y0 - 1 + t / hw;
    x = x0 - 1 + t % hw;
    return t < nhalo && y >= 0 && y < H && x >= 0 && x < W;
  }
};

// Per-block index tables: valid[t] = 1 where halo token t is an image pixel
// (0 on the zero padding), base[o] = the halo token at output o's top-left
// tap.
struct Tables {
  float* valid;  // kMaxHalo
  int* base;     // kMaxHalo
};

__device__ __forceinline__ void fill_tables(Tables tb, const Tile& tl, int H, int W) {
  for (int t = threadIdx.x; t < tl.nhp; t += blockDim.x) {
    int y, x;
    tb.valid[t] = tl.halo_pixel(t, H, W, y, x) ? 1.f : 0.f;
  }
  for (int o = threadIdx.x; o < tl.no; o += blockDim.x)
    tb.base[o] = (o / tl.tw) * tl.hw + o % tl.tw;
}

// Stage the chunk's fc1 bias and conv bias as f32.
template <typename T>
__device__ __forceinline__ void stage_biases(float* b1s, float* dwbs, const T* __restrict__ b1,
                                             const T* __restrict__ dwb, int h0) {
  for (int j = threadIdx.x; j < kHC; j += blockDim.x) {
    b1s[j] = to_f(b1[h0 + j]);
    dwbs[j] = to_f(dwb[h0 + j]);
  }
}

// hf[t][j] = T(hf[t][j] + b1[j]) on image pixels, 0 elsewhere (the hidden
// map's zero padding), for the halo tokens.
template <typename T>
__device__ __forceinline__ void mask_round(float* hf, const float* b1s, Tables tb,
                                           const Tile& tl) {
  const int j = threadIdx.x % kHC;  // blockDim.x % kHC == 0: each thread keeps one channel
  const float bias = b1s[j];
#pragma unroll 4
  for (int t = threadIdx.x / kHC; t < tl.nhalo; t += blockDim.x / kHC) {
    float* h = hf + t * kHfLd + j;
    *h = tb.valid[t] != 0.f ? to_f(from_f<T>(*h + bias)) : 0.f;
  }
}

// gs[o][j] = T(gelu(dw3x3(hf)[o][j] + dwb[j])) for the tile's outputs, taps
// in row-major order; rows past TH*TW (MMA padding) are zero.
template <typename T, typename G>
__device__ __forceinline__ void dwconv_gelu(G* gs, int ldg, const float* hf,
                                            const T* __restrict__ dwk, const float* dwbs,
                                            Tables tb, const Tile& tl, int h0) {
  const int j = threadIdx.x % kHC;
  float taps[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) taps[k] = to_f(dwk[(size_t)(h0 + j) * 9 + k]);
  const float bias = dwbs[j];
#pragma unroll 2
  for (int o = threadIdx.x / kHC; o < tl.nop; o += blockDim.x / kHC) {
    float g = 0.f;
    if (o < tl.no) {
      const float* h = hf + tb.base[o] * kHfLd + j;
      float acc = 0.f;
#pragma unroll
      for (int dp = 0; dp < 3; ++dp)
#pragma unroll
        for (int dq = 0; dq < 3; ++dq)
          acc = fmaf(h[(dp * tl.hw + dq) * kHfLd], taps[dp * 3 + dq], acc);
      g = to_f(from_f<T>(gelu<T>(acc + bias)));
    }
    gs[o * ldg + j] = from_f<G>(g);
  }
}

// dst[r][dcol0 + n] (+)= sum_k a[r][k] * w[(wrow0 + n) * ldw + k0 + k] for
// r < R <= 128, n < 32, k < K (K % 32 == 0). Thread (lane, warp) owns column
// lane and rows warp + 8i. Starts with a barrier, so a's writers are done.
// With ``accumulate`` the sum continues from dst, so chunked calls over k
// round exactly as one sequential FMA chain over all of k (as cuBLAS's
// non-TF32 SGEMM sums).
__device__ __forceinline__ void gemm32_f32(float* dst, int ldd, int dcol0, bool accumulate,
                                           const float* a, int lda, int R,
                                           const float* __restrict__ w, int ldw, int wrow0,
                                           int k0, int K, float* ws) {
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int r = ty + 8 * i;
    acc[i] = accumulate && r < R ? dst[r * ldd + dcol0 + tx] : 0.f;
  }
  for (int kb = 0; kb < K; kb += 32) {
    __syncthreads();
    for (int i = threadIdx.x; i < 32 * 32; i += kThreadsF32) {
      const int n = i / 32, kk = i % 32;
      ws[kk * kWsLd + n] = w[(size_t)(wrow0 + n) * ldw + k0 + kb + kk];
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < 32; ++kk) {
      const float wv = ws[kk * kWsLd + tx];
#pragma unroll
      for (int i = 0; i < 16; ++i)
        if (ty + 8 * i < R) acc[i] = fmaf(a[(ty + 8 * i) * lda + kb + kk], wv, acc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int r = ty + 8 * i;
    if (r < R) dst[r * ldd + dcol0 + tx] = acc[i];
  }
}

// Asynchronous 16-byte copies of one weight chunk into shared memory, as
// B operands of the MMAs: w1s[n][k] = W1[h0 + n][k] (rows of C + 8) and
// w2s[n][k] = W2[n][h0 + k] (rows of kHC + 8), n and k within the chunk.
__device__ __forceinline__ void stage_w1(bf16* w1s, const bf16* __restrict__ w1, int h0, int C) {
  const int vpr = C / 8;
  for (int i = threadIdx.x; i < kHC * vpr; i += kThreadsTC) {
    const int n = i / vpr, v = i % vpr;
    __pipeline_memcpy_async(w1s + n * (C + kPad) + v * 8, w1 + (size_t)(h0 + n) * C + v * 8, 16);
  }
}

__device__ __forceinline__ void stage_w2(bf16* w2s, const bf16* __restrict__ w2, int h0, int C) {
  constexpr int vpr = kHC / 8;
  for (int i = threadIdx.x; i < C * vpr; i += kThreadsTC) {
    const int n = i / vpr, v = i % vpr;
    __pipeline_memcpy_async(w2s + n * kGsLd + v * 8, w2 + (size_t)n * 4 * C + h0 + v * 8, 16);
  }
}

// os[o][c] += sum over all hidden chunks of g[o][:] . W2[c][:] (no b2) for
// the tile's outputs, continuing each sum's FMA chain from os; xs is the
// halo'd input tile (nhp x C, 0 off the image). Starts with a barrier.
__device__ __forceinline__ void ffn_chunks_f32(float* os, const float* xs, float* hf, float* gs,
                                               float* ws, float* b1s, float* dwbs, Tables tb,
                                               const Tile& tl, const float* __restrict__ w1,
                                               const float* __restrict__ b1,
                                               const float* __restrict__ dwk,
                                               const float* __restrict__ dwb,
                                               const float* __restrict__ w2, int C) {
  const int hid = 4 * C;
  for (int h0 = 0; h0 < hid; h0 += kHC) {
    stage_biases(b1s, dwbs, b1, dwb, h0);
    for (int n0 = 0; n0 < kHC; n0 += 32)
      gemm32_f32(hf, kHfLd, n0, false, xs, C, tl.nhp, w1, C, h0 + n0, 0, C, ws);
    __syncthreads();
    mask_round<float>(hf, b1s, tb, tl);
    __syncthreads();
    dwconv_gelu<float>(gs, kHfLd, hf, dwk, dwbs, tb, tl, h0);
    for (int n0 = 0; n0 < C; n0 += 32)
      gemm32_f32(os, C, n0, true, gs, kHfLd, tl.nop, w2, hid, n0, h0, kHC, ws);
    __syncthreads();  // the next chunk restages b1s, dwbs
  }
}

// acc += g . W2[:, h_begin:h_end]^T for the hidden chunks [h_begin, h_end):
// warp w owns output tiles w, w + 16, ... of (nop/16) x (C/16). xs is the
// halo'd input tile (nhp x (C + kPad), 0 off the image); the caller has
// issued stage_w1(w1s, w1, h_begin, C) and its __pipeline_commit(). Ends
// with a barrier, so w1s/w2s may then be reused.
__device__ __forceinline__ void ffn_chunks_bf16(FragC (&acc)[kMaxOutFrags], const bf16* xs,
                                                bf16* w1s, bf16* w2s, float* hf, bf16* gs,
                                                float* b1s, float* dwbs, Tables tb, const Tile& tl,
                                                const bf16* __restrict__ w1,
                                                const bf16* __restrict__ b1,
                                                const bf16* __restrict__ dwk,
                                                const bf16* __restrict__ dwb,
                                                const bf16* __restrict__ w2, int C, int h_begin,
                                                int h_end) {
  const int ldx = C + kPad, warp = threadIdx.x / 32;
  const int oct = C / 16, n_out = (tl.nop / 16) * oct;
  // fc1 tiles: warp w owns column tile w % 4 and row tiles w / 4 + 4i.
  // Weight chunks arrive by cp.async, two in flight: W2's chunk h during
  // fc1(h), W1's chunk h + 1 during the conv and fc2(h).
  constexpr int kRowGroups = kWarpsTC / 4, kRowsPerWarp = kMaxHalo / 16 / kRowGroups;
  const int hct = warp % 4, rg = warp / 4, nrt = tl.nhp / 16;
  for (int h0 = h_begin; h0 < h_end; h0 += kHC) {
    stage_w2(w2s, w2, h0, C);  // w2s is free: fc2(h - 1) ended with a barrier
    __pipeline_commit();
    stage_biases(b1s, dwbs, b1, dwb, h0);
    __pipeline_wait_prior(1);  // this thread's copies of W1's chunk h
    __syncthreads();           // everyone's; xs and the tables are written
    {
      FragC hacc[kRowsPerWarp];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) wmma::fill_fragment(hacc[i], 0.f);
      const bf16* wcol = w1s + hct * 16 * ldx;
#pragma unroll 2
      for (int k = 0; k < C; k += 16) {
        FragBCol bw;
        wmma::load_matrix_sync(bw, wcol + k, ldx);
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          const int rt = rg + kRowGroups * i;
          if (rt < nrt) {
            FragA a;
            wmma::load_matrix_sync(a, xs + rt * 16 * ldx + k, ldx);
            wmma::mma_sync(hacc[i], a, bw, hacc[i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const int rt = rg + kRowGroups * i;
        if (rt < nrt)
          wmma::store_matrix_sync(hf + rt * 16 * kHfLd + hct * 16, hacc[i], kHfLd,
                                  wmma::mem_row_major);
      }
    }
    __syncthreads();  // w1s is free
    if (h0 + kHC < h_end) stage_w1(w1s, w1, h0 + kHC, C);
    __pipeline_commit();
    mask_round<bf16>(hf, b1s, tb, tl);
    __syncthreads();
    dwconv_gelu<bf16>(gs, kGsLd, hf, dwk, dwbs, tb, tl, h0);
    __pipeline_wait_prior(1);  // this thread's copies of W2's chunk h
    __syncthreads();

    // out += g . W2[:, h0:h0+64]^T (w2s read as a column-major B)
#pragma unroll
    for (int f = 0; f < kMaxOutFrags; ++f) {
      const int i = warp + kWarpsTC * f;
      if (i < n_out) {
        const int rt = i / oct, ct = i % oct;
#pragma unroll
        for (int kk = 0; kk < kHC; kk += 16) {
          FragA a;
          FragBCol bw;
          wmma::load_matrix_sync(a, gs + rt * 16 * kGsLd + kk, kGsLd);
          wmma::load_matrix_sync(bw, w2s + ct * 16 * kGsLd + kk, kGsLd);
          wmma::mma_sync(acc[f], a, bw, acc[f]);
        }
      }
    }
    __syncthreads();  // w2s and gs are free
  }
}

}  // namespace

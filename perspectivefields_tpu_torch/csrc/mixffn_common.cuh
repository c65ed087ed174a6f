// Device code shared by the fused MixFFN (mixffn.cu) and the fused MiT
// block (fused_block.cu): GELU, a block's halo'd token tile and its index
// tables, and the float32 walk over the hidden dimension in 64-channel
// chunks (fc1, the hidden map's zero padding, the 3x3 depthwise taps, GELU,
// and that chunk's fc2 product added into the output accumulators).
#pragma once

#include "common.cuh"

namespace {

constexpr int kThreadsF32 = 256;       // float32 kernel: 8 warps
constexpr int kHC = 64;                // hidden channels per chunk
constexpr int kMaxHalo = 128;          // halo tokens per block, padded to 16
constexpr int kHfLd = kHC + 4;         // row of the f32 hidden chunk
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

}  // namespace

// Fused ConvNeXt block for Hopper (sm_90a), bfloat16 and float32.
//
// Replaces the TPU kernel perspectivefields_tpu/kernels/convnext_block.py:
// convnext_block_fused (its pallas_call; body _block_kernel) and computes
// the function of its oracle _xla_reference with _block_kernel's casts, for
// x (B, H, W, C):
//
//   z   = dw7x7(x) + dwb                     f32, zero padding, not rounded
//   y   = T(LN(z) * lns + lnb)               f32 moments over C, the fast
//                                            variance E[z^2] - mu^2, eps
//   g   = T(gelu_f32(y . W1^T + b1))         f32 accumulation; tanh form at
//                                            bf16, erf at f32
//   out = T(x + (g . W2^T + b2) * gamma)     f32 accumulation, gamma and the
//                                            residual in f32
//
// T is the compute dtype. Weights keep the torch layouts: the depthwise
// kernel (C, 1, 7, 7), W1 (4C, C) and W2 (C, 4C) as nn.Linear (out, in).
//
// What bounds it on the H100: the CUDA-core work per element (49 taps,
// LayerNorm, GELU on the 4x hidden map), closely followed by bytes; both
// are small, ~8 us a call at the flagship's B=8 shapes (kernels/roofline.py).
// Unfused, the block moves the activation through HBM about six times
// (dwconv out, LN out, the 4x hidden map in and out of GELU, the
// projection, layer scale, residual) in seven launches. What this design
// does about it: a block owns NO
// consecutive tokens (raster order) with all C channels, which the
// LayerNorm needs. It computes the 7x7 depthwise conv (at bf16 from a copy
// of the rows the tokens span, with their halo, in shared memory; at f32
// straight from x), the LN in shared memory, and walks the
// 4C hidden dimension in chunks: pwconv1, bias and GELU for the chunk,
// then that chunk's pwconv2 partial product into the output accumulator
// (registers at bf16). HBM sees one read of x (plus the halo rows) and one
// write of out. Where the token tiles alone would leave SMs idle (stages
// 2-3 of the flagship), the bf16 kernel also splits the hidden dimension
// over blocks, which add f32 partial outputs that a second kernel sums in a
// fixed order (each block recomputes its tile's conv and LayerNorm). The
// wrapper picks NO, the chunk and the split (kernels/convnext_block.py:
// choose_tokens, mixffn.choose_split). Every block reads all of W1 and W2
// from L2, so at bf16 each weight chunk is copied into shared memory by
// cp.async, the next one in flight while this one is used; the bf16 kernel
// runs 16 warps to hide the latency of the per-element phases.
//
// bfloat16 runs both GEMMs on the tensor cores with warp-level 16x16x16
// MMAs (WMMA), f32 accumulation. float32 runs scalar FMAs (the tensor
// cores' f32 input is TF32, which would not match f32); its chunked
// pwconv2 continues one FMA chain over the hidden dimension. Simple by
// intent: no wgmma, no TMA, no warp specialisation.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stddef.h>

#include <algorithm>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kThreadsF32 = 256;       // float32 kernel: 8 warps
constexpr int kThreadsTC = 512;        // bfloat16 kernel: 16 warps
constexpr int kWarpsTC = kThreadsTC / 32;
constexpr int kHC = 64;                // hidden channels per float32 chunk
constexpr int kMaxTokens = 64;         // tokens per block
constexpr int kMaxOutFrags = 6;        // bf16: 16x16 output tiles per warp
constexpr int kPad = 8;                // bf16 row padding (16 bytes)
constexpr int kHfLd = kHC + 4;         // row of the f32 hidden chunk
constexpr int kWsLd = 33;              // row of a staged f32 weight tile

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__host__ __device__ constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

// GELU in f32, in the form the dtype rule picks (ops/activations.py).
template <typename T> __device__ __forceinline__ float gelu(float x);
template <> __device__ __forceinline__ float gelu<float>(float x) {
  return 0.5f * x * (1.f + erff(x * 0.7071067811865476f));
}
template <> __device__ __forceinline__ float gelu<bf16>(float x) {
  const float inner = 0.7978845608028654f * (x + 0.044715f * x * x * x);
  return 0.5f * x * (1.f + tanhf(inner));
}

// The float32 kernel's conv: zs[o][c] = dw7x7(x)[p0 + o][c] + dwb[c] for
// the block's tokens p0.. of the P in raster order, read straight from x;
// rows past the last token are zero. Thread pairs (c, g) hold channel c's
// 49 taps in registers and take tokens g, g + G, ...; taps in row-major
// order.
__device__ __forceinline__ void dwconv7(float* zs, const float* __restrict__ x,
                                        const float* __restrict__ dwk,
                                        const float* __restrict__ dwb, int p0, int no, int P,
                                        int H, int W, int C) {
  const int G = max(1, (int)blockDim.x / C);
  for (int pr = threadIdx.x; pr < C * G; pr += blockDim.x) {
    const int c = pr % C, g = pr / C;
    float w[49];
#pragma unroll
    for (int t = 0; t < 49; ++t) w[t] = dwk[(size_t)c * 49 + t];
    const float bias = dwb[c];
    for (int o = g; o < no; o += G) {
      const int p = p0 + o;
      if (p >= P) {
        zs[o * C + c] = 0.f;
        continue;
      }
      const int xx = p % W, y = (p / W) % H, b = p / (W * H);
      const float* img = x + (size_t)b * H * W * C + c;
      float acc = 0.f;
#pragma unroll
      for (int dp = 0; dp < 7; ++dp) {
        const int yq = y + dp - 3;
        if (yq < 0 || yq >= H) continue;
#pragma unroll
        for (int dq = 0; dq < 7; ++dq) {
          const int xq = xx + dq - 3;
          if (xq < 0 || xq >= W) continue;
          acc = fmaf(img[((size_t)yq * W + xq) * C], w[dp * 7 + dq], acc);
        }
      }
      zs[o * C + c] = acc + bias;
    }
  }
}

// The same conv for a block of nq <= no consecutive tokens q0.. of image b,
// reading x from shared memory: the rows the tokens and their 3-pixel halo
// span are copied in, cc channels at a time, into xt (at least
// ((no - 1) / W + 8) * W * cc elements). Threads (c, g) hold channel c's 49
// taps and take tokens g, g + G, ...; taps in row-major order.
__device__ __forceinline__ void dwconv7_staged(float* zs, bf16* xt, const bf16* __restrict__ x,
                                               const bf16* __restrict__ dwk,
                                               const bf16* __restrict__ dwb, int b, int q0,
                                               int nq, int no, int H, int W, int C, int cc) {
  const int ya = q0 / W, yb = (q0 + nq - 1) / W;
  const int r0 = max(0, ya - 3), npix = (min(H, yb + 4) - r0) * W, vpp = cc / 8;
  const bf16* src = x + ((size_t)b * H + r0) * W * C;
  const int c = threadIdx.x % cc, g = threadIdx.x / cc, G = blockDim.x / cc;
  for (int c0 = 0; c0 < C; c0 += cc) {
    __syncthreads();  // the last channel chunk's reads of xt are done
    for (int i = threadIdx.x; i < npix * vpp; i += blockDim.x) {
      const int pix = i / vpp, v = i % vpp;
      *reinterpret_cast<uint4*>(xt + pix * cc + v * 8) =
          *reinterpret_cast<const uint4*>(src + (size_t)pix * C + c0 + v * 8);
    }
    __syncthreads();
    float w[49];
#pragma unroll
    for (int t = 0; t < 49; ++t) w[t] = __bfloat162float(dwk[(size_t)(c0 + c) * 49 + t]);
    const float bias = __bfloat162float(dwb[c0 + c]);
    for (int o = g; o < no; o += G) {
      float z = 0.f;
      if (o < nq) {
        const int y = (q0 + o) / W, xx = (q0 + o) % W;
        float acc = 0.f;
#pragma unroll
        for (int dp = 0; dp < 7; ++dp) {
          const int yq = y + dp - 3;
          if (yq < 0 || yq >= H) continue;
          const bf16* row = xt + (yq - r0) * W * cc + c;
#pragma unroll
          for (int dq = 0; dq < 7; ++dq) {
            const int xq = xx + dq - 3;
            if (xq < 0 || xq >= W) continue;
            acc = fmaf(__bfloat162float(row[xq * cc]), w[dp * 7 + dq], acc);
          }
        }
        z = acc + bias;
      }
      zs[o * C + c0 + c] = z;
    }
  }
}

// ys[o][c] = T((zs[o][c] - mu) * rsqrt(var + eps) * lns[c] + lnb[c]), one
// warp per token, with var = E[z^2] - mu^2 over the C channels.
template <typename T, typename Y>
__device__ __forceinline__ void layer_norm(Y* ys, int ldy, const float* zs,
                                           const T* __restrict__ lns,
                                           const T* __restrict__ lnb, int no, int C,
                                           float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float inv_c = 1.f / (float)C;
  for (int o = warp; o < no; o += blockDim.x / 32) {
    const float* z = zs + o * C;
    float s = 0.f, s2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      s += z[c];
      s2 = fmaf(z[c], z[c], s2);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, off);
      s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    const float mu = s * inv_c;
    const float r = rsqrtf(s2 * inv_c - mu * mu + eps);
    for (int c = lane; c < C; c += 32)
      ys[o * ldy + c] = from_f<Y>(to_f(from_f<T>((z[c] - mu) * r * to_f(lns[c]) + to_f(lnb[c]))));
  }
}

// ---------------------------------------------------------------------------
// float32: scalar FMAs
// ---------------------------------------------------------------------------

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
  float acc[kMaxTokens / 8];
#pragma unroll
  for (int i = 0; i < kMaxTokens / 8; ++i) {
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
      for (int i = 0; i < kMaxTokens / 8; ++i)
        if (ty + 8 * i < R) acc[i] = fmaf(a[(ty + 8 * i) * lda + kb + kk], wv, acc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < kMaxTokens / 8; ++i) {
    const int r = ty + 8 * i;
    if (r < R) {
      dst[r * ldd + dcol0 + tx] = acc[i];
    }
  }
}

__global__ void __launch_bounds__(kThreadsF32)
    convnext_block_f32(const float* __restrict__ x, const float* __restrict__ dwk,
                       const float* __restrict__ dwb, const float* __restrict__ lns,
                       const float* __restrict__ lnb, const float* __restrict__ w1,
                       const float* __restrict__ b1, const float* __restrict__ w2,
                       const float* __restrict__ b2, const float* __restrict__ gamma,
                       float* __restrict__ out, int P, int H, int W, int C, int no,
                       float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int hid = 4 * C, p0 = blockIdx.x * no;
  unsigned char* p = smem;
  float* zs = reinterpret_cast<float*>(p); p += align128((size_t)no * C * 4);  // then out
  float* ys = reinterpret_cast<float*>(p); p += align128((size_t)no * C * 4);
  float* hf = reinterpret_cast<float*>(p); p += align128((size_t)no * kHfLd * 4);
  float* ws = reinterpret_cast<float*>(p); p += align128(32 * kWsLd * 4);
  float* b1s = reinterpret_cast<float*>(p);

  dwconv7(zs, x, dwk, dwb, p0, no, P, H, W, C);
  __syncthreads();
  layer_norm(ys, C, zs, lns, lnb, no, C, eps);
  __syncthreads();
  float* os = zs;  // z is consumed: zs becomes the output accumulator
  for (int i = threadIdx.x; i < no * C; i += kThreadsF32) os[i] = 0.f;

  for (int h0 = 0; h0 < hid; h0 += kHC) {
    for (int j = threadIdx.x; j < kHC; j += kThreadsF32) b1s[j] = b1[h0 + j];
    for (int n0 = 0; n0 < kHC; n0 += 32)
      gemm32_f32(hf, kHfLd, n0, false, ys, C, no, w1, C, h0 + n0, 0, C, ws);
    __syncthreads();
    for (int i = threadIdx.x; i < no * kHC; i += kThreadsF32) {
      const int o = i / kHC, j = i % kHC;
      hf[o * kHfLd + j] = gelu<float>(hf[o * kHfLd + j] + b1s[j]);
    }
    for (int n0 = 0; n0 < C; n0 += 32)
      gemm32_f32(os, C, n0, true, hf, kHfLd, no, w2, hid, n0, h0, kHC, ws);
    __syncthreads();  // the next chunk restages b1s and rewrites hf
  }

  for (int i = threadIdx.x; i < no * C; i += kThreadsF32) {
    const int o = i / C, c = i % C;
    const size_t g = (size_t)(p0 + o) * C + c;
    if (p0 + o < P) out[g] = x[g] + (os[i] + b2[c]) * gamma[c];
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor-core 16x16x16 MMAs (WMMA), f32 accumulation
// ---------------------------------------------------------------------------

// Asynchronous 16-byte copies of one weight chunk of HC hidden channels
// into shared memory, as B operands of the MMAs: w1s[n][k] = W1[h0 + n][k]
// (rows of C + 8) and w2s[n][k] = W2[n][h0 + k] (rows of HC + 8).
template <int HC>
__device__ __forceinline__ void stage_w1(bf16* w1s, const bf16* __restrict__ w1, int h0, int C) {
  const int vpr = C / 8;
  for (int i = threadIdx.x; i < HC * vpr; i += kThreadsTC) {
    const int n = i / vpr, v = i % vpr;
    __pipeline_memcpy_async(w1s + n * (C + kPad) + v * 8, w1 + (size_t)(h0 + n) * C + v * 8, 16);
  }
}

template <int HC>
__device__ __forceinline__ void stage_w2(bf16* w2s, const bf16* __restrict__ w2, int h0, int C) {
  constexpr int vpr = HC / 8;
  for (int i = threadIdx.x; i < C * vpr; i += kThreadsTC) {
    const int n = i / vpr, v = i % vpr;
    __pipeline_memcpy_async(w2s + n * (HC + kPad) + v * 8, w2 + (size_t)n * 4 * C + h0 + v * 8, 16);
  }
}

// HC, the hidden channels per chunk, is 64, or 32 where two chunks of 64
// do not fit beside the rest (C = 768).
template <int HC>
__global__ void __launch_bounds__(kThreadsTC)
    convnext_block_bf16(const bf16* __restrict__ x, const bf16* __restrict__ dwk,
                        const bf16* __restrict__ dwb, const bf16* __restrict__ lns,
                        const bf16* __restrict__ lnb, const bf16* __restrict__ w1,
                        const bf16* __restrict__ b1, const bf16* __restrict__ w2,
                        const bf16* __restrict__ b2, const bf16* __restrict__ gamma,
                        bf16* __restrict__ out, float* __restrict__ partial, int H, int W,
                        int C, int no, int cc, float eps, int nsplit) {
  constexpr int hf_ld = HC + 4, gs_ld = HC + kPad;
  constexpr int ncol = HC / 16, ngrp = kWarpsTC / ncol;         // fc1 column tiles, row groups
  constexpr int max_rows = (kMaxTokens / 16 + ngrp - 1) / ngrp;  // fc1 row tiles per warp
  extern __shared__ __align__(128) unsigned char smem[];
  // tokens q0 .. q0 + nq of image b (blocks stay inside one image)
  const int hw = H * W, per_image = (hw + no - 1) / no;
  const int b = blockIdx.x / per_image, q0 = (blockIdx.x % per_image) * no;
  const int nq = min(no, hw - q0);
  const size_t p0 = (size_t)b * hw + q0;
  const int hid = 4 * C, ldy = C + kPad;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // this block's share of the hidden chunks (split blockIdx.y of nsplit)
  const int per_split = (hid / HC + nsplit - 1) / nsplit * HC;
  const int h_begin = min(hid, (int)blockIdx.y * per_split);
  const int h_end = min(hid, h_begin + per_split);
  unsigned char* p = smem;
  // z lives only until the LayerNorm; then its room holds the weight
  // chunks, and after the last chunk the epilogue's per-warp scratch
  const size_t w1_bytes = align128((size_t)HC * ldy * 2);
  const size_t w_bytes = w1_bytes + align128((size_t)C * gs_ld * 2);
  const size_t z_bytes = align128((size_t)no * C * 4), sc_bytes = (size_t)kWarpsTC * 256 * 4;
  float* zs = reinterpret_cast<float*>(p);
  bf16* w1s = reinterpret_cast<bf16*>(p);
  bf16* w2s = reinterpret_cast<bf16*>(p + w1_bytes);
  float* scratch = reinterpret_cast<float*>(p);
  p += z_bytes > w_bytes ? (z_bytes > sc_bytes ? z_bytes : sc_bytes)
                         : (w_bytes > sc_bytes ? w_bytes : sc_bytes);
  bf16* ys = reinterpret_cast<bf16*>(p); p += align128((size_t)no * ldy * 2);
  float* hf = reinterpret_cast<float*>(p); p += align128((size_t)no * hf_ld * 4);
  bf16* gs = reinterpret_cast<bf16*>(p); p += align128((size_t)no * gs_ld * 2);
  float* b1s = reinterpret_cast<float*>(p);

  dwconv7_staged(zs, ys, x, dwk, dwb, b, q0, nq, no, H, W, C, cc);  // ys holds x's rows
  __syncthreads();
  layer_norm(ys, ldy, zs, lns, lnb, no, C, eps);
  __syncthreads();  // z is consumed
  if (h_begin < h_end) stage_w1<HC>(w1s, w1, h_begin, C);
  __pipeline_commit();

  // output tiles: warp w owns tiles w, w + 16, ... of (no/16) x (C/16)
  const int oct = C / 16, n_out = (no / 16) * oct;
  FragC acc[kMaxOutFrags];
#pragma unroll
  for (int f = 0; f < kMaxOutFrags; ++f) wmma::fill_fragment(acc[f], 0.f);

  // pwconv1 tiles: warp w owns column tile w % ncol and row tiles
  // w / ncol + ngrp * i. Weight chunks arrive by cp.async, two in flight:
  // W2's chunk h during pwconv1(h), W1's chunk h + 1 during GELU and
  // pwconv2(h).
  const int hct = warp % ncol, rg = warp / ncol, nrt = no / 16;
  for (int h0 = h_begin; h0 < h_end; h0 += HC) {
    stage_w2<HC>(w2s, w2, h0, C);  // w2s is free: pwconv2(h - 1) ended with a barrier
    __pipeline_commit();
    for (int j = threadIdx.x; j < HC; j += kThreadsTC) b1s[j] = __bfloat162float(b1[h0 + j]);
    __pipeline_wait_prior(1);  // this thread's copies of W1's chunk h
    __syncthreads();           // everyone's
    {
      FragC hacc[max_rows];
#pragma unroll
      for (int i = 0; i < max_rows; ++i) wmma::fill_fragment(hacc[i], 0.f);
      const bf16* wcol = w1s + hct * 16 * ldy;
      for (int k = 0; k < C; k += 16) {
        FragBCol bw;
        wmma::load_matrix_sync(bw, wcol + k, ldy);
#pragma unroll
        for (int i = 0; i < max_rows; ++i) {
          const int rt = rg + ngrp * i;
          if (rt < nrt) {
            FragA a;
            wmma::load_matrix_sync(a, ys + rt * 16 * ldy + k, ldy);
            wmma::mma_sync(hacc[i], a, bw, hacc[i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < max_rows; ++i) {
        const int rt = rg + ngrp * i;
        if (rt < nrt)
          wmma::store_matrix_sync(hf + rt * 16 * hf_ld + hct * 16, hacc[i], hf_ld,
                                  wmma::mem_row_major);
      }
    }
    __syncthreads();  // w1s is free
    if (h0 + HC < h_end) stage_w1<HC>(w1s, w1, h0 + HC, C);
    __pipeline_commit();
    for (int i = threadIdx.x; i < no * HC; i += kThreadsTC) {
      const int o = i / HC, j = i % HC;
      gs[o * gs_ld + j] = __float2bfloat16(gelu<bf16>(hf[o * hf_ld + j] + b1s[j]));
    }
    __pipeline_wait_prior(1);  // this thread's copies of W2's chunk h
    __syncthreads();

    // out += g . W2[:, h0:h0+HC]^T (w2s read as a column-major B)
#pragma unroll
    for (int f = 0; f < kMaxOutFrags; ++f) {
      const int i = warp + kWarpsTC * f;
      if (i < n_out) {
        const int rt = i / oct, ct = i % oct;
#pragma unroll
        for (int kk = 0; kk < HC; kk += 16) {
          FragA a;
          FragBCol bw;
          wmma::load_matrix_sync(a, gs + rt * 16 * gs_ld + kk, gs_ld);
          wmma::load_matrix_sync(bw, w2s + ct * 16 * gs_ld + kk, gs_ld);
          wmma::mma_sync(acc[f], a, bw, acc[f]);
        }
      }
    }
    __syncthreads();  // w2s, gs and b1s are free
  }

  float* sc = scratch + warp * 256;
#pragma unroll
  for (int f = 0; f < kMaxOutFrags; ++f) {
    const int i = warp + kWarpsTC * f;
    if (i < n_out) {
      const int rt = i / oct, ct = i % oct;
      wmma::store_matrix_sync(sc, acc[f], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int o = rt * 16 + e / 16, c = ct * 16 + e % 16;
        if (o < nq) {
          const size_t g = (p0 + o) * C + c;
          if (nsplit == 1) {
            const float h = (sc[e] + __bfloat162float(b2[c])) * __bfloat162float(gamma[c]);
            out[g] = __float2bfloat16(__bfloat162float(x[g]) + h);
          } else {  // f32 partial sum of this block's hidden chunks
            partial[blockIdx.y * ((size_t)gridDim.x / per_image) * hw * C + g] = sc[e];
          }
        }
      }
      __syncwarp();
    }
  }
}

// out = T(x + (sum_z partial[z] + b2) * gamma) over the splits, in order.
__global__ void __launch_bounds__(256)
    convnext_block_reduce(const float* __restrict__ partial, const bf16* __restrict__ x,
                          const bf16* __restrict__ b2, const bf16* __restrict__ gamma,
                          bf16* __restrict__ out, size_t total, int C, int nsplit) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < nsplit; ++z) s += partial[z * total + i];
    const int c = (int)(i % C);
    const float h = (s + __bfloat162float(b2[c])) * __bfloat162float(gamma[c]);
    out[i] = __float2bfloat16(__bfloat162float(x[i]) + h);
  }
}

// Shared memory of one block; kernels/convnext_block.py:smem_bytes mirrors it.
size_t smem_bytes(int dtype, int C, int no, int hc) {
  if (dtype == 0)
    return 2 * align128((size_t)no * C * 4) + align128((size_t)no * kHfLd * 4) +
           align128(32 * kWsLd * 4) + align128(kHC * 4);
  const size_t w = align128((size_t)hc * (C + kPad) * 2) + align128((size_t)C * (hc + kPad) * 2);
  const size_t sc = (size_t)kWarpsTC * 256 * 4;
  return std::max({align128((size_t)no * C * 4), w, sc}) + align128((size_t)no * (C + kPad) * 2) +
         align128((size_t)no * (hc + 4) * 4) + align128((size_t)no * (hc + kPad) * 2) +
         align128(kHC * 4);
}

int set_smem(const void* kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

template <int HC>
int launch_bf16(const void* x, const void* dwk, const void* dwb, const void* lns,
                const void* lnb, const void* w1, const void* b1, const void* w2,
                const void* b2, const void* gamma, void* out, void* partial, int B, int H,
                int W, int C, int no, int cc, float eps, int nsplit, cudaStream_t st) {
  const size_t smem = smem_bytes(1, C, no, HC);
  int err = set_smem((const void*)convnext_block_bf16<HC>, smem);
  if (err != 0) return err;
  const int blocks = B * ((H * W + no - 1) / no);
  convnext_block_bf16<HC><<<dim3(blocks, nsplit), kThreadsTC, smem, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dwk), static_cast<const bf16*>(dwb),
      static_cast<const bf16*>(lns), static_cast<const bf16*>(lnb), static_cast<const bf16*>(w1),
      static_cast<const bf16*>(b1), static_cast<const bf16*>(w2), static_cast<const bf16*>(b2),
      static_cast<const bf16*>(gamma), static_cast<bf16*>(out), static_cast<float*>(partial),
      H, W, C, no, cc, eps, nsplit);
  err = (int)cudaGetLastError();
  if (err != 0 || nsplit == 1) return err;
  const size_t total = (size_t)B * H * W * C;
  const int rblocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  convnext_block_reduce<<<rblocks, 256, 0, st>>>(
      static_cast<const float*>(partial), static_cast<const bf16*>(x),
      static_cast<const bf16*>(b2), static_cast<const bf16*>(gamma), static_cast<bf16*>(out),
      total, C, nsplit);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Every pointer is a contiguous device
// buffer: x and out (B, H, W, C); dwk (C, 1, 7, 7); dwb, lns, lnb, b2, gamma
// (C); w1 (4C, C); b1 (4C); w2 (C, 4C). ``no`` (tokens per block, a multiple
// of 16, at most 64) and ``hc`` (hidden channels per bf16 chunk, 64 or 32;
// float32 always takes 64) come from kernels/convnext_block.py:choose_tokens,
// which holds the bf16 accumulator count and the shared memory within this
// file's limits, and ``cc`` (channels per copy of x's rows at bf16) from
// kernels/convnext_block.py:stage_channels. Requires C % 32 == 0. At bf16,
// a block's tokens stay inside one image, and nsplit > 1 splits the hidden
// dimension over that many blocks per token tile, each adding its f32
// partial product into partial (nsplit x B x H x W x C), which a second
// kernel sums; float32 takes nsplit = 1.
// Returns cudaGetLastError() after the launches (0 on success).
int pf_convnext_block(int dtype, const void* x, const void* dwk, const void* dwb,
                      const void* lns, const void* lnb, const void* w1, const void* b1,
                      const void* w2, const void* b2, const void* gamma, void* out,
                      void* partial, int B, int H, int W, int C, int no, int hc, int cc,
                      float eps, int nsplit, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C % 32 != 0 || no % 16 != 0 || no < 16 || no > kMaxTokens || nsplit < 1 ||
      (nsplit > 1 && (dtype != 1 || partial == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int P = B * H * W;
  if (dtype == 0) {
    const size_t smem = smem_bytes(0, C, no, kHC);
    int err = set_smem((const void*)convnext_block_f32, smem);
    if (err != 0) return err;
    convnext_block_f32<<<(P + no - 1) / no, kThreadsF32, smem, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(dwk),
        static_cast<const float*>(dwb), static_cast<const float*>(lns),
        static_cast<const float*>(lnb), static_cast<const float*>(w1),
        static_cast<const float*>(b1), static_cast<const float*>(w2),
        static_cast<const float*>(b2), static_cast<const float*>(gamma),
        static_cast<float*>(out), P, H, W, C, no, eps);
    return (int)cudaGetLastError();
  }
  // the staged conv: cc divides C and the block, and the rows fit in ys
  const int rows = min(H, (no - 1) / W + 8);
  if (dtype != 1 || (no / 16) * (C / 16) > kWarpsTC * kMaxOutFrags || cc % 8 != 0 ||
      C % cc != 0 || kThreadsTC % cc != 0 ||
      (size_t)rows * W * cc > (size_t)no * (C + kPad))
    return (int)cudaErrorInvalidValue;
  if (hc == 64)
    return launch_bf16<64>(x, dwk, dwb, lns, lnb, w1, b1, w2, b2, gamma, out, partial, B, H,
                           W, C, no, cc, eps, nsplit, st);
  if (hc == 32)
    return launch_bf16<32>(x, dwk, dwb, lns, lnb, w1, b1, w2, b2, gamma, out, partial, B, H,
                           W, C, no, cc, eps, nsplit, st);
  return (int)cudaErrorInvalidValue;
}

const char* pf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

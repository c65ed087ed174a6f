// Fused MixFFN for Hopper (sm_90a), bfloat16 and float32.
//
// Replaces the TPU kernel perspectivefields_tpu/kernels/mixffn.py:
// mixffn_fused (its pallas_call; body _ffn_kernel) and computes its function
// with its casts, for x (B, H, W, C) and hidden width 4C:
//
//   h   = T(mask(x . W1^T + b1))        f32 accumulation; mask zeroes the
//                                       hidden map outside the image (the
//                                       3x3 conv zero-pads h, not x, and
//                                       fc1(0) = b1 != 0)
//   z   = dw3x3(h) + dwb                f32 accumulation
//   g   = T(gelu_f32(z))                tanh form at bf16, erf at f32
//   out = T(g . W2^T + b2)              f32 accumulation
//
// T is the compute dtype. Weights keep the torch layouts: W1 (4C, C) and
// W2 (C, 4C) as nn.Linear (out, in), the depthwise kernel (4C, 1, 3, 3).
//
// What bounds it on the H100: the CUDA-core work on the 4C-wide hidden map
// (9 taps and GELU per element) and bytes, both small: ~3-6 us a call at the
// flagship's B=8 shapes (kernels/roofline.py). Unfused, the hidden map goes
// through HBM five times (fc1 out, dwconv in and out, GELU in and out)
// around two thin GEMMs. What this design does about it: a block owns a
// TH x TW tile of one image plus a 1-pixel halo and walks the hidden
// dimension in chunks of 64 channels. For each chunk it runs fc1 on the
// halo'd tokens, masks, rounds, applies the depthwise conv, bias and GELU in
// shared memory, and adds that chunk's fc2 partial product into the output
// accumulator (registers at bf16). The hidden map never exists whole, on
// chip or in HBM: HBM sees one read of x and one write of out. Where the
// tiles alone would leave SMs idle (few tokens, as at stage 4), the bf16
// kernel also splits the hidden dimension over blocks, which add f32
// partial outputs that a second kernel sums in a fixed order. The halo
// costs recomputing fc1 on (TH+2)(TW+2) tokens for TH*TW outputs; the
// wrapper picks the tile (kernels/mixffn.py:choose_tile).
//
// Every block reads all of W1 and W2 from L2, so at bf16 each weight chunk
// is copied into shared memory by cp.async, the next one in flight while
// this one is used. Between the two GEMMs of a chunk the block does
// per-element work (mask, 9 taps, GELU) on the whole halo'd tile, so the
// bf16 kernel runs 16 warps, and each token's halo validity and tap offset
// are computed once per block rather than once per chunk.
//
// bfloat16 runs both GEMMs on the tensor cores with warp-level 16x16x16
// MMAs (WMMA), f32 accumulation. float32 runs scalar FMAs (the tensor
// cores' f32 input is TF32, which would not match f32); its chunked fc2
// continues one FMA chain over the hidden dimension and its taps run in
// row-major order, so it rounds as the unfused path on the card does.
// Simple by intent: no wgmma, no TMA, no warp specialisation.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stddef.h>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kThreadsF32 = 256;       // float32 kernel: 8 warps
constexpr int kThreadsTC = 512;        // bfloat16 kernel: 16 warps
constexpr int kWarpsTC = kThreadsTC / 32;
constexpr int kHC = 64;                // hidden channels per chunk
constexpr int kMaxHalo = 128;          // halo tokens per block, padded to 16
constexpr int kMaxOutFrags = 4;        // bf16: 16x16 output tiles per warp
constexpr int kPad = 8;                // bf16 row padding (16 bytes)
constexpr int kHfLd = kHC + 4;         // row of the f32 hidden chunk
constexpr int kGsLd = kHC + kPad;      // row of the bf16 GELU chunk
constexpr int kWsLd = 33;              // row of a staged f32 weight tile

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

__global__ void __launch_bounds__(kThreadsF32)
    mixffn_f32(const float* __restrict__ x, const float* __restrict__ w1,
               const float* __restrict__ b1, const float* __restrict__ dwk,
               const float* __restrict__ dwb, const float* __restrict__ w2,
               const float* __restrict__ b2, float* __restrict__ out, int H, int W,
               int C, int th, int tw) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Tile tl(H, W, th, tw);
  const int hid = 4 * C;
  unsigned char* p = smem;
  float* xs = reinterpret_cast<float*>(p); p += align128((size_t)tl.nhp * C * 4);
  float* hf = reinterpret_cast<float*>(p); p += align128((size_t)tl.nhp * kHfLd * 4);
  float* gs = reinterpret_cast<float*>(p); p += align128((size_t)tl.nop * kHfLd * 4);
  float* os = reinterpret_cast<float*>(p); p += align128((size_t)tl.nop * C * 4);
  float* ws = reinterpret_cast<float*>(p); p += align128(32 * kWsLd * 4);
  float* b1s = reinterpret_cast<float*>(p); p += align128(kHC * 4);
  float* dwbs = reinterpret_cast<float*>(p); p += align128(kHC * 4);
  Tables tb{reinterpret_cast<float*>(p), reinterpret_cast<int*>(p + kMaxHalo * 4)};

  fill_tables(tb, tl, H, W);
  for (int i = threadIdx.x; i < tl.nhp * C; i += kThreadsF32) {
    const int t = i / C, c = i % C;
    int y, xx;
    xs[i] = tl.halo_pixel(t, H, W, y, xx) ? x[(((size_t)tl.b * H + y) * W + xx) * C + c] : 0.f;
  }
  for (int i = threadIdx.x; i < tl.nop * C; i += kThreadsF32) os[i] = 0.f;

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

  for (int i = threadIdx.x; i < tl.no * C; i += kThreadsF32) {
    const int o = i / C, c = i % C;
    const int y = tl.y0 + o / tl.tw, xx = tl.x0 + o % tl.tw;
    if (y < H && xx < W)
      out[(((size_t)tl.b * H + y) * W + xx) * C + c] = os[i] + b2[c];
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor-core 16x16x16 MMAs (WMMA), f32 accumulation
// ---------------------------------------------------------------------------

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

__global__ void __launch_bounds__(kThreadsTC)
    mixffn_bf16(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                const bf16* __restrict__ b1, const bf16* __restrict__ dwk,
                const bf16* __restrict__ dwb, const bf16* __restrict__ w2,
                const bf16* __restrict__ b2, bf16* __restrict__ out,
                float* __restrict__ partial, int H, int W, int C, int th, int tw,
                int nsplit) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Tile tl(H, W, th, tw);
  const int hid = 4 * C, ldx = C + kPad;
  // this block's share of the hidden chunks (split blockIdx.z of nsplit)
  const int per_split = (hid / kHC + nsplit - 1) / nsplit * kHC;
  const int h_begin = min(hid, (int)blockIdx.z * per_split);
  const int h_end = min(hid, h_begin + per_split);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  unsigned char* p = smem;
  bf16* xs = reinterpret_cast<bf16*>(p); p += align128((size_t)tl.nhp * ldx * 2);
  // the weight chunks; after the last chunk, the epilogue's per-warp scratch
  const size_t w1_bytes = align128((size_t)kHC * ldx * 2);
  const size_t w_bytes = w1_bytes + align128((size_t)C * kGsLd * 2);
  const size_t sc_bytes = (size_t)kWarpsTC * 256 * 4;
  bf16* w1s = reinterpret_cast<bf16*>(p);
  bf16* w2s = reinterpret_cast<bf16*>(p + w1_bytes);
  float* scratch = reinterpret_cast<float*>(p);
  p += w_bytes > sc_bytes ? w_bytes : sc_bytes;
  float* hf = reinterpret_cast<float*>(p); p += align128((size_t)tl.nhp * kHfLd * 4);
  bf16* gs = reinterpret_cast<bf16*>(p); p += align128((size_t)tl.nop * kGsLd * 2);
  float* b1s = reinterpret_cast<float*>(p); p += align128(kHC * 4);
  float* dwbs = reinterpret_cast<float*>(p); p += align128(kHC * 4);
  Tables tb{reinterpret_cast<float*>(p), reinterpret_cast<int*>(p + kMaxHalo * 4)};

  if (h_begin < h_end) stage_w1(w1s, w1, h_begin, C);
  __pipeline_commit();
  fill_tables(tb, tl, H, W);
  const int vpr = C / 8;  // 16-byte vectors per token row
  for (int i = threadIdx.x; i < tl.nhp * vpr; i += kThreadsTC) {
    const int t = i / vpr, v = i % vpr;
    int y, xx;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (tl.halo_pixel(t, H, W, y, xx))
      val = reinterpret_cast<const uint4*>(x + (((size_t)tl.b * H + y) * W + xx) * C)[v];
    *reinterpret_cast<uint4*>(xs + t * ldx + v * 8) = val;
  }

  // output tiles: warp w owns tiles w, w + 16, ... of (nop/16) x (C/16)
  const int oct = C / 16, n_out = (tl.nop / 16) * oct;
  FragC acc[kMaxOutFrags];
#pragma unroll
  for (int f = 0; f < kMaxOutFrags; ++f) wmma::fill_fragment(acc[f], 0.f);

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
        if (o < tl.no) {
          const int y = tl.y0 + o / tl.tw, xx = tl.x0 + o % tl.tw;
          if (y < H && xx < W) {
            const size_t g = (((size_t)tl.b * H + y) * W + xx) * C + c;
            if (nsplit == 1)
              out[g] = __float2bfloat16(sc[e] + __bfloat162float(b2[c]));
            else  // f32 partial sum of this block's hidden chunks
              partial[blockIdx.z * (size_t)gridDim.y * H * W * C + g] = sc[e];
          }
        }
      }
      __syncwarp();
    }
  }
}

// out = T(sum_z partial[z] + b2) over the splits, in order.
__global__ void __launch_bounds__(256)
    mixffn_reduce(const float* __restrict__ partial, const bf16* __restrict__ b2,
                  bf16* __restrict__ out, size_t total, int C, int nsplit) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < nsplit; ++z) s += partial[z * total + i];
    out[i] = __float2bfloat16(s + __bfloat162float(b2[i % C]));
  }
}

// Shared memory of one block; kernels/mixffn.py:smem_bytes mirrors it.
size_t smem_bytes(int dtype, int C, int th, int tw) {
  const int nhp = ceil16((th + 2) * (tw + 2)), nop = ceil16(th * tw);
  const size_t small = 2 * align128(kHC * 4) + 2 * kMaxHalo * 4;  // biases, tables
  if (dtype == 0)
    return align128((size_t)nhp * C * 4) + align128((size_t)nhp * kHfLd * 4) +
           align128((size_t)nop * kHfLd * 4) + align128((size_t)nop * C * 4) +
           align128(32 * kWsLd * 4) + small;
  const size_t w = align128((size_t)kHC * (C + kPad) * 2) + align128((size_t)C * kGsLd * 2);
  const size_t sc = (size_t)kWarpsTC * 256 * 4;
  return align128((size_t)nhp * (C + kPad) * 2) + (w > sc ? w : sc) +
         align128((size_t)nhp * kHfLd * 4) + align128((size_t)nop * kGsLd * 2) + small;
}

int set_smem(const void* kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Every pointer is a contiguous device
// buffer: x and out (B, H, W, C); w1 (4C, C); b1, dwb (4C); dwk (4C, 1, 3, 3);
// w2 (C, 4C); b2 (C). The tile (th, tw) comes from kernels/mixffn.py:
// choose_tile, which holds (th+2)(tw+2) <= 128, the bf16 accumulator count
// and the shared memory within this file's limits. Requires C % 32 == 0.
// At bf16, nsplit > 1 splits the hidden dimension over that many blocks per
// tile, each adding its f32 partial product into partial (nsplit x B x H x
// W x C), which a second kernel sums; float32 takes nsplit = 1.
// Returns cudaGetLastError() after the launches (0 on success).
int pf_mixffn(int dtype, const void* x, const void* w1, const void* b1, const void* dwk,
              const void* dwb, const void* w2, const void* b2, void* out, void* partial,
              int B, int H, int W, int C, int th, int tw, int nsplit, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C % 32 != 0 || ceil16((th + 2) * (tw + 2)) > kMaxHalo || nsplit < 1 ||
      (nsplit > 1 && (dtype != 1 || partial == nullptr)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(dtype, C, th, tw);
  const dim3 grid(((H + th - 1) / th) * ((W + tw - 1) / tw), B, nsplit);
  if (dtype == 0) {
    int err = set_smem((const void*)mixffn_f32, smem);
    if (err != 0) return err;
    mixffn_f32<<<grid, kThreadsF32, smem, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w1),
        static_cast<const float*>(b1), static_cast<const float*>(dwk),
        static_cast<const float*>(dwb), static_cast<const float*>(w2),
        static_cast<const float*>(b2), static_cast<float*>(out), H, W, C, th, tw);
    return (int)cudaGetLastError();
  }
  if (dtype != 1 || (ceil16(th * tw) / 16) * (C / 16) > kWarpsTC * kMaxOutFrags)
    return (int)cudaErrorInvalidValue;
  int err = set_smem((const void*)mixffn_bf16, smem);
  if (err != 0) return err;
  mixffn_bf16<<<grid, kThreadsTC, smem, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1), static_cast<const bf16*>(b1),
      static_cast<const bf16*>(dwk), static_cast<const bf16*>(dwb),
      static_cast<const bf16*>(w2), static_cast<const bf16*>(b2), static_cast<bf16*>(out),
      static_cast<float*>(partial), H, W, C, th, tw, nsplit);
  err = (int)cudaGetLastError();
  if (err != 0 || nsplit == 1) return err;
  const size_t total = (size_t)B * H * W * C;
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  mixffn_reduce<<<blocks, 256, 0, st>>>(static_cast<const float*>(partial),
                                        static_cast<const bf16*>(b2), static_cast<bf16*>(out),
                                        total, C, nsplit);
  return (int)cudaGetLastError();
}

const char* pf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

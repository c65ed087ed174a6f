// Whole MiT block after LN1 for Hopper (sm_90a), bfloat16 and float32.
//
// Replaces the TPU kernel perspectivefields_tpu/kernels/fused_block.py:
// fused_block (its pallas_call; body _kernel) and computes the function of
// its oracle _xla_reference with the module chain's casts, for the LN1'd
// tokens ln1x (B, N = H*W, C), the reduced keys kv_in (B, M, C), the block
// input res (B, N, C), head_dim 64 and hidden width 4C:
//
//   a   = attention(ln1x, kv_in)       fused_attention.cu's function and casts
//   x2  = T(res + a)                   first skip
//   y   = T(LN2(x2))                   nn.LayerNorm's f32 Welford moments
//   o   = MixFFN(y)                    mixffn.cu's function and casts
//   out = T(x2 + o)                    second skip
//
// T is the compute dtype. Weights keep the torch layouts: nn.Linear (out, in),
// the depthwise kernel (4C, 1, 3, 3).
//
// What bounds it on the H100: at the flagship's B=8 shapes, operations
// (~0.15 ms per forward of tensor-core work, kernels/roofline.py). Unfused,
// the block moves every intermediate through HBM: the (B, N, C) attention
// output, x2 and y, and the 4C-wide hidden map five times. What this design
// does about it: a first launch projects K/V into a (B, M, 2C) scratch
// tensor (attention_common.cuh). Then one block owns a TH x TW tile of one
// image plus a 1-pixel halo (the 3x3 conv needs it) and keeps everything
// on chip:
//   1. attention on the halo'd tokens, 32 at a time (fused_attention.cu's
//      sub-block: q projection, per head logits / softmax / P.V, out
//      projection), x2 = res + a, and LN2 into y for every halo token; x2
//      is kept for the tile's own tokens;
//   2. the MixFFN on y, walking the hidden dimension in 64-channel chunks
//      (mixffn_common.cuh: fc1, the hidden map's zero padding outside the
//      image, the 3x3 taps, GELU, that chunk's fc2 product);
//   3. out = x2 + o for the tile's own tokens.
// HBM sees ln1x, res and K/V read and out written. The halo costs attention
// and fc1 on (TH+2)(TW+2) tokens for TH*TW outputs; kernels/fused_block.py:
// choose_tile picks the tile. Shared memory holds y and x2 for the whole
// block, and one room that the attention phase and then the FFN phase use.
//
// bfloat16 runs every product on the tensor cores with warp-level 16x16x16
// MMAs (WMMA), f32 accumulation, 16 warps. float32 runs scalar FMAs summed
// in cuBLAS's order (one FMA chain over k), as the attention and MixFFN
// kernels do. Simple by intent: no wgmma, no TMA, no split of the hidden
// dimension over blocks.

#include "attention_common.cuh"
#include "mixffn_common.cuh"

namespace {

constexpr int kSub = 32;  // halo tokens per attention sub-tile

// Layout of one block's shared memory (kernels/fused_block.py: smem_bytes
// mirrors it): the persistent room (y, x2, FFN biases, index tables), then
// one room that phase 1 (attention) and phase 2 (FFN) reuse.
struct Layout {
  size_t ys, x2s, b1s, dwbs, tables, room;  // byte offsets
  size_t a_xs, a_qs, a_ks, a_vs, a_ps, a_ss, a_sc, a_end;  // phase 1, from room
  size_t f_w, f_hf, f_gs, f_os, f_ws, f_end;               // phase 2, from room
  __host__ __device__ Layout(int dtype, int C, int nhp, int no, int nop) {
    const size_t isz = dtype == 0 ? 4 : 2;
    const size_t ld = dtype == 0 ? C : C + kPad;  // row of a C-wide tile
    ys = 0;
    x2s = ys + align128(nhp * ld * isz);
    b1s = x2s + align128(no * ld * isz);
    dwbs = b1s + align128(kHC * 4);
    tables = dwbs + align128(kHC * 4);
    room = tables + 2 * kMaxHalo * 4;
    if (dtype == 0) {
      a_xs = room;
      a_qs = a_xs + align128(kSub * ld * 4);
      a_ss = a_qs + align128(kSub * ld * 4);
      a_sc = a_ss + align128(kSub * kMaxM * 4);  // the staged weight tile
      a_end = a_sc + align128(32 * kWsLd * 4);
      a_ks = a_vs = a_ps = a_end;  // unused at f32: K and V are staged per 32 x 32 tile
      f_w = room;  // unused at f32
      f_hf = room;
      f_gs = f_hf + align128(nhp * kHfLd * 4);
      f_os = f_gs + align128(nop * kHfLd * 4);
      f_ws = f_os + align128(nop * ld * 4);
      f_end = f_ws + align128(32 * kWsLd * 4);
    } else {
      a_xs = room;
      a_qs = a_xs + align128(kSub * ld * 2);
      a_ks = a_qs + align128(kSub * ld * 2);
      a_vs = a_ks + align128(kMaxM * kHdLd * 2);
      a_ps = a_vs + align128(kMaxM * kHdLd * 2);
      a_ss = a_ps + align128(kSub * kPLd * 2);
      a_sc = a_ss + align128(kSub * kSLd * 4);
      a_end = a_sc + kWarpsTC * 256 * 4;
      const size_t w = align128(kHC * ld * 2) + align128(C * kGsLd * 2);
      const size_t sc = kWarpsTC * 256 * 4;  // the epilogue's scratch, over the weights
      f_w = room;
      f_hf = f_w + (w > sc ? w : sc);
      f_gs = f_hf + align128(nhp * kHfLd * 4);
      f_end = f_gs + align128(nop * kGsLd * 2);
      f_os = f_ws = f_end;  // unused at bf16: the accumulators live in registers
    }
  }
  __host__ __device__ size_t bytes() const { return a_end > f_end ? a_end : f_end; }
};

// The halo token t of the tile: its image pixel (false outside the image)
// and, for the tile's own tokens, its output index o (else -1).
__device__ __forceinline__ bool halo_token(const Tile& tl, int t, int H, int W, int& pix,
                                           int& o) {
  int y, x;
  const bool in = tl.halo_pixel(t, H, W, y, x);
  pix = y * W + x;
  const int hy = t / tl.hw, hx = t % tl.hw;
  o = in && hy >= 1 && hy <= tl.th && hx >= 1 && hx <= tl.tw ? (hy - 1) * tl.tw + hx - 1 : -1;
  return in;
}

// Welford moments (mean, sum of squared deviations, count), combined as
// PyTorch's CUDA LayerNorm combines them (layer_norm_kernel.cu:
// cuWelfordOnlineSum, cuWelfordCombine). The terms keep PyTorch's source
// order, since nvcc contracts the first product of a sum into an FMA: with
// the mean's two products swapped, rows whose lanes hold unequal counts
// (C = 320) got another mean in the last bit.
struct Welford {
  float mean, m2, count;
};

__device__ __forceinline__ Welford welford_add(float v, Welford w) {
  const float delta = v - w.mean;
  const float count = w.count + 1.f;
  const float mean = w.mean + delta * (1.f / count);
  return {mean, w.m2 + delta * (v - mean), count};
}

__device__ __forceinline__ Welford welford_combine(Welford b, Welford a) {
  const float count = a.count + b.count;
  if (!(count > 0.f)) return {0.f, 0.f, 0.f};
  const float delta = b.mean - a.mean;
  const float coef = 1.f / count;
  const float na = a.count * coef, nb = b.count * coef;
  return {na * a.mean + nb * b.mean, a.m2 + b.m2 + delta * delta * a.count * nb, count};
}

__device__ __forceinline__ Welford welford_shfl_down(Welford w, int off) {
  return {__shfl_down_sync(0xffffffffu, w.mean, off), __shfl_down_sync(0xffffffffu, w.m2, off),
          __shfl_down_sync(0xffffffffu, w.count, off)};
}

// y = T(s * (rstd * (x2 - mean)) + b) for one row of C values (C % 4 == 0),
// rstd = rsqrt(var + eps), by one warp: the moments of PyTorch's CUDA
// LayerNorm in its order. Its 128 threads (4 warps of 32) each take 4
// consecutive values per 128 x 4 stride, accumulate them one by one, reduce
// within their warp by shuffles down, then across warps (2 and 3 into 0
// and 1, then 1 into 0); here lane l plays thread l + 32 j of warp j. Summed
// so, the f32 fused block rounds as the plain path's nn.LayerNorm does on
// the card.
template <typename T>
__device__ __forceinline__ void layer_norm_row(T* y, const T* x2, const T* __restrict__ lns,
                                               const T* __restrict__ lnb, int C, float eps) {
  const int lane = threadIdx.x % 32;
  Welford w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    w[j] = {0.f, 0.f, 0.f};
    for (int v = lane + 32 * j; v < C / 4; v += 128)
#pragma unroll
      for (int e = 0; e < 4; ++e) w[j] = welford_add(to_f(x2[4 * v + e]), w[j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) w[j] = welford_combine(w[j], welford_shfl_down(w[j], off));
  }
  Welford t = welford_combine(welford_combine(w[0], w[2]), welford_combine(w[1], w[3]));
  const float mean = __shfl_sync(0xffffffffu, t.mean, 0);
  const float var = __shfl_sync(0xffffffffu, t.m2, 0) / (float)C;
  const float rstd = rsqrtf(var + eps);
  for (int c = lane; c < C; c += 32)
    y[c] = from_f<T>(to_f(lns[c]) * (rstd * (to_f(x2[c]) - mean)) + to_f(lnb[c]));
}

// ---------------------------------------------------------------------------
// float32: scalar FMAs, 8 warps; thread (lane, warp) owns column lane and
// rows warp + 8i of each 32-column product (mixffn_common.cuh: gemm32_f32)
// ---------------------------------------------------------------------------

// dst[r][dcol0 + n] = sum_{k < K} a[r][k] * w(n0 + n, k) for r < R <= 128,
// n < 32, with w(n, k) = w[n * sn + k * sk] for n < nmax and k < kmax and 0
// beyond (K % 32 == 0): one FMA chain over k per output. Starts with a
// barrier, so a's writers are done.
__device__ __forceinline__ void gemm32_strided_f32(float* dst, int ldd, int dcol0, const float* a,
                                                   int lda, int R, const float* __restrict__ w,
                                                   size_t sn, size_t sk, int n0, int nmax,
                                                   int kmax, int K, float* ws) {
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  for (int kb = 0; kb < K; kb += 32) {
    __syncthreads();
    for (int i = threadIdx.x; i < 32 * 32; i += kThreadsF32) {
      const int n = n0 + i / 32, k = kb + i % 32;
      ws[(i % 32) * kWsLd + i / 32] = n < nmax && k < kmax ? w[n * sn + k * sk] : 0.f;
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
    block_f32(const float* __restrict__ ln1x, const float* __restrict__ kv,
              const float* __restrict__ res, const float* __restrict__ wq,
              const float* __restrict__ bq, const float* __restrict__ wp,
              const float* __restrict__ bp, const float* __restrict__ lns,
              const float* __restrict__ lnb, const float* __restrict__ w1,
              const float* __restrict__ b1, const float* __restrict__ dwk,
              const float* __restrict__ dwb, const float* __restrict__ w2,
              const float* __restrict__ b2, float* __restrict__ out, int H, int W, int M,
              int C, int heads, int th, int tw, float scale, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Tile tl(H, W, th, tw);
  const Layout L(0, C, tl.nhp, tl.no, tl.nop);
  float* ys = reinterpret_cast<float*>(smem + L.ys);    // nhp x C: y
  float* x2s = reinterpret_cast<float*>(smem + L.x2s);  // no x C: x2 of the tile's tokens
  float* b1s = reinterpret_cast<float*>(smem + L.b1s);
  float* dwbs = reinterpret_cast<float*>(smem + L.dwbs);
  Tables tb{reinterpret_cast<float*>(smem + L.tables),
            reinterpret_cast<int*>(smem + L.tables + kMaxHalo * 4)};
  const int N = H * W, warp = threadIdx.x / 32;
  const size_t two_c = 2 * (size_t)C;
  const float* kvb = kv + (size_t)tl.b * M * two_c;
  const size_t tok0 = (size_t)tl.b * N;  // the image's first token

  fill_tables(tb, tl, H, W);

  // 1. attention, x2 and LN2 for the halo tokens, kSub at a time
  {
    float* xs = reinterpret_cast<float*>(smem + L.a_xs);  // kSub x C: ln1x, then o
    float* qs = reinterpret_cast<float*>(smem + L.a_qs);  // kSub x C: q, then x2
    float* s = reinterpret_cast<float*>(smem + L.a_ss);   // kSub x kMaxM: logits, then p
    float* ws = reinterpret_cast<float*>(smem + L.a_sc);  // staged 32 x 32 weight tile
    for (int t0 = 0; t0 < tl.nhp; t0 += kSub) {
      const int R = min(kSub, tl.nhp - t0);
      __syncthreads();  // the last sub-tile's LN has read qs
      for (int i = threadIdx.x; i < R * C; i += kThreadsF32) {
        const int r = i / C, c = i % C;
        int pix, o;
        xs[i] = halo_token(tl, t0 + r, H, W, pix, o) ? ln1x[(tok0 + pix) * C + c] : 0.f;
      }
      // q = x . Wq^T + bq
      for (int n0 = 0; n0 < C; n0 += 32)
        gemm32_f32(qs, C, n0, false, xs, C, R, wq, C, n0, 0, C, ws);
      __syncthreads();
      for (int i = threadIdx.x; i < R * C; i += kThreadsF32) qs[i] += bq[i % C];
      for (int h = 0; h < heads; ++h) {
        const int hc = h * kHeadDim;
        // logits q_h . k_h^T, scaled; keys past M are -inf
        for (int n0 = 0; n0 < M; n0 += 32)
          gemm32_strided_f32(s, kMaxM, n0, qs + hc, C, R, kvb + hc, two_c, 1, n0, M, kHeadDim,
                             kHeadDim, ws);
        __syncthreads();
        for (int i = threadIdx.x; i < R * kMaxM; i += kThreadsF32) {
          const int m = i % kMaxM;
          s[i] = m < M ? s[i] * scale : -INFINITY;
        }
        __syncthreads();
        softmax_rows_f32(s, R);
        // o_h = p . v_h into this head's columns of xs (p is 0 past M)
        for (int n0 = 0; n0 < kHeadDim; n0 += 32)
          gemm32_strided_f32(xs, C, hc + n0, s, kMaxM, R, kvb + C + hc, 1, two_c, n0,
                             kHeadDim, M, (M + 31) / 32 * 32, ws);
      }
      // a = o . Wp^T + bp; x2 = res + a
      for (int n0 = 0; n0 < C; n0 += 32)
        gemm32_f32(qs, C, n0, false, xs, C, R, wp, C, n0, 0, C, ws);
      __syncthreads();
      for (int i = threadIdx.x; i < R * C; i += kThreadsF32) {
        const int r = i / C, c = i % C;
        int pix, o;
        qs[i] = halo_token(tl, t0 + r, H, W, pix, o) ? res[(tok0 + pix) * C + c] + (qs[i] + bp[c])
                                                     : 0.f;
      }
      __syncthreads();
      for (int r = warp; r < R; r += kThreadsF32 / 32) {
        int pix, o;
        const int t = t0 + r;
        float* y = ys + (size_t)t * C;
        if (halo_token(tl, t, H, W, pix, o)) {
          layer_norm_row(y, qs + r * C, lns, lnb, C, eps);
          if (o >= 0)
            for (int c = threadIdx.x % 32; c < C; c += 32) x2s[o * C + c] = qs[r * C + c];
        } else {
          for (int c = threadIdx.x % 32; c < C; c += 32) y[c] = 0.f;
        }
      }
    }
  }
  __syncthreads();  // phase 1's room is free

  // 2. the MixFFN on y, into the f32 accumulators os
  float* hf = reinterpret_cast<float*>(smem + L.f_hf);
  float* gs = reinterpret_cast<float*>(smem + L.f_gs);
  float* os = reinterpret_cast<float*>(smem + L.f_os);
  float* ws = reinterpret_cast<float*>(smem + L.f_ws);
  for (int i = threadIdx.x; i < tl.nop * C; i += kThreadsF32) os[i] = 0.f;
  ffn_chunks_f32(os, ys, hf, gs, ws, b1s, dwbs, tb, tl, w1, b1, dwk, dwb, w2, C);

  // 3. out = x2 + (o + b2) for the tile's tokens
  for (int i = threadIdx.x; i < tl.no * C; i += kThreadsF32) {
    const int o = i / C, c = i % C;
    const int y = tl.y0 + o / tl.tw, x = tl.x0 + o % tl.tw;
    if (y < H && x < W) out[(tok0 + (size_t)y * W + x) * C + c] = x2s[i] + (os[i] + b2[c]);
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor-core 16x16x16 MMAs (WMMA), f32 accumulation, 16 warps
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreadsTC)
    block_bf16(const bf16* __restrict__ ln1x, const bf16* __restrict__ kv,
               const bf16* __restrict__ res, const bf16* __restrict__ wq,
               const bf16* __restrict__ bq, const bf16* __restrict__ wp,
               const bf16* __restrict__ bp, const bf16* __restrict__ lns,
               const bf16* __restrict__ lnb, const bf16* __restrict__ w1,
               const bf16* __restrict__ b1, const bf16* __restrict__ dwk,
               const bf16* __restrict__ dwb, const bf16* __restrict__ w2,
               const bf16* __restrict__ b2, bf16* __restrict__ out, int H, int W, int M,
               int C, int heads, int th, int tw, float scale, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Tile tl(H, W, th, tw);
  const Layout L(1, C, tl.nhp, tl.no, tl.nop);
  const int ldx = C + kPad;
  bf16* ys = reinterpret_cast<bf16*>(smem + L.ys);    // nhp x ldx: y
  bf16* x2s = reinterpret_cast<bf16*>(smem + L.x2s);  // no x ldx: x2 of the tile's tokens
  float* b1s = reinterpret_cast<float*>(smem + L.b1s);
  float* dwbs = reinterpret_cast<float*>(smem + L.dwbs);
  Tables tb{reinterpret_cast<float*>(smem + L.tables),
            reinterpret_cast<int*>(smem + L.tables + kMaxHalo * 4)};
  const int N = H * W, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int mp = (M + 15) / 16 * 16;  // keys padded to the MMA tile
  const size_t two_c = 2 * (size_t)C;
  const bf16* kvb = kv + (size_t)tl.b * M * two_c;
  const size_t tok0 = (size_t)tl.b * N;  // the image's first token
  const int vpr = C / 8;                 // 16-byte vectors per token row

  fill_tables(tb, tl, H, W);

  // 1. attention, x2 and LN2 for the halo tokens, kSub at a time
  {
    bf16* xs = reinterpret_cast<bf16*>(smem + L.a_xs);  // kSub x ldx: ln1x, then o
    bf16* qs = reinterpret_cast<bf16*>(smem + L.a_qs);  // kSub x ldx: q, then x2
    bf16* ks = reinterpret_cast<bf16*>(smem + L.a_ks);  // kMaxM x kHdLd: K_h
    bf16* vs = reinterpret_cast<bf16*>(smem + L.a_vs);  // kMaxM x kHdLd: V_h
    bf16* ps = reinterpret_cast<bf16*>(smem + L.a_ps);  // kSub x kPLd: p
    float* ss = reinterpret_cast<float*>(smem + L.a_ss);  // kSub x kSLd: logits
    float* sc = reinterpret_cast<float*>(smem + L.a_sc) + warp * 256;  // this warp's scratch
    for (int t0 = 0; t0 < tl.nhp; t0 += kSub) {
      __syncthreads();  // the last sub-tile's LN has read qs
      for (int i = threadIdx.x; i < kSub * vpr; i += kThreadsTC) {
        const int r = i / vpr, v = i % vpr;
        int pix, o;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (t0 + r < tl.nhp && halo_token(tl, t0 + r, H, W, pix, o))
          val = reinterpret_cast<const uint4*>(ln1x + (tok0 + pix) * C)[v];
        *reinterpret_cast<uint4*>(xs + r * ldx + v * 8) = val;
      }
      __syncthreads();

      // q = bf16(x . Wq^T + bq)
      for (int nt = warp; nt < C / 16; nt += kWarpsTC) {
        FragC acc[2];
        proj_tiles(acc, xs, ldx, wq, C, C, nt * 16);
        for (int i = 0; i < 2; ++i)
          for_each_acc(acc[i], sc, [&](int r, int c, float v) {
            const int col = nt * 16 + c;
            qs[(16 * i + r) * ldx + col] = __float2bfloat16(v + __bfloat162float(bq[col]));
          });
      }

      for (int h = 0; h < heads; ++h) {
        const int hc = h * kHeadDim;
        __syncthreads();  // q is complete; the last head's P.V has read vs
        // K_h, V_h; rows M..mp are zero so padded keys contribute nothing
        for (int i = threadIdx.x; i < mp * (kHeadDim / 8); i += kThreadsTC) {
          const int m = i / (kHeadDim / 8), v = i % (kHeadDim / 8);
          uint4 kval = make_uint4(0, 0, 0, 0), vval = make_uint4(0, 0, 0, 0);
          if (m < M) {
            kval = reinterpret_cast<const uint4*>(kvb + m * two_c + hc)[v];
            vval = reinterpret_cast<const uint4*>(kvb + m * two_c + C + hc)[v];
          }
          *reinterpret_cast<uint4*>(ks + m * kHdLd + v * 8) = kval;
          *reinterpret_cast<uint4*>(vs + m * kHdLd + v * 8) = vval;
        }
        __syncthreads();

        // f32 logits q_h . k_h^T (K_h read as a column-major B operand)
        for (int j = warp; j < 2 * (mp / 16); j += kWarpsTC) {
          const int i = j % 2, nt = j / 2;
          FragC acc;
          wmma::fill_fragment(acc, 0.f);
#pragma unroll
          for (int k = 0; k < kHeadDim; k += 16) {
            FragBCol bk;
            wmma::load_matrix_sync(bk, ks + nt * 16 * kHdLd + k, kHdLd);
            FragA a;
            wmma::load_matrix_sync(a, qs + 16 * i * ldx + hc + k, ldx);
            wmma::mma_sync(acc, a, bk, acc);
          }
          wmma::store_matrix_sync(ss + 16 * i * kSLd + nt * 16, acc, kSLd, wmma::mem_row_major);
        }
        __syncthreads();
        softmax_rows_bf16(ss, ps, kSub, M, mp, scale);
        __syncthreads();

        // o_h = bf16(p . v_h) into this head's columns of xs: 2 x 4 tiles
        if (warp < 8) {
          const int i = warp / 4, d0 = (warp % 4) * 16;
          FragC acc;
          wmma::fill_fragment(acc, 0.f);
          for (int k = 0; k < mp; k += 16) {
            FragBRow bv;
            wmma::load_matrix_sync(bv, vs + k * kHdLd + d0, kHdLd);
            FragA a;
            wmma::load_matrix_sync(a, ps + 16 * i * kPLd + k, kPLd);
            wmma::mma_sync(acc, a, bv, acc);
          }
          for_each_acc(acc, sc, [&](int r, int c, float v) {
            xs[(16 * i + r) * ldx + hc + d0 + c] = __float2bfloat16(v);
          });
        }
      }
      __syncthreads();  // o is complete; q is no longer read

      // a = bf16(o . Wp^T + bp); x2 = bf16(res + a) into qs
      for (int nt = warp; nt < C / 16; nt += kWarpsTC) {
        FragC acc[2];
        proj_tiles(acc, xs, ldx, wp, C, C, nt * 16);
        for (int i = 0; i < 2; ++i)
          for_each_acc(acc[i], sc, [&](int r, int c, float v) {
            const int row = 16 * i + r, col = nt * 16 + c;
            int pix, o;
            float x2 = 0.f;
            if (t0 + row < tl.nhp && halo_token(tl, t0 + row, H, W, pix, o))
              x2 = __bfloat162float(res[(tok0 + pix) * C + col]) +
                   rnd(v + __bfloat162float(bp[col]));
            qs[row * ldx + col] = __float2bfloat16(x2);
          });
      }
      __syncthreads();

      // y = LN2(x2), one warp per token; keep x2 of the tile's own tokens
      for (int r = warp; r < kSub && t0 + r < tl.nhp; r += kWarpsTC) {
        int pix, o;
        const int t = t0 + r;
        bf16* y = ys + (size_t)t * ldx;
        if (halo_token(tl, t, H, W, pix, o)) {
          layer_norm_row(y, qs + r * ldx, lns, lnb, C, eps);
          if (o >= 0)
            for (int c = lane; c < C; c += 32) x2s[o * ldx + c] = qs[r * ldx + c];
        } else {
          for (int c = lane; c < C; c += 32) y[c] = __float2bfloat16(0.f);
        }
      }
    }
  }
  __syncthreads();  // phase 1's room is free

  // 2. the MixFFN on y; W1's first chunk goes in flight first
  bf16* w1s = reinterpret_cast<bf16*>(smem + L.f_w);
  bf16* w2s = reinterpret_cast<bf16*>(smem + L.f_w + align128((size_t)kHC * ldx * 2));
  float* hf = reinterpret_cast<float*>(smem + L.f_hf);
  bf16* gs = reinterpret_cast<bf16*>(smem + L.f_gs);
  stage_w1(w1s, w1, 0, C);
  __pipeline_commit();
  const int oct = C / 16, n_out = (tl.nop / 16) * oct;
  FragC acc[kMaxOutFrags];
#pragma unroll
  for (int f = 0; f < kMaxOutFrags; ++f) wmma::fill_fragment(acc[f], 0.f);
  ffn_chunks_bf16(acc, ys, w1s, w2s, hf, gs, b1s, dwbs, tb, tl, w1, b1, dwk, dwb, w2, C, 0,
                  4 * C);

  // 3. out = bf16(x2 + bf16(o + b2)) for the tile's tokens
  float* sc = reinterpret_cast<float*>(smem + L.f_w) + warp * 256;
#pragma unroll
  for (int f = 0; f < kMaxOutFrags; ++f) {
    const int i = warp + kWarpsTC * f;
    if (i < n_out) {
      const int rt = i / oct, ct = i % oct;
      for_each_acc(acc[f], sc, [&](int r, int cc, float v) {
        const int o = rt * 16 + r, c = ct * 16 + cc;
        if (o >= tl.no) return;
        const int y = tl.y0 + o / tl.tw, x = tl.x0 + o % tl.tw;
        if (y < H && x < W)
          out[(tok0 + (size_t)y * W + x) * C + c] = __float2bfloat16(
              __bfloat162float(x2s[o * ldx + c]) + rnd(v + __bfloat162float(b2[c])));
      });
    }
  }
}

template <typename T, typename Kernel>
int launch(Kernel kernel, int dtype, int threads, const void* ln1x, const void* kv_in,
           const void* res, const void* wq, const void* bq, const void* wkv, const void* bkv,
           const void* wp, const void* bp, const void* lns, const void* lnb, const void* w1,
           const void* b1, const void* dwk, const void* dwb, const void* w2, const void* b2,
           void* kv_scratch, void* out, int B, int H, int W, int M, int C, int heads, int th,
           int tw, float scale, float eps, cudaStream_t stream) {
  const int no = th * tw;
  const size_t smem = Layout(dtype, C, ceil16((th + 2) * (tw + 2)), no, ceil16(no)).bytes();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int kv_err = launch_kv_proj<T>(kv_in, wkv, bkv, kv_scratch, B * M, C, stream);
  if (kv_err != 0) return kv_err;
  const dim3 grid(((H + th - 1) / th) * ((W + tw - 1) / tw), B);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(ln1x), static_cast<const T*>(kv_scratch),
      static_cast<const T*>(res), static_cast<const T*>(wq), static_cast<const T*>(bq),
      static_cast<const T*>(wp), static_cast<const T*>(bp), static_cast<const T*>(lns),
      static_cast<const T*>(lnb), static_cast<const T*>(w1), static_cast<const T*>(b1),
      static_cast<const T*>(dwk), static_cast<const T*>(dwb), static_cast<const T*>(w2),
      static_cast<const T*>(b2), static_cast<T*>(out), H, W, M, C, heads, th, tw, scale, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory of one block for a (th, tw) tile; kernels/fused_block.py:
// smem_bytes mirrors it (its tests hold the two equal on the card).
int pf_fused_block_smem(int dtype, int C, int th, int tw) {
  const int no = th * tw;
  return (int)Layout(dtype, C, ceil16((th + 2) * (tw + 2)), no, ceil16(no)).bytes();
}

// dtype: 0 = float32, 1 = bfloat16. Every pointer is a contiguous device
// buffer: ln1x, res and out (B, H*W, C); kv_in (B, M, C); wq, wp (C, C),
// wkv (2C, C), w1 (4C, C), w2 (C, 4C) as nn.Linear (out, in); dwk
// (4C, 1, 3, 3); biases and the LN2 affine 1-D; kv_scratch holds B * M * 2C
// elements. Requires C = heads * 64, 1 <= M <= 128 and a tile (th, tw) from
// kernels/fused_block.py:choose_tile ((th+2)(tw+2) <= 128 halo tokens, the
// bf16 accumulators, shared memory). Returns cudaGetLastError() after the
// launches (0 on success).
int pf_fused_block(int dtype, const void* ln1x, const void* kv_in, const void* res,
                   const void* wq, const void* bq, const void* wkv, const void* bkv,
                   const void* wp, const void* bp, const void* lns, const void* lnb,
                   const void* w1, const void* b1, const void* dwk, const void* dwb,
                   const void* w2, const void* b2, void* kv_scratch, void* out, int B, int H,
                   int W, int M, int C, int heads, int th, int tw, float scale, float eps,
                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (heads < 1 || C != heads * kHeadDim || M < 1 || M > kMaxM || th < 1 || tw < 1 ||
      ceil16((th + 2) * (tw + 2)) > kMaxHalo)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(block_f32, 0, kThreadsF32, ln1x, kv_in, res, wq, bq, wkv, bkv, wp, bp,
                         lns, lnb, w1, b1, dwk, dwb, w2, b2, kv_scratch, out, B, H, W, M, C,
                         heads, th, tw, scale, eps, st);
  if (dtype != 1 || (ceil16(th * tw) / 16) * (C / 16) > kWarpsTC * kMaxOutFrags)
    return (int)cudaErrorInvalidValue;
  return launch<bf16>(block_bf16, 1, kThreadsTC, ln1x, kv_in, res, wq, bq, wkv, bkv, wp, bp,
                      lns, lnb, w1, b1, dwk, dwb, w2, b2, kv_scratch, out, B, H, W, M, C, heads,
                      th, tw, scale, eps, st);
}

const char* pf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

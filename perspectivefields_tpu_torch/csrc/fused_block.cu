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
//   y   = T(LN2(x2))                   f32 moments: nn.LayerNorm's Welford order at
//                                      f32, two passes at bf16
//   o   = MixFFN(y)                    mixffn.cu's function and casts
//   out = T(x2 + o)                    second skip
//
// T is the compute dtype. Weights keep the torch layouts: nn.Linear (out, in),
// the depthwise kernel (4C, 1, 3, 3). Rounding points at bf16: q, p, o_h,
// a (before the skip), x2, y, the hidden map after fc1 + b1, g after GELU,
// fc2 + b2 (before the skip), out.
//
// What bounds it on the H100: at the flagship's B=8 shapes, operations
// (~0.15 ms per forward of tensor-core work, kernels/roofline.py). Unfused,
// the block moves every intermediate through HBM. A first launch projects
// K/V into a (B, M, 2C) scratch tensor (attention_common.cuh). Then one
// block owns a TH x TW tile of one image plus the 1-pixel halo the 3x3 conv
// needs, and keeps the attention output, x2, y and the 4C hidden map on
// chip. The WMMA version of this kernel was 41-47x above the bound: every
// block streamed all of the block's weights from L2 for 8-25 outputs (0.3 /
// 0.63 GB of L2 reads a call at stages 3 / 4), read Wq and Wp as fragments
// straight from global memory once per 32-row sub-tile, restaged K_h and V_h
// per sub-tile and head, and its 16x16 MMAs were bound by shared memory.
//
// bfloat16, this design (hopper_gemm.cuh): the halo is at most 64 tokens
// (wgmma's M), so a block is one sub-tile. Two consumer warpgroups split
// the columns of every product; a producer warpgroup streams Wq, Wp, W1 and W2
// as 16 KB tiles by TMA through a ring. The blocks of a thread-block
// cluster (k neighbouring tiles) share that ring: each loads 1/k of every
// tile's rows and multicasts it to all k, so L2 serves each weight tile
// once per cluster, not once per block. The phases:
//   1. ln1x's halo rows into shared memory (wgmma's swizzled A operand);
//      q = T(x . Wq^T + bq) (m64n32 per warpgroup per 64 columns);
//   2. per head, K_h and V_h^T staged once; logits on wgmma (each warpgroup
//      64 of the 128 padded keys), the softmax in registers with the row max
//      and sum exchanged through shared memory, p = T(.) into shared memory;
//      o_h = T(p . V_h) (each warpgroup 32 of the 64 head columns);
//   3. a = T(o . Wp^T + bp), x2 = T(res + a); y = T(LN2(x2)) per row, its
//      moments in f32 in two passes (the f32 kernel keeps nn.LayerNorm's
//      Welford order);
//   4. the MixFFN in 64-channel hidden chunks: fc1 (each warpgroup 32
//      channels), + b1, zero off the image, T(.) into a plain tile; the 3x3
//      taps and GELU into g (the swizzled A operand); fc2 into f32
//      accumulators that stay in registers across all chunks (each
//      warpgroup 64 of every 128 output columns);
//   5. out = T(x2 + T(o + b2)) for the tile's tokens.
// The cluster's blocks all walk the same weight tiles, so a grid the
// cluster does not divide is padded with blocks that take part in every
// load and barrier and write nothing. The producer warpgroup gives its
// registers to the consumers (setmaxnreg: 232 each); every MMA of a ring
// stage is unconditional (xs padded to whole 128-column tiles, the W2
// tiles a template parameter), since a conditional MMA made ptxas
// serialise them all; a warpgroup releases a stage with one remote arrive
// per block. kernels/fused_block.py: plan picks the tile, the cluster size
// and the ring depth.
//
// What bounds it now (PERF.md; clock64 counts of one block): every
// block runs all 10 C^2 weight MACs for 64 rows, of which 25-35 are
// outputs and the rest halo; the FFN walk takes ~55% of a block (fc1,
// the 3x3 taps with GELU on the CUDA cores while the tensor cores wait,
// fc2 in short 16 KB stages), attention ~18%. At stage 4 the 32 blocks
// leave 100 SMs idle. Next: split the hidden chunks over a cluster (as
// B4 does) and overlap the taps with fc2.
//
// float32 runs scalar FMAs summed in cuBLAS's order (one FMA chain over k),
// as the attention and MixFFN kernels do, on the WMMA version's tiling
// (halo up to 128 tokens in 32-token sub-tiles).

#include "attention_common.cuh"
#include "hopper_gemm.cuh"
#include "mixffn_common.cuh"

namespace {

constexpr int kSub = 32;  // halo tokens per attention sub-tile (float32)

// Layout of one float32 block's shared memory (kernels/fused_block.py:
// smem_bytes mirrors it): the persistent room (y, x2, FFN biases, index
// tables), then one room that phase 1 (attention) and phase 2 (FFN) reuse.
struct Layout {
  size_t ys, x2s, b1s, dwbs, tables, room;  // byte offsets
  size_t a_xs, a_qs, a_ks, a_vs, a_ps, a_ss, a_sc, a_end;  // phase 1, from room
  size_t f_w, f_hf, f_gs, f_os, f_ws, f_end;               // phase 2, from room
  __host__ __device__ Layout(int dtype, int C, int nhp, int no, int nop) {
    const size_t ld = C;  // row of a C-wide tile (dtype 0 only)
    ys = 0;
    x2s = ys + align128(nhp * ld * 4);
    b1s = x2s + align128(no * ld * 4);
    dwbs = b1s + align128(kHC * 4);
    tables = dwbs + align128(kHC * 4);
    room = tables + 2 * kMaxHalo * 4;
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
// bfloat16: wgmma, a TMA weight ring shared by the blocks of a cluster
// ---------------------------------------------------------------------------

constexpr int kRows = 64;           // halo tokens a block holds: wgmma's M
constexpr int kKeys = 128;          // keys padded (M <= 128)
constexpr int kHfLdB = kHC + 8;     // row of the bf16 hidden chunk
constexpr int kMaxStagesB = 6;
constexpr int kMaxCB = 640;         // widest C: JAX's gate admits no wider block

// One bf16 block's shared memory, in bytes from its 1024-aligned base
// (kernels/fused_block.py: smem_bytes mirrors it): the ring; xs (ln1x, then
// o, then y; zero-padded to whole 128-column tiles) and qs (q, then x2 as
// plain rows), 64 x C each; one room for K_h (then p, once the logits have
// read K_h) and V_h^T, which the FFN then takes for the hidden chunk and g;
// the softmax's row exchange; the index tables; the ring's barriers.
struct BlockLayout {
  size_t ring, xs, qs, kv, xch, tables, bars, end;
  __host__ __device__ BlockLayout(int C, int stages) {
    ring = 0;
    xs = ring + (size_t)stages * kStageBytes;
    qs = xs + (size_t)kRows * round_up(C, 128) * 2;
    kv = qs + (size_t)kRows * C * 2;
    xch = kv + 2 * (size_t)kKeys * kHeadDim * 2;
    tables = xch + 4 * kRows * 4;
    bars = tables + 2 * kRows * 4;
    end = bars + 2 * (size_t)stages * 8;
  }
  __host__ __device__ size_t bytes() const { return end + 1024; }  // + aligning the base
};

// y = T(LN2(x2)) for one row (C <= kMaxCB) into a swizzled A operand, by one
// warp: f32 moments in two passes over the row held in registers (the
// mean, then the mean squared deviation).
__device__ __forceinline__ void layer_norm_row_bf16(bf16* ys, int row, const bf16* x2,
                                                    const bf16* __restrict__ lns,
                                                    const bf16* __restrict__ lnb, int C,
                                                    float eps) {
  const int lane = threadIdx.x % 32;
  float v[kMaxCB / 32];
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxCB / 32; ++j) {
    const int c = lane + 32 * j;
    v[j] = c < C ? __bfloat162float(x2[c]) : 0.f;
    sum += v[j];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  const float mean = sum / (float)C;
  float sq = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxCB / 32; ++j) {
    const float d = lane + 32 * j < C ? v[j] - mean : 0.f;
    sq = fmaf(d, d, sq);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
  const float rstd = rsqrtf(sq / (float)C + eps);
#pragma unroll
  for (int j = 0; j < kMaxCB / 32; ++j) {
    const int c = lane + 32 * j;
    if (c < C)
      ys[swz_at(kRows, row, c)] =
          __float2bfloat16(to_f(lns[c]) * (rstd * (v[j] - mean)) + to_f(lnb[c]));
  }
}

// acc (m64n32 per warpgroup) = A (64 x Kp, swizzled, from shared memory) .
// W[n0 + 32 wg + (0..31), 0:Kp]^T, W's tiles arriving through the ring as
// 64 rows x 128 columns (Kp a multiple of 128; A's padding and W's columns
// past its edge are zero).
__device__ __forceinline__ void ring_gemm_n32(float (&d)[16], const bf16* a, int Kp, Ring& ring,
                                              int cluster) {
  const int wg = threadIdx.x / 128;
  for (int k0 = 0; k0 < Kp; k0 += 128) {
    const bf16* w = ring.wait();
    wg_fence();
    fence_regs(d);
#pragma unroll
    for (int k = 0; k < 128; k += 16)
      mma_n32_ss(d, desc_at(a, kRows, 0, k0 + k), desc_at(w, 64, 32 * wg, k), k0 + k > 0);
    wg_commit();
    ring.retire(cluster);
  }
  ring.drain(cluster);
  fence_regs(d);
}

// NT: 128-row W2 tiles (C <= 128 NT, so NT = ceil(C / 128)), so that every
// MMA is unconditional (ptxas then keeps them pipelined).
template <int NT>
__global__ void __launch_bounds__(kHopperThreads, 1)
    block_bf16(const __grid_constant__ CUtensorMap wqmap, const __grid_constant__ CUtensorMap wpmap,
               const __grid_constant__ CUtensorMap w1map, const __grid_constant__ CUtensorMap w2map,
               const bf16* __restrict__ ln1x, const bf16* __restrict__ kv,
               const bf16* __restrict__ res, const bf16* __restrict__ bq,
               const bf16* __restrict__ bp, const bf16* __restrict__ lns,
               const bf16* __restrict__ lnb, const bf16* __restrict__ b1,
               const bf16* __restrict__ dwk, const bf16* __restrict__ dwb,
               const bf16* __restrict__ b2, bf16* __restrict__ out, int B, int H, int W, int M,
               int C, int heads, int th, int tw, int stages, float scale, float eps) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* base = smem_raw + (1024 - smem_u32(smem_raw) % 1024) % 1024;
  const BlockLayout L(C, stages);
  Ring ring(base + L.ring, reinterpret_cast<uint64_t*>(base + L.bars), stages);
  bf16* xs = reinterpret_cast<bf16*>(base + L.xs);   // ln1x, then o, then y (swizzled)
  bf16* qs = reinterpret_cast<bf16*>(base + L.qs);   // q (swizzled), then x2 (rows of C)
  bf16* ks = reinterpret_cast<bf16*>(base + L.kv);   // K_h: 128 keys x 64 (swizzled)
  bf16* vt = ks + kKeys * kHeadDim;                  // V_h^T: 64 x 128 keys (swizzled)
  bf16* hf = reinterpret_cast<bf16*>(base + L.kv);   // FFN: the hidden chunk, 64 x kHfLdB
  bf16* gs = hf + kRows * kHfLdB;                    // FFN: g, 64 x 64 (swizzled)
  bf16* ps = ks;                                     // p: 64 x 128 keys (swizzled)
  float* xmax = reinterpret_cast<float*>(base + L.xch);  // [2][64] row max per warpgroup
  float* xsum = xmax + 2 * kRows;                        // [2][64] row sums
  float* valid = reinterpret_cast<float*>(base + L.tables);
  int* obase = reinterpret_cast<int*>(base + L.tables + kRows * 4);
  const int cluster = (int)cg::this_cluster().num_blocks();
  const int rank = (int)cg::this_cluster().block_rank();

  // the tile: blocks past the last tile (the grid padded to the cluster)
  // redo the last one and write nothing
  const int tiles_w = (W + tw - 1) / tw, per_image = ((H + th - 1) / th) * tiles_w;
  const bool real = (int)blockIdx.x < B * per_image;
  const int bi = real ? (int)blockIdx.x : B * per_image - 1;
  const int b = bi / per_image, ti = bi % per_image;
  const int y0 = (ti / tiles_w) * th, x0 = (ti % tiles_w) * tw, hw = tw + 2;
  const int nhalo = (th + 2) * hw, no = th * tw, N = H * W;
  const size_t tok0 = (size_t)b * N;
  const bf16* kvb = kv + (size_t)b * M * 2 * C;
  const int Cp = round_up(C, 128);

  ring.init(cluster);
  for (int t = threadIdx.x; t < kRows; t += blockDim.x) {
    const int yy = y0 - 1 + t / hw, xx = x0 - 1 + t % hw;
    valid[t] = t < nhalo && yy >= 0 && yy < H && xx >= 0 && xx < W ? 1.f : 0.f;
    obase[t] = (t / tw) * hw + t % tw;  // output t's top-left tap (t < no)
  }
  for (int i = threadIdx.x; i < kRows * (Cp - C); i += blockDim.x)  // xs's zero padding
    xs[swz_at(kRows, i / (Cp - C), C + i % (Cp - C))] = __float2bfloat16(0.f);
  __syncthreads();
  cluster_sync();  // every block's barriers are initialised before any multicast

  if (threadIdx.x >= kConsumerThreads) {  // the producer warpgroup: weight tiles by TMA
    producer_registers();
    if (threadIdx.x == kConsumerThreads) {
      prefetch_map(&wqmap);
      prefetch_map(&wpmap);
      prefetch_map(&w1map);
      prefetch_map(&w2map);
    }
    for (int which = 0; which < 2; ++which)
      for (int n0 = 0; n0 < C; n0 += 64)
        for (int k0 = 0; k0 < Cp; k0 += 128)
          ring.produce({which == 0 ? &wqmap : &wpmap, n0, k0, 64, 128}, cluster, rank);
    for (int h0 = 0; h0 < 4 * C; h0 += kHC) {
      for (int k0 = 0; k0 < Cp; k0 += 128) ring.produce({&w1map, h0, k0, 64, 128}, cluster, rank);
      for (int n0 = 0; n0 < C; n0 += 128) ring.produce({&w2map, n0, h0, 128, 64}, cluster, rank);
    }
    __syncwarp();
    cluster_sync();  // no block leaves while others may still write into it
    return;
  }

  consumer_registers();
  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  auto pixel = [&](int t) { return (y0 - 1 + t / hw) * W + (x0 - 1 + t % hw); };

  // 1. ln1x's halo rows (zero off the image), then q = T(x . Wq^T + bq)
  for (int i = threadIdx.x; i < kRows * (C / 8); i += kConsumerThreads) {
    const int t = i / (C / 8), v = i % (C / 8);
    uint4 val = make_uint4(0, 0, 0, 0);
    if (valid[t] != 0.f) val = reinterpret_cast<const uint4*>(ln1x + (tok0 + pixel(t)) * C)[v];
    *reinterpret_cast<uint4*>(xs + swz_at(kRows, t, v * 8)) = val;  // 8 values share a chunk
  }
  fence_async_smem();
  consumers_sync();
  for (int n0 = 0; n0 < C; n0 += 64) {
    float d[16];
    ring_gemm_n32(d, xs, Cp, ring, cluster);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int col = n0 + 32 * wg + acc_col(i);
      qs[swz_at(kRows, acc_row(i), col)] = __float2bfloat16(d[i] + __bfloat162float(bq[col]));
    }
  }

  // 2. attention, head by head; o_h into xs (ln1x is no longer read)
  for (int h = 0; h < heads; ++h) {
    const int hc = h * kHeadDim;
    consumers_sync();  // q is complete; the last head's P.V has read p (in ks) and vt
    for (int i = threadIdx.x; i < kKeys * (kHeadDim / 8); i += kConsumerThreads) {
      const int m = i / (kHeadDim / 8), v = i % (kHeadDim / 8);
      uint4 kval = make_uint4(0, 0, 0, 0), vval = make_uint4(0, 0, 0, 0);
      if (m < M) {
        kval = reinterpret_cast<const uint4*>(kvb + (size_t)m * 2 * C + hc)[v];
        vval = reinterpret_cast<const uint4*>(kvb + (size_t)m * 2 * C + C + hc)[v];
      }
      *reinterpret_cast<uint4*>(ks + swz_at(kKeys, m, v * 8)) = kval;
      const bf16* ve = reinterpret_cast<const bf16*>(&vval);
#pragma unroll
      for (int e = 0; e < 8; ++e) vt[swz_at(kHeadDim, v * 8 + e, m)] = ve[e];
    }
    fence_async_smem();
    consumers_sync();

    // logits of this warpgroup's 64 keys: q_h . K_h[64 wg ..]^T
    float s[32];
    wg_fence();
    fence_regs(s);
#pragma unroll
    for (int k = 0; k < kHeadDim; k += 16)
      mma_n64_ss(s, desc_at(qs, kRows, 0, hc + k), desc_at(ks, kKeys, 64 * wg, k), k > 0);
    wg_commit();
    wg_wait0();
    fence_regs(s);
    // p = T(softmax(s * scale)) over all M keys: row max and sum over the
    // thread's quad, then across the two warpgroups through shared memory;
    // p overwrites K_h, which both warpgroups' logits have read by the
    // first exchange
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int key = 64 * wg + acc_col(i);
      s[i] = key < M ? s[i] * scale : -INFINITY;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    const int row0 = acc_row(0), row1 = acc_row(2);
    if (lane % 4 == 0) {
      xmax[wg * kRows + row0] = mx[0];
      xmax[wg * kRows + row1] = mx[1];
    }
    consumers_sync();
    mx[0] = fmaxf(xmax[row0], xmax[kRows + row0]);
    mx[1] = fmaxf(xmax[row1], xmax[kRows + row1]);
    float sm[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = expf(s[i] - mx[(i >> 1) & 1]);  // masked keys: exp(-inf) = 0
      sm[(i >> 1) & 1] += s[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sm[r] += __shfl_xor_sync(0xffffffffu, sm[r], 1);
      sm[r] += __shfl_xor_sync(0xffffffffu, sm[r], 2);
    }
    if (lane % 4 == 0) {
      xsum[wg * kRows + row0] = sm[0];
      xsum[wg * kRows + row1] = sm[1];
    }
    consumers_sync();
    sm[0] = xsum[row0] + xsum[kRows + row0];
    sm[1] = xsum[row1] + xsum[kRows + row1];
#pragma unroll
    for (int i = 0; i < 32; ++i)
      ps[swz_at(kRows, acc_row(i), 64 * wg + acc_col(i))] = __float2bfloat16(s[i] / sm[(i >> 1) & 1]);
    fence_async_smem();
    consumers_sync();

    // o_h[:, 32 wg ..] = T(p . V_h[:, 32 wg ..])
    float o[16];
    wg_fence();
    fence_regs(o);
#pragma unroll
    for (int k = 0; k < kKeys; k += 16)
      mma_n32_ss(o, desc_at(ps, kRows, 0, k), desc_at(vt, kHeadDim, 32 * wg, k), k > 0);
    wg_commit();
    wg_wait0();
    fence_regs(o);
#pragma unroll
    for (int i = 0; i < 16; ++i)
      xs[swz_at(kRows, acc_row(i), hc + 32 * wg + acc_col(i))] = __float2bfloat16(o[i]);
  }
  fence_async_smem();
  consumers_sync();  // o is complete; q is no longer read

  // 3. a = T(o . Wp^T + bp); x2 = T(res + a) into qs as plain rows
  for (int n0 = 0; n0 < C; n0 += 64) {
    float d[16];
    ring_gemm_n32(d, xs, Cp, ring, cluster);
#pragma unroll
    for (int i = 0; i < 16; i += 2) {  // columns col, col + 1
      const int t = acc_row(i), col = n0 + 32 * wg + acc_col(i);
      float2 x2 = make_float2(0.f, 0.f);
      if (valid[t] != 0.f) {
        const float2 r = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(res + (tok0 + pixel(t)) * C + col));
        const float2 bias = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bp + col));
        x2 = make_float2(r.x + rnd(d[i] + bias.x), r.y + rnd(d[i + 1] + bias.y));
      }
      *reinterpret_cast<__nv_bfloat162*>(qs + t * C + col) = __floats2bfloat162_rn(x2.x, x2.y);
    }
  }
  consumers_sync();  // x2 is complete; o is no longer read
  for (int t = warp; t < kRows; t += kConsumerThreads / 32) {
    if (valid[t] != 0.f) {
      layer_norm_row_bf16(xs, t, qs + t * C, lns, lnb, C, eps);
    } else {
      for (int c = lane; c < C; c += 32) xs[swz_at(kRows, t, c)] = __float2bfloat16(0.f);
    }
  }
  fence_async_smem();
  consumers_sync();

  // 4. the MixFFN on y, 64 hidden channels at a time
  float acc[NT][32];
  // each chunk's b1 (this thread's fc1 columns), 3x3 taps and conv bias (its
  // conv channel jc), loaded a chunk ahead so their latency hides behind fc2
  const int jc = threadIdx.x % kHC;
  float b1v[16], taps[9], dbias;
  auto load_chunk = [&](int h) {
#pragma unroll
    for (int i = 0; i < 16; ++i) b1v[i] = __bfloat162float(b1[h + 32 * wg + acc_col(i)]);
#pragma unroll
    for (int k = 0; k < 9; ++k) taps[k] = __bfloat162float(dwk[(size_t)(h + jc) * 9 + k]);
    dbias = __bfloat162float(dwb[h + jc]);
  };
  load_chunk(0);
  for (int h0 = 0; h0 < 4 * C; h0 += kHC) {
    {  // fc1 for this warpgroup's 32 channels; + b1, zero off the image, T(.)
      float d[16];
      ring_gemm_n32(d, xs, Cp, ring, cluster);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int t = acc_row(i), j = 32 * wg + acc_col(i);
        hf[t * kHfLdB + j] = __float2bfloat16(valid[t] != 0.f ? d[i] + b1v[i] : 0.f);
      }
    }
    consumers_sync();
    {  // g = T(gelu(dw3x3(hidden) + dwb)) for the tile's outputs; g's rows
       // past no feed only output rows that are never stored
      const int j = jc;
      const float bias = dbias;
#pragma unroll 4
      for (int o = threadIdx.x / kHC; o < no; o += kConsumerThreads / kHC) {
        const bf16* hp = hf + obase[o] * kHfLdB + j;
        float a = 0.f;
#pragma unroll
        for (int dp = 0; dp < 3; ++dp)
#pragma unroll
          for (int dq = 0; dq < 3; ++dq)
            a = fmaf(__bfloat162float(hp[(dp * hw + dq) * kHfLdB]), taps[dp * 3 + dq], a);
        gs[swz_at(kRows, o, j)] = __float2bfloat16(gelu<bf16>(a + bias));
      }
      if (h0 + kHC < 4 * C) load_chunk(h0 + kHC);
    }
    fence_async_smem();
    consumers_sync();
    // fc2: acc[jt] += g . W2[128 jt + 64 wg + (0..63), h0 : h0 + 64]^T
#pragma unroll
    for (int jt = 0; jt < NT; ++jt) {
      const bf16* w = ring.wait();
      wg_fence();
      fence_regs(acc[jt]);
#pragma unroll
      for (int k = 0; k < kHC; k += 16)
        mma_n64_ss(acc[jt], desc_at(gs, kRows, 0, k), desc_at(w, 128, 64 * wg, k), h0 + k > 0);
      wg_commit();
      ring.retire(cluster);
    }
    ring.drain(cluster);  // the next chunk's conv rewrites g
  }
#pragma unroll
  for (int jt = 0; jt < NT; ++jt) fence_regs(acc[jt]);

  // 5. out = T(x2 + T(o + b2)) for the tile's tokens
  if (real) {
#pragma unroll
    for (int jt = 0; jt < NT; ++jt) {
#pragma unroll
      for (int i = 0; i < 32; i += 2) {  // columns c, c + 1
        const int o = acc_row(i), c = 128 * jt + 64 * wg + acc_col(i);
        if (o >= no || c >= C) continue;
        const int yy = y0 + o / tw, xx = x0 + o % tw;
        if (yy < H && xx < W) {
          const int t = (o / tw + 1) * hw + o % tw + 1;
          const float2 x2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(qs + t * C + c));
          const float2 bias = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b2 + c));
          *reinterpret_cast<__nv_bfloat162*>(out + (tok0 + (size_t)yy * W + xx) * C + c) =
              __floats2bfloat162_rn(x2.x + rnd(acc[jt][i] + bias.x),
                                    x2.y + rnd(acc[jt][i + 1] + bias.y));
        }
      }
    }
  }
  cluster_sync();  // no block leaves while others may still write into it
}

// The kernel for C = heads * 64 up to kMaxCB (NT = 1 to 5 W2 tiles);
// nullptr for any other C.
inline decltype(&block_bf16<1>) bf16_kernel(int C) {
  if (C < kHeadDim || C % kHeadDim != 0 || C > kMaxCB) return nullptr;
  switch ((C + 127) / 128) {
    case 1: return block_bf16<1>;
    case 2: return block_bf16<2>;
    case 3: return block_bf16<3>;
    case 4: return block_bf16<4>;
    default: return block_bf16<5>;
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

int launch_bf16(const void* ln1x, const void* kv_in, const void* res, const void* wq,
                const void* bq, const void* wkv, const void* bkv, const void* wp, const void* bp,
                const void* lns, const void* lnb, const void* w1, const void* b1,
                const void* dwk, const void* dwb, const void* w2, const void* b2,
                void* kv_scratch, void* out, int B, int H, int W, int M, int C, int heads,
                int th, int tw, int cluster, int stages, float scale, float eps,
                cudaStream_t stream) {
  const int rows = 64 / cluster;  // each block's share of a tile's rows
  CUtensorMap mq, mp, m1, m2;
  int err = make_map(&mq, wq, C, C, rows);
  if (err == 0) err = make_map(&mp, wp, C, C, rows);
  if (err == 0) err = make_map(&m1, w1, 4 * C, C, rows);
  if (err == 0) err = make_map(&m2, w2, C, 4 * C, 2 * rows);
  if (err != 0) return err;
  err = launch_kv_proj<bf16>(kv_in, wkv, bkv, kv_scratch, B * M, C, stream);
  if (err != 0) return err;
  const int tiles = B * ((H + th - 1) / th) * ((W + tw - 1) / tw);
  const int grid = (tiles + cluster - 1) / cluster * cluster;
  return launch_cluster(bf16_kernel(C), dim3(grid), kHopperThreads, BlockLayout(C, stages).bytes(),
                        cluster, stream, false, mq, mp, m1, m2, static_cast<const bf16*>(ln1x),
                        static_cast<const bf16*>(kv_scratch), static_cast<const bf16*>(res),
                        static_cast<const bf16*>(bq), static_cast<const bf16*>(bp),
                        static_cast<const bf16*>(lns), static_cast<const bf16*>(lnb),
                        static_cast<const bf16*>(b1), static_cast<const bf16*>(dwk),
                        static_cast<const bf16*>(dwb), static_cast<const bf16*>(b2),
                        static_cast<bf16*>(out), B, H, W, M, C, heads, th, tw, stages, scale, eps);
}

}  // namespace

extern "C" {

// Shared memory of one block: float32 for a (th, tw) tile, bfloat16 for a
// ring of ``stages`` stages (any tile); kernels/fused_block.py: smem_bytes
// mirrors both (its GPU tests hold them equal).
int pf_fused_block_smem(int dtype, int C, int th, int tw, int stages) {
  if (dtype == 1) return (int)BlockLayout(C, stages).bytes();
  const int no = th * tw;
  return (int)Layout(dtype, C, ceil16((th + 2) * (tw + 2)), no, ceil16(no)).bytes();
}

// How many clusters of ``cluster`` bf16 blocks with a ring of ``stages``
// stages the card runs at once (kernels/fused_block.py: plan).
int pf_fused_block_max_clusters(int C, int stages, int cluster) {
  if (bf16_kernel(C) == nullptr) return 0;
  return max_clusters(bf16_kernel(C), kHopperThreads, BlockLayout(C, stages).bytes(), cluster);
}

// dtype: 0 = float32, 1 = bfloat16. Every pointer is a contiguous device
// buffer: ln1x, res and out (B, H*W, C); kv_in (B, M, C); wq, wp (C, C),
// wkv (2C, C), w1 (4C, C), w2 (C, 4C) as nn.Linear (out, in); dwk
// (4C, 1, 3, 3); biases and the LN2 affine 1-D; kv_scratch holds B * M * 2C
// elements. Requires C = heads * 64, 1 <= M <= 128 and a tile (th, tw) from
// kernels/fused_block.py (float32: choose_tile, (th+2)(tw+2) <= 128 halo
// tokens and shared memory; bfloat16: plan, (th+2)(tw+2) <= 64, C <= 640,
// ``cluster`` of 1, 2, 4 or 8 blocks sharing the weight ring of ``stages``
// stages, 2 to 6). Returns cudaGetLastError() after the launches (0 on
// success); a launch the card refuses is an error.
int pf_fused_block(int dtype, const void* ln1x, const void* kv_in, const void* res,
                   const void* wq, const void* bq, const void* wkv, const void* bkv,
                   const void* wp, const void* bp, const void* lns, const void* lnb,
                   const void* w1, const void* b1, const void* dwk, const void* dwb,
                   const void* w2, const void* b2, void* kv_scratch, void* out, int B, int H,
                   int W, int M, int C, int heads, int th, int tw, int cluster, int stages,
                   float scale, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (heads < 1 || C != heads * kHeadDim || M < 1 || M > kMaxM || th < 1 || tw < 1)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    if (ceil16((th + 2) * (tw + 2)) > kMaxHalo) return (int)cudaErrorInvalidValue;
    return launch<float>(block_f32, 0, kThreadsF32, ln1x, kv_in, res, wq, bq, wkv, bkv, wp,
                             bp, lns, lnb, w1, b1, dwk, dwb, w2, b2, kv_scratch, out, B, H, W, M,
                             C, heads, th, tw, scale, eps, st);
  }
  if (dtype != 1 || (th + 2) * (tw + 2) > kRows || bf16_kernel(C) == nullptr ||
      (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) || stages < 2 ||
      stages > kMaxStagesB)
    return (int)cudaErrorInvalidValue;
  return launch_bf16(ln1x, kv_in, res, wq, bq, wkv, bkv, wp, bp, lns, lnb, w1, b1, dwk, dwb, w2,
                     b2, kv_scratch, out, B, H, W, M, C, heads, th, tw, cluster, stages, scale,
                     eps, st);
}

// The Hopper GEMM core alone, for the GPU tests: out (M, N) f32 = a (M, K)
// . w (N, K)^T, bf16; mode 0 reads A from shared memory, mode 1 from
// registers (hopper_gemm.cuh: gemm_core).
int pf_gemm_core(const void* a, const void* w, void* out, int M, int N, int K, int mode,
                 void* stream) {
  return launch_gemm_core(a, w, out, M, N, K, mode, static_cast<cudaStream_t>(stream));
}

const char* pf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

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
// The bound on the H100: the tensor-core work of the two products
// (~8 us a call at the flagship's B=8 shapes, kernels/roofline.py), with
// the CUDA-core work (49 taps, LayerNorm, GELU on the 4x hidden map) and
// the bytes close behind. Unfused, the block moves the activation through
// HBM about six times in seven launches. The WMMA version of this kernel
// lost to that path: each block streamed all of W1 and W2 from L2 for 32 or
// 64 tokens (0.30 GB of L2 reads a call at C = 768), its 16x16 MMAs were
// bound by shared-memory traffic, the f32 hidden map went through shared
// memory, and where its tiles left SMs idle it split the hidden dimension
// into f32 partials that made an HBM round trip to a second launch.
//
// bfloat16, this design (hopper_gemm.cuh): a block owns 64 consecutive
// tokens of one image (wgmma's M) with all C channels, and a cluster of S
// blocks shares each token tile (S > 1 where the tiles alone leave SMs
// idle: C = 384 and 768 at the flagship's sizes). Its two consumer
// warpgroups
//   1. convolve C / S of the channels: x's rows (the tokens and their
//      3-pixel halo) arrive by cp.async in chunks of cc channels; each
//      thread slides a 7-tap window over up to 8 consecutive tokens of a
//      row; one sweep sums the LayerNorm moments (the cluster's partial sums
//      added in rank order over distributed shared memory), a second
//      normalises (z is recomputed unless one chunk holds the block's
//      channels) and writes y into every block of the cluster as wgmma's
//      swizzled A operand;
//   2. walk the block's share of the hidden chunks (s, s + S, ... of 64):
//      pwconv1 on wgmma (m64n64, A = y from shared memory, B = the W1 tile
//      from the ring), b1 and GELU on the accumulator in registers, rounded
//      to bf16, which then is pwconv2's register A operand (m64n64 per 64
//      output columns); the f32 hidden map never leaves registers;
//   3. add the cluster's f32 partial outputs through distributed shared
//      memory in rank order, each block finishing 64 / S of the rows (b2,
//      gamma, the residual). No partial reaches HBM; one launch.
// The output columns are split between the two warpgroups: each holds up to
// 3 x 64 columns of f32 accumulators, so a block covers at most 384 columns
// in a pass and C = 768 takes two passes (each warpgroup computes pwconv1
// for its own register operand, so pwconv1 runs once per warpgroup and
// pass). Wider maps take passes of 256 or 128 columns where the f32 partial
// output of 384 would not fit beside y (C = 1024); the last pass's columns
// past C are computed on zero weights and not stored. A
// producer warpgroup streams the weight tiles by TMA through a ring of 16 KB
// stages and gives its registers to the consumers (setmaxnreg: 232 each).
// Every MMA of a ring stage is unconditional (y padded to whole 128-column
// tiles; the W2 tiles per pass a template parameter): a conditional MMA
// made ptxas serialise them all. kernels/convnext_block.py: plan picks S,
// cc and the ring depth.
//
// What bounds it now (PERF.md): 3-5% of the bound. The weights still
// come from L2 once per token tile and pass (118-226 MB a call), pwconv1
// runs once per warpgroup, and at C = 96 and 192 the 800 and 200 blocks of
// 64 tokens run in 7 and 2 waves of one block per SM. Next: a cluster that
// multicasts the weight tiles across token tiles, as B6 does.
//
// float32 runs scalar FMAs (the tensor cores' f32 input is TF32, which
// would not match f32); its chunked pwconv2 continues one FMA chain over
// the hidden dimension, and its conv reads x straight from HBM.

#include <cuda_pipeline.h>

#include <algorithm>

#include "hopper_gemm.cuh"

namespace {

constexpr int kThreadsF32 = 256;       // float32 kernel: 8 warps
constexpr int kHC = 64;                // hidden channels per chunk
constexpr int kMaxTokens = 64;         // tokens per block
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
// bfloat16: wgmma, a TMA weight ring, the hidden split over a cluster
// ---------------------------------------------------------------------------

constexpr int kTok = 64;          // tokens per block: wgmma's M
constexpr int kPassCols = 384;    // output columns per pass: 2 warpgroups x 3 x 64
constexpr int kMaxStages = 6;     // ring stages at most
constexpr int kRun = 8;           // conv: consecutive tokens a thread takes at once

__host__ __device__ inline int conv_rows(int H, int W) {
  const int r = (kTok - 1) / W + 8;  // the rows 64 tokens can span, and the 3-pixel halo
  return r < H ? r : H;
}

// One block's shared memory, in bytes from its 1024-aligned base
// (kernels/convnext_block.py: smem_bytes mirrors it): the ring, y (64 x C
// as the swizzled A operand, zero-padded to whole 128-column tiles), one
// room for the conv's staged rows and z chunk and then the pass's f32
// partial output (64 x pc), the LayerNorm sums, the ring's barriers.
struct CnxLayout {
  size_t ring, ys, room, xt_bytes, stats, bars, end;
  __host__ __device__ CnxLayout(int C, int H, int W, int cc, int pc, int stages) {
    ring = 0;
    ys = ring + (size_t)stages * kStageBytes;
    room = ys + (size_t)kTok * round_up(C, 128) * 2;
    xt_bytes = align128((size_t)conv_rows(H, W) * W * cc * 2);
    const size_t conv = xt_bytes + (size_t)kTok * cc * 4;
    const size_t red = (size_t)kTok * pc * 4;
    stats = room + align128(conv > red ? conv : red);
    bars = stats + 4 * kTok * 4;
    end = bars + 2 * (size_t)stages * 8;
  }
  __host__ __device__ size_t bytes() const { return end + 1024; }  // + aligning the base
};

// Step 1, the consumer warpgroups: y = T(LN(dw7x7(x) + dwb) * lns + lnb)
// for the tokens q0 .. q0 + nq of image b into ys (swizzled, rows past nq
// zero) of every block of the cluster. Block ``rank`` of S takes the
// channels [rank C/S, (rank + 1) C/S): x's rows are staged cc channels at
// a time into xt by cp.async; the first sweep writes each chunk's z into
// zc and adds its per-token sums into part (sum, sum of squares) in chunk
// order; the blocks' parts are summed in rank order over distributed shared
// memory into stats; the second sweep normalises (recomputing z when the
// block's channels take more than one chunk) and writes y into every
// block. Thread (c, g) holds channel c's 49 taps and takes the g-th of G
// runs of consecutive tokens, up to kRun of one image row at a time
// (out-of-image taps add zero, in row-major order); threads past G * cc
// idle. Holds one cluster sync; the caller syncs the cluster again once y
// is written, and the producer warpgroup matches both.
__device__ __forceinline__ void conv_ln(bf16* ys, bf16* xt, float* zc, float* part, float* stats,
                                        const cg::cluster_group& cluster,
                                        const bf16* __restrict__ x, const bf16* __restrict__ dwk,
                                        const bf16* __restrict__ dwb, const bf16* __restrict__ lns,
                                        const bf16* __restrict__ lnb, int b, int q0, int nq, int H,
                                        int W, int C, int cc, float eps) {
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int cb = C / S, cb0 = rank * cb;  // this block's channels
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int ya = q0 / W, yb = (q0 + nq - 1) / W;
  const int r0 = max(0, ya - 3), npix = (min(H, yb + 4) - r0) * W, vpp = cc / 8;
  const bf16* src = x + ((size_t)b * H + r0) * W * C;
  const int G = kConsumerThreads / cc, c = t % cc, g = t / cc;
  const bool active = g < G;
  const float inv_c = 1.f / (float)C;
  const bool one_chunk = cc == cb;
  for (int sweep = 0; sweep < 2; ++sweep) {
    if (sweep == 1) {  // the cluster's parts, summed in rank order
      consumers_sync();
      cluster_sync();
      if (t < 2 * kTok) {
        float sum = 0.f;
        for (int r = 0; r < S; ++r) sum += cluster.map_shared_rank(part, r)[t];
        stats[t] = sum;
      }
      consumers_sync();
    }
    for (int c0 = cb0; c0 < cb0 + cb; c0 += cc) {
      const bool stage = !(sweep == 1 && one_chunk);  // one chunk: z is still in zc
      if (stage) {
        consumers_sync();  // the last chunk's reads of xt and zc are done
        for (int i = t; i < npix * vpp; i += kConsumerThreads) {
          const int pix = i / vpp, v = i % vpp;
          __pipeline_memcpy_async(xt + pix * cc + v * 8, src + (size_t)pix * C + c0 + v * 8, 16);
        }
        __pipeline_commit();
        __pipeline_wait_prior(0);
      }
      consumers_sync();
      if (active) {
        float w[49];
        if (stage) {
#pragma unroll
          for (int k = 0; k < 49; ++k) w[k] = __bfloat162float(dwk[(size_t)(c0 + c) * 49 + k]);
        }
        const float bias = __bfloat162float(dwb[c0 + c]);
        const float s = __bfloat162float(lns[c0 + c]), sb = __bfloat162float(lnb[c0 + c]);
        // runs of up to kRun consecutive tokens of one image row, so each
        // input value is loaded once per row of taps, not once per tap
        const int per = (kTok + G - 1) / G, o_end = min(kTok, (g + 1) * per);
        for (int o0 = g * per; o0 < o_end;) {
          const int y = (q0 + o0) / W, xx = (q0 + o0) % W;
          const int n = min(min(kRun, o_end - o0), o0 < nq ? min(W - xx, nq - o0) : kRun);
          float z[kRun];
#pragma unroll
          for (int j = 0; j < kRun; ++j) z[j] = 0.f;
          if (!stage) {
#pragma unroll
            for (int j = 0; j < kRun; ++j)
              if (j < n) z[j] = zc[(o0 + j) * cc + c];
          } else if (o0 < nq) {
#pragma unroll
            for (int dp = 0; dp < 7; ++dp) {
              const int yq = y + dp - 3;
              if (yq < 0 || yq >= H) continue;
              const bf16* row = xt + (yq - r0) * W * cc + c;
              float v[kRun + 6];
#pragma unroll
              for (int i = 0; i < kRun + 6; ++i) {
                const int xq = xx - 3 + i;
                v[i] = i < n + 6 && xq >= 0 && xq < W ? __bfloat162float(row[xq * cc]) : 0.f;
              }
#pragma unroll
              for (int j = 0; j < kRun; ++j)
#pragma unroll
                for (int dq = 0; dq < 7; ++dq) z[j] = fmaf(v[j + dq], w[dp * 7 + dq], z[j]);
            }
#pragma unroll
            for (int j = 0; j < kRun; ++j) z[j] += bias;
          }
#pragma unroll
          for (int j = 0; j < kRun; ++j) {
            const int o = o0 + j;
            if (j >= n) continue;
            if (sweep == 0) {
              zc[o * cc + c] = o < nq ? z[j] : 0.f;
            } else {
              float yv = 0.f;
              if (o < nq) {
                const float mu = stats[o] * inv_c;
                const float r = rsqrtf(stats[kTok + o] * inv_c - mu * mu + eps);
                yv = (z[j] - mu) * r * s + sb;
              }
              const bf16 yb = __float2bfloat16(yv);
              for (int rr = 0; rr < S; ++rr)
                cluster.map_shared_rank(ys, rr)[swz_at(kTok, o, c0 + c)] = yb;
            }
          }
          o0 += n;
        }
      }
      if (sweep == 0) {
        consumers_sync();
        for (int o = warp; o < kTok; o += kConsumerThreads / 32) {
          float s1 = 0.f, s2 = 0.f;
          for (int k = lane; k < cc; k += 32) {
            const float v = zc[o * cc + k];
            s1 += v;
            s2 = fmaf(v, v, s2);
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            s1 += __shfl_xor_sync(0xffffffffu, s1, off);
            s2 += __shfl_xor_sync(0xffffffffu, s2, off);
          }
          if (lane == 0) {
            part[o] += s1;
            part[kTok + o] += s2;
          }
        }
      }
    }
  }
}

// WST: W2 tiles (128 output rows) per hidden chunk and pass, 1 to 3, so
// that every MMA of the walk is unconditional (ptxas then keeps them
// pipelined).
template <int WST>
__global__ void __launch_bounds__(kHopperThreads, 1)
    convnext_block_bf16(const __grid_constant__ CUtensorMap w1map,
                        const __grid_constant__ CUtensorMap w2map, const bf16* __restrict__ x,
                        const bf16* __restrict__ dwk, const bf16* __restrict__ dwb,
                        const bf16* __restrict__ lns, const bf16* __restrict__ lnb,
                        const bf16* __restrict__ b1, const bf16* __restrict__ b2,
                        const bf16* __restrict__ gamma, bf16* __restrict__ out, int H, int W,
                        int C, int cc, int pc, int stages, float eps) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* base = smem_raw + (1024 - smem_u32(smem_raw) % 1024) % 1024;
  const CnxLayout L(C, H, W, cc, pc, stages);
  Ring ring(base + L.ring, reinterpret_cast<uint64_t*>(base + L.bars), stages);
  bf16* ys = reinterpret_cast<bf16*>(base + L.ys);
  float* red = reinterpret_cast<float*>(base + L.room);  // the pass's partial output
  bf16* xt = reinterpret_cast<bf16*>(base + L.room);     // before it: x's staged rows
  float* zc = reinterpret_cast<float*>(base + L.room + L.xt_bytes);
  float* part = reinterpret_cast<float*>(base + L.stats);  // this block's LN sums, then
  float* stats = part + 2 * kTok;                          // the cluster's
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  // tokens q0 .. q0 + nq of image b (a tile stays inside one image)
  const int hw = H * W, per_image = (hw + kTok - 1) / kTok, tile = blockIdx.x / S;
  const int b = tile / per_image, q0 = (tile % per_image) * kTok, nq = min(kTok, hw - q0);
  const size_t p0 = (size_t)b * hw + q0;
  const int nh = 4 * C / kHC, passes = (C + pc - 1) / pc;
  const int Cp = round_up(C, 128);

  ring.init(1);
  if (threadIdx.x < 2 * kTok) part[threadIdx.x] = 0.f;
  for (int i = threadIdx.x; i < kTok * (Cp - C); i += blockDim.x)  // y's zero padding
    ys[swz_at(kTok, i / (Cp - C), C + i % (Cp - C))] = __float2bfloat16(0.f);
  __syncthreads();

  if (threadIdx.x >= kConsumerThreads) {  // the producer warpgroup: weight tiles by TMA
    producer_registers();
    if (threadIdx.x == kConsumerThreads) {
      prefetch_map(&w1map);
      prefetch_map(&w2map);
    }
    // the first ring's worth of tiles goes out before the conv; then this
    // warpgroup matches the conv's two cluster syncs (the LayerNorm sums, y)
    int issued = 0;
    auto conv_syncs = [&] {
      if (issued >= 0) {
        cluster_sync();
        cluster_sync();
        issued = -1;
      }
    };
    auto put = [&](const WTile& t) {
      if (issued == stages) conv_syncs();
      ring.produce(t, 1, 0);
      if (issued >= 0) ++issued;
    };
    for (int p = 0; p < passes; ++p) {
      for (int h = rank; h < nh; h += S) {
        for (int k0 = 0; k0 < Cp; k0 += 128) put({&w1map, h * kHC, k0, 64, 128});
        for (int n = 0; n < WST; ++n) put({&w2map, p * pc + n * 128, h * kHC, 128, 64});
      }
      conv_syncs();
      cluster_sync();  // the cluster's partials are in shared memory
      cluster_sync();  // and have been read
    }
    return;
  }

  consumer_registers();
  const int wg = threadIdx.x / 128;
  conv_ln(ys, xt, zc, part, stats, cluster, x, dwk, dwb, lns, lnb, b, q0, nq, H, W, C, cc, eps);
  fence_async_all();  // y, written by threads of the cluster, is read by wgmma
  cluster_sync();

  for (int p = 0; p < passes; ++p) {
    float acc[WST][32];
    bool first = true;  // the pass's first MMA on acc overwrites it
    for (int h = rank; h < nh; h += S) {
      // pwconv1: hid = y . W1[h*64 : h*64 + 64]^T, both warpgroups whole
      float hid[32];
      for (int k0 = 0; k0 < Cp; k0 += 128) {
        const bf16* w = ring.wait();
        wg_fence();
        fence_regs(hid);
#pragma unroll
        for (int k = 0; k < 128; k += 16)
          mma_n64_ss(hid, desc_at(ys, kTok, 0, k0 + k), desc_at(w, 64, 0, k), k0 + k > 0);
        wg_commit();
        ring.retire(1);
      }
      ring.drain(1);
      fence_regs(hid);
      // g = T(gelu(hid + b1)) in registers, then pwconv2's A operand
#pragma unroll
      for (int i = 0; i < 32; ++i)
        hid[i] = gelu<bf16>(hid[i] + __bfloat162float(b1[h * kHC + acc_col(i)]));
      uint32_t a[4][4];
#pragma unroll
      for (int s = 0; s < 4; ++s) acc_to_a(hid, s, a[s]);
      // pwconv2: acc[n] += g . W2[p*pc + n*128 + 64*wg + (0..63), h*64 : h*64 + 64]^T
#pragma unroll
      for (int n = 0; n < WST; ++n) {
        const bf16* w = ring.wait();
        wg_fence();
        fence_regs(acc[n]);
#pragma unroll
        for (int s = 0; s < 4; ++s)
          mma_n64_rs(acc[n], a[s], desc_at(w, 128, 64 * wg, 16 * s), !first || s > 0);
        wg_commit();
        ring.retire(1);
      }
      ring.drain(1);  // the next chunk rewrites the register A operand
      first = false;
    }
#pragma unroll
    for (int n = 0; n < WST; ++n) fence_regs(acc[n]);
    // the block's partial output into red (zero if it had no chunk); the
    // first pass's conv room is free
#pragma unroll
    for (int n = 0; n < WST; ++n)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = n * 128 + 64 * wg + acc_col(i);
        if (col < pc) red[acc_row(i) * pc + col] = first ? 0.f : acc[n][i];
      }
    cluster_sync();
    // rows rank * 64/S ..: the cluster's partials summed in rank order, then
    // out = T(x + (sum + b2) * gamma)
    const int rows = kTok / S, r0 = rank * rows;
    for (int i = threadIdx.x; i < rows * pc; i += kConsumerThreads) {
      const int row = r0 + i / pc, col = i % pc;
      float sum = 0.f;
      for (int r = 0; r < S; ++r) sum += cluster.map_shared_rank(red, r)[row * pc + col];
      const int c = p * pc + col;  // the last pass may run past C
      if (row < nq && c < C) {
        const size_t gi = (p0 + row) * C + c;
        const float hv = (sum + __bfloat162float(b2[c])) * __bfloat162float(gamma[c]);
        out[gi] = __float2bfloat16(__bfloat162float(x[gi]) + hv);
      }
    }
    cluster_sync();  // every block has read the partials; red may be rewritten
  }
}

// The kernel for a pass of pc output columns (1 to 3 W2 tiles).
inline auto bf16_kernel(int pc) {
  return pc <= 128 ? convnext_block_bf16<1> : pc <= 256 ? convnext_block_bf16<2>
                                                        : convnext_block_bf16<3>;
}

size_t smem_f32(int C, int no) {
  return 2 * align128((size_t)no * C * 4) + align128((size_t)no * kHfLd * 4) +
         align128(32 * kWsLd * 4) + align128(kHC * 4);
}

int set_smem(const void* kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

int launch_bf16(const void* x, const void* dwk, const void* dwb, const void* lns,
                const void* lnb, const void* w1, const void* b1, const void* w2,
                const void* b2, const void* gamma, void* out, int B, int H, int W, int C,
                int cc, int pc, int cluster, int stages, float eps, cudaStream_t st) {
  CUtensorMap m1, m2;
  int err = make_map(&m1, w1, 4 * C, C, 64);
  if (err != 0) return err;
  err = make_map(&m2, w2, C, 4 * C, 128);
  if (err != 0) return err;
  const int tiles = B * ((H * W + kTok - 1) / kTok);
  const size_t smem = CnxLayout(C, H, W, cc, pc, stages).bytes();
  return launch_cluster(bf16_kernel(pc), dim3(tiles * cluster), kHopperThreads, smem, cluster,
                        st, false, m1, m2, static_cast<const bf16*>(x), static_cast<const bf16*>(dwk),
                        static_cast<const bf16*>(dwb), static_cast<const bf16*>(lns),
                        static_cast<const bf16*>(lnb), static_cast<const bf16*>(b1),
                        static_cast<const bf16*>(b2), static_cast<const bf16*>(gamma),
                        static_cast<bf16*>(out), H, W, C, cc, pc, stages, eps);
}

}  // namespace

extern "C" {

// Shared memory of one bf16 block; kernels/convnext_block.py: smem_bytes
// mirrors it (the GPU tests hold the two equal).
int pf_convnext_block_smem(int C, int H, int W, int cc, int pc, int stages) {
  return (int)CnxLayout(C, H, W, cc, pc, stages).bytes();
}

// How many clusters of ``cluster`` bf16 blocks the card runs at once
// (kernels/convnext_block.py: plan).
int pf_convnext_block_max_clusters(int C, int H, int W, int cc, int pc, int stages, int cluster) {
  return max_clusters(bf16_kernel(pc), kHopperThreads, CnxLayout(C, H, W, cc, pc, stages).bytes(),
                      cluster);
}

// dtype: 0 = float32, 1 = bfloat16. Every pointer is a contiguous device
// buffer: x and out (B, H, W, C); dwk (C, 1, 7, 7); dwb, lns, lnb, b2, gamma
// (C); w1 (4C, C); b1 (4C); w2 (C, 4C). Requires C % 32 == 0. float32 takes
// ``no`` tokens per block (a multiple of 16, at most 64;
// kernels/convnext_block.py:choose_tokens). bfloat16 takes 64 tokens per
// block, ``cc`` channels per staged chunk of x's rows (a multiple of 8 that
// divides C / cluster, at most 256), ``cluster`` blocks per token tile that
// split the conv's channels and the hidden dimension (1, 2, 4 or 8, C a
// multiple of 8 cluster), ``pc`` output columns per pass (a multiple of 32,
// at most 384 and at most C) and ``stages`` ring stages (2 to 6), from
// kernels/convnext_block.py:plan. Returns cudaGetLastError() after the
// launch (0 on success); a launch the card refuses is an error.
int pf_convnext_block(int dtype, const void* x, const void* dwk, const void* dwb,
                      const void* lns, const void* lnb, const void* w1, const void* b1,
                      const void* w2, const void* b2, const void* gamma, void* out, int B, int H,
                      int W, int C, int no, int cc, int pc, int cluster, int stages, float eps,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C % 32 != 0) return (int)cudaErrorInvalidValue;
  const int P = B * H * W;
  if (dtype == 0) {
    if (no % 16 != 0 || no < 16 || no > kMaxTokens) return (int)cudaErrorInvalidValue;
    const size_t smem = smem_f32(C, no);
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
  if (dtype != 1 || (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) ||
      C % (8 * cluster) != 0 || cc < 8 || cc % 8 != 0 || (C / cluster) % cc != 0 ||
      cc > kConsumerThreads || pc < 32 || pc % 32 != 0 || pc > min(C, kPassCols) ||
      stages < 2 || stages > kMaxStages)
    return (int)cudaErrorInvalidValue;
  return launch_bf16(x, dwk, dwb, lns, lnb, w1, b1, w2, b2, gamma, out, B, H, W, C, cc, pc,
                     cluster, stages, eps, st);
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

// Fused SR-attention sub-block for Hopper (sm_90a), bfloat16 and float32.
//
// Replaces the TPU kernel perspectivefields_tpu/kernels/fused_attention.py:
// _fused_attention (its pallas_call; body _attn_core / _kernel) and computes
// the function of its oracle _xla_reference with _attn_core's casts:
//
//   q  = T(x . Wq^T + bq)                      f32 accumulation, one rounding
//   kv = T(kv_in . Wkv^T + bkv)                columns [k heads | v heads]
//   per head h: p = T(softmax_f32(q_h . k_h^T * scale))
//               o_h = T(p . v_h)
//   out = T(concat_h(o_h) . Wp^T + bp)         (+ residual, added in T)
//
// T is the compute dtype. Weights come in the nn.Linear layout (out, in),
// row-major; tokens are (B, N, C) and (B, M, C); head_dim is 64, M <= 128.
//
// What bounds it on the H100 (kernels/roofline.py, the least time at the
// flagship's B=8 shapes, ~2 us a call): the operations of the q and out
// projections; the per-head products are tiny (M = 100 keys x 64). Unfused, a chain of
// batched GEMMs spends its time launching kernels and moving the (B, heads,
// N, M) logits and every projection intermediate through HBM. A first
// launch projects K/V into a small (B, M, 2C) scratch tensor; the second
// keeps q, the logits, p, o and the out projection on chip.
//
// The WMMA version of this kernel was 27-64x above the bound: a block of 32
// query rows on 8 warps read all of Wq and Wp as fragments straight from
// global memory (26 / 43 / 34 MB of L2 reads a call at stages 2 / 3 / 4),
// restaged K_h and V_h per head, and left SMs idle at stages 3-4 (104 and
// 32 blocks at B=8).
//
// bfloat16, this design (hopper_gemm.cuh): the K/V projection runs on
// wgmma (kvproj_bf16: 64 x 128 output tiles, Wkv through a TMA ring) and
// lets the attention launch start at once (programmatic dependent launch:
// the attention waits for it only before staging K/V). The attention
// launch gives a block 64 query rows of one image (wgmma's M), two
// consumer warpgroups and one producer warp that streams Wq and Wp as TMA
// tiles through a ring (the producer warpgroup's other three warps wait at
// the cluster barrier):
//   1. x's rows into shared memory (wgmma's swizzled A operand);
//   2. per head of the block's share, q_h = T(x . Wq_h^T + bq) (m64n32 per
//      warpgroup, 64 x 128 Wq tiles), into shared memory;
//   3. per head, K_h and V_h^T staged once (V^T with neighbouring lanes on
//      neighbouring keys); logits on wgmma (each warpgroup 64 of the 128
//      padded keys), the softmax in registers (exp2, one reciprocal a row)
//      with the row max and sum exchanged through shared memory, p = T(.)
//      over K_h's room; o_h = T(p . V_h) (each warpgroup 32 of the 64 head
//      columns) over x at the head's own columns;
//   4. the out projection of the block's columns, 64 at a time over every
//      head (64 x 64 Wp tiles, each warpgroup 32 columns), then
//      T(T(. + bp) + residual).
// A thread-block cluster does one of two things (kernels/fused_attention.py:
// plan, which also counts the L2 weight bytes):
//   - multicast: k neighbouring row tiles share the ring, each block loading
//     1/k of every weight tile's rows into all k, so L2 serves each tile once
//     per cluster (a grid the cluster does not divide is padded with blocks
//     that load and wait and write nothing);
//   - split, where row tiles alone leave SMs idle (stages 3-4 at B=8): S
//     blocks share one row tile; each computes q, p and o for its share of
//     the heads (only those heads' rows of Wq), then gathers the other
//     blocks' o through distributed shared memory (one cluster barrier) and
//     projects its own share of the output columns over all heads (only
//     those rows of Wp). No partial sums, no reduction.
// Every MMA of a ring stage is unconditional (x padded to whole 128-column
// tiles): a conditional MMA makes ptxas serialise them.
//
// What bounds it now (PERF.md; chip_smoke.py --phases, the PF_STAMP clock64 counts of
// one block): latency, head by head. A head takes ~4.4k cycles (K/V
// staging from L2 ~2.3k, softmax with its two exchanges ~1.6k, the MMAs
// ~0.8k); x's rows ~2.5-6.5k (HBM, every block of a split loading the same
// rows); q ~2.2k a head at C = 128, ~1k a ring stage wider; at a split the
// gather waits for the block with more heads (5 heads over 2 blocks at
// stage 3). 2-8% of the bound. Next: K/V staged by TMA a head ahead, x
// multicast within a split, an even head split.
//
// float32 runs scalar FMAs (the tensor cores' f32 input is TF32, which would
// not match f32) on 32-row blocks, its K/V projection in
// attention_common.cuh; it sums in cuBLAS's order. Its softmax and
// projection tiles are shared with the other attention kernels.

#include "attention_common.cuh"
#include "hopper_gemm.cuh"

namespace {

// One block: 32 query rows of image blockIdx.y, all heads, both projections.
__global__ void __launch_bounds__(kThreads)
    attn_block_f32(const float* __restrict__ x, const float* __restrict__ kv,
                   const float* __restrict__ wq, const float* __restrict__ bq,
                   const float* __restrict__ wp, const float* __restrict__ bp,
                   const float* __restrict__ res, float* __restrict__ out,
                   int N, int M, int C, int heads, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);  // 32 x C: x, then concat(o_h)
  float* qs = xs + kTQ * C;                    // 32 x C: q
  float* ws = qs + kTQ * C;                    // staged weights
  float* kt = ws + kKT * kWtLd;                // 64 x kKtLd: K_h transposed
  float* vs = kt + kHeadDim * kKtLd;           // kMaxM x 64: V_h
  float* s = vs + kMaxM * kHeadDim;            // 32 x kMaxM: logits, then p

  const int b = blockIdx.y, n0 = blockIdx.x * kTQ;
  const int rows = min(kTQ, N - n0);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t two_c = 2 * (size_t)C;

  for (int i = threadIdx.x; i < kTQ * C; i += kThreads) {
    const int r = i / C, col = i % C;
    xs[i] = r < rows ? x[((size_t)b * N + n0 + r) * C + col] : 0.f;
  }

  // q = x . Wq^T + bq; gemm_chunk syncs before its first read of xs
  for (int j0 = 0; j0 < C; j0 += kCols) {
    float acc[4][4];
    gemm_chunk(acc, xs, C, wq, C, j0, ws);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = j0 + tx + 16 * c;
        qs[(ty + 8 * i) * C + j] = acc[i][c] + bq[j];
      }
  }
  __syncthreads();  // q is complete; xs is free for the head outputs

  const float* kvb = kv + (size_t)b * M * two_c;
  for (int h = 0; h < heads; ++h) {
    const int hc = h * kHeadDim;
    for (int i = threadIdx.x; i < kMaxM * kHeadDim; i += kThreads) {
      const int m = i / kHeadDim, d = i % kHeadDim;
      float kval = 0.f, vval = 0.f;
      if (m < M) {
        kval = kvb[m * two_c + hc + d];
        vval = kvb[m * two_c + C + hc + d];
      }
      kt[d * kKtLd + m] = kval;
      vs[m * kHeadDim + d] = vval;
    }
    __syncthreads();

    // logits; keys past M are masked to -inf
    float lg[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) lg[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < kHeadDim; ++d) {
      float av[4], bv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = qs[(ty + 8 * i) * C + hc + d];
#pragma unroll
      for (int c = 0; c < 8; ++c) bv[c] = kt[d * kKtLd + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) lg[i][c] = fmaf(av[i], bv[c], lg[i][c]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int m = tx + 16 * c;
        s[(ty + 8 * i) * kMaxM + m] = m < M ? lg[i][c] * scale : -INFINITY;
      }
    __syncthreads();

    softmax_rows_f32(s, kTQ);
    __syncthreads();

    // o_h = p . v_h into this head's columns of xs
    float o[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[i][c] = 0.f;
    for (int m = 0; m < M; ++m) {
      float pv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = s[(ty + 8 * i) * kMaxM + m];
#pragma unroll
      for (int c = 0; c < 4; ++c) vv[c] = vs[m * kHeadDim + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) o[i][c] = fmaf(pv[i], vv[c], o[i][c]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) xs[(ty + 8 * i) * C + hc + tx + 16 * c] = o[i][c];
    __syncthreads();  // the next head overwrites kt, vs and s
  }

  // out = o . Wp^T + bp (+ residual)
  for (int j0 = 0; j0 < C; j0 += kCols) {
    float acc[4][4];
    gemm_chunk(acc, xs, C, wp, C, j0, ws);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 8 * i;
      if (r >= rows) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = j0 + tx + 16 * c;
        const size_t g = ((size_t)b * N + n0 + r) * C + j;
        float y = acc[i][c] + bp[j];
        if (res != nullptr) y += res[g];
        out[g] = y;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// float32 launches
// ---------------------------------------------------------------------------

template <typename T, typename AttnKernel>
int launch(AttnKernel attn_kernel, int threads, size_t smem,
           const void* x, const void* kv_in, const void* wq, const void* bq,
           const void* wkv, const void* bkv, const void* wp, const void* bp,
           const void* res, void* kv_scratch, void* out, int B, int N, int M,
           int C, int heads, float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;

  const int kv_err = launch_kv_proj<T>(kv_in, wkv, bkv, kv_scratch, B * M, C, stream);
  if (kv_err != 0) return kv_err;

  attn_kernel<<<dim3((N + kTQ - 1) / kTQ, B), threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(kv_scratch),
      static_cast<const T*>(wq), static_cast<const T*>(bq),
      static_cast<const T*>(wp), static_cast<const T*>(bp),
      static_cast<const T*>(res), static_cast<T*>(out), N, M, C, heads, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma, a TMA weight ring, clusters (hopper_gemm.cuh)
// ---------------------------------------------------------------------------

constexpr int kRowsQ = 64;       // query rows a block owns: wgmma's M
constexpr int kKeys = 128;       // keys padded (M <= 128)
constexpr int kMaxStagesA = 6;
constexpr int kKvStages = 4;     // the K/V projection's ring

// kv = T(kv_in . Wkv^T + bkv), (R = B*M) x J: a block per 64 x 128 output
// tile, A (64 rows x Kp, zero-padded) staged by its consumers, Wkv's 128 x
// 64 tiles through the ring, each warpgroup 64 of the 128 columns.
__global__ void __launch_bounds__(kHopperThreads, 1)
    kvproj_bf16(const __grid_constant__ CUtensorMap wmap, const bf16* __restrict__ a,
                const bf16* __restrict__ bias, bf16* __restrict__ out, int R, int K, int J) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* base = smem_raw + (1024 - smem_u32(smem_raw) % 1024) % 1024;
  Ring ring(base, reinterpret_cast<uint64_t*>(base + kKvStages * kStageBytes), kKvStages);
  bf16* as = reinterpret_cast<bf16*>(base + kKvStages * kStageBytes + 1024);  // 64 x Kp
  grid_launch_dependents();  // the attention launch's x and q need nothing from here
  const int Kp = round_up(K, 128), m0 = blockIdx.x * 64, n0 = blockIdx.y * 128;
  ring.init(1);
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // the producer warpgroup: one warp waits on the ring
    producer_registers();
    if (threadIdx.x < kConsumerThreads + 32)
      for (int k0 = 0; k0 < K; k0 += 64) ring.produce({&wmap, n0, k0, 128, 64}, 1, 0);
    return;
  }
  consumer_registers();
  const int nvec = 64 * (Kp / 8);
  for (int i0 = threadIdx.x; i0 < nvec; i0 += 4 * kConsumerThreads) {
    uint4 val[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * kConsumerThreads, r = i / (Kp / 8), v = i % (Kp / 8);
      val[u] = make_uint4(0, 0, 0, 0);
      if (i < nvec && m0 + r < R && v * 8 < K)
        val[u] = reinterpret_cast<const uint4*>(a + (size_t)(m0 + r) * K)[v];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * kConsumerThreads;
      if (i < nvec) *reinterpret_cast<uint4*>(as + swz_at(64, i / (Kp / 8), (i % (Kp / 8)) * 8)) = val[u];
    }
  }
  fence_async_smem();
  consumers_sync();
  float d[32];
  for (int k0 = 0; k0 < K; k0 += 64) {
    const bf16* w = ring.wait();
    wg_fence();
    fence_regs(d);
#pragma unroll
    for (int k = 0; k < 64; k += 16)
      mma_n64_ss(d, desc_at(as, 64, 0, k0 + k), desc_at(w, 128, 64 * wg, k), k0 + k > 0);
    wg_commit();
    ring.retire2(1);
  }
  ring.drain(1);
  fence_regs(d);
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int r = m0 + acc_row(i), c = n0 + 64 * wg + acc_col(i);
    if (r < R && c < J) {
      const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + c));
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r * J + c) =
          __floats2bfloat162_rn(d[i] + b.x, d[i + 1] + b.y);
    }
  }
}

inline size_t kvproj_smem(int K) {
  return 1024 + kKvStages * kStageBytes + 1024 + (size_t)64 * round_up(K, 128) * 2;
}

// One bf16 attention block's shared memory, in bytes from its 1024-aligned
// base (kernels/fused_attention.py: smem_bytes mirrors it): the ring; xs
// (x, then o; 64 x C zero-padded to whole 128-column tiles, swizzled); qs
// (q of the block's hs heads, 64 x 64 hs, swizzled); K_h (then p) and
// V_h^T; the softmax's row exchange; the ring's barriers.
struct AttnLayout {
  size_t ring, xs, qs, kv, xch, bars, end;
  __host__ __device__ AttnLayout(int C, int hs, int stages) {
    ring = 0;
    xs = ring + (size_t)stages * kStageBytes;
    qs = xs + (size_t)kRowsQ * round_up(C, 128) * 2;
    kv = qs + (size_t)kRowsQ * hs * kHeadDim * 2;
    xch = kv + 2 * (size_t)kKeys * kHeadDim * 2;
    bars = xch + 4 * kRowsQ * 4;
    end = bars + 2 * (size_t)stages * 8;
  }
  __host__ __device__ size_t bytes() const { return end + 1024; }  // + aligning the base
};

// The heads [h0, h1) of block ``rank`` of a split over S blocks (all heads
// without one).
__host__ __device__ inline void head_share(int heads, int S, int rank, int& h0, int& h1) {
  h0 = rank * heads / S;
  h1 = (rank + 1) * heads / S;
}

// The output columns [c0, c1) that block ``rank`` of a split projects: whole
// 32-column halves of a 64-column tile, shared out as evenly as they go.
__host__ __device__ inline void col_share(int C, int S, int rank, int& c0, int& c1) {
  const int units = C / 32;
  c0 = rank * units / S * 32;
  c1 = (rank + 1) * units / S * 32;
}

// split == 0: the cluster multicasts the weights over neighbouring row
// tiles; split == 1: the cluster's blocks share a row tile and split its
// heads.
__global__ void __launch_bounds__(kHopperThreads, 1)
    attn_bf16(const __grid_constant__ CUtensorMap wqmap, const __grid_constant__ CUtensorMap wpmap,
              const bf16* __restrict__ x, const bf16* __restrict__ kv,
              const bf16* __restrict__ bq, const bf16* __restrict__ bp,
              const bf16* __restrict__ res, bf16* __restrict__ out, int B, int N, int M, int C,
              int heads, int split, int stages, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* base = smem_raw + (1024 - smem_u32(smem_raw) % 1024) % 1024;
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int mc = split ? 1 : S, mrank = split ? 0 : rank;  // the ring's multicast
  int h0 = 0, h1 = heads;
  if (split) head_share(heads, S, rank, h0, h1);
  const int hs = h1 - h0;
  const int hs_max = split ? (heads + S - 1) / S : heads;  // the layout every block uses
  const AttnLayout L(C, hs_max, stages);
  Ring ring(base + L.ring, reinterpret_cast<uint64_t*>(base + L.bars), stages);
  bf16* xs = reinterpret_cast<bf16*>(base + L.xs);  // x, then o (swizzled)
  bf16* qs = reinterpret_cast<bf16*>(base + L.qs);  // q of the share's heads (swizzled)
  bf16* ks = reinterpret_cast<bf16*>(base + L.kv);  // K_h: 128 keys x 64 (swizzled)
  bf16* vt = ks + kKeys * kHeadDim;                 // V_h^T: 64 x 128 keys (swizzled)
  bf16* ps = ks;                                    // p: 64 x 128 keys (swizzled)
  float* xmax = reinterpret_cast<float*>(base + L.xch);  // [2][64] row max per warpgroup
  float* xsum = xmax + 2 * kRowsQ;                       // [2][64] row sums

  // the row tile: blocks past the last tile (the grid padded to the
  // cluster) redo the last one and write nothing
  const int per_image = (N + kRowsQ - 1) / kRowsQ, tiles = B * per_image;
  const int tile_id = split ? (int)blockIdx.x / S : (int)blockIdx.x;
  const bool real = tile_id < tiles;
  const int ti = real ? tile_id : tiles - 1;
  const int b = ti / per_image, n0 = (ti % per_image) * kRowsQ;
  const int rows = min(kRowsQ, N - n0);
  const int Cp = round_up(C, 128);
  const bf16* kvb = kv + (size_t)b * M * 2 * C;

  ring.init(mc);
  for (int i = threadIdx.x; i < kRowsQ * (Cp - C); i += blockDim.x)  // xs's zero padding
    xs[swz_at(kRowsQ, i / (Cp - C), C + i % (Cp - C))] = __float2bfloat16(0.f);
  __syncthreads();
  cluster_sync();  // every block's barriers are initialised before any multicast
  PF_STAMP(0);

  if (threadIdx.x >= kConsumerThreads) {  // the producer warpgroup: weight tiles by TMA
    producer_registers();
    if (threadIdx.x == kConsumerThreads) {
      prefetch_map(&wqmap);
      prefetch_map(&wpmap);
    }
    // One warp waits on the ring; the other three wait at the cluster's
    // barriers, where they take no issue slots from the consumers.
    if (threadIdx.x >= kConsumerThreads + 32) {
      if (split) cluster_sync();  // the consumers' gather of o
      cluster_sync();
      return;
    }
    for (int h = h0; h < h1; ++h)
      for (int k0 = 0; k0 < Cp; k0 += 128)
        ring.produce({&wqmap, h * kHeadDim, k0, 64, 128}, mc, mrank);
    // Wp's tiles: the block's columns 64 at a time, over every head. At a
    // split the consumers meet the cluster before the first (to gather o),
    // and so must this warpgroup: it loads a ring's worth first (the stages
    // the consumers have released by then), never one that would wait for a
    // release past that meeting.
    int c0 = 0, c1 = C;
    if (split) col_share(C, S, rank, c0, c1);
    const int total = (c1 - c0 + 63) / 64 * heads;
    int next = 0;
    auto put = [&](int i) {
      ring.produce({&wpmap, c0 + 64 * (i / heads), (i % heads) * kHeadDim, 64, 64}, mc, mrank);
    };
    if (split) {
      for (; next < min(total, stages); ++next) put(next);
      cluster_sync();  // the consumers' gather of o
    }
    for (; next < total; ++next) put(next);
    __syncwarp();
    cluster_sync();  // no block leaves while others may still read or write into it
    return;
  }

  consumer_registers();
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;

  // 1. x's rows (zero past N), four 16-byte loads in flight a thread
  const int nvec = kRowsQ * (C / 8);
  for (int i0 = threadIdx.x; i0 < nvec; i0 += 4 * kConsumerThreads) {
    uint4 val[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * kConsumerThreads, t = i / (C / 8), v = i % (C / 8);
      val[u] = make_uint4(0, 0, 0, 0);
      if (i < nvec && t < rows) val[u] = reinterpret_cast<const uint4*>(x + ((size_t)b * N + n0 + t) * C)[v];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * kConsumerThreads, t = i / (C / 8), v = i % (C / 8);
      if (i < nvec) *reinterpret_cast<uint4*>(xs + swz_at(kRowsQ, t, v * 8)) = val[u];  // 8 values share a chunk
    }
  }
  fence_async_smem();
  consumers_sync();
  PF_STAMP(1);

  // 2. q_h = T(x . Wq_h^T + bq) for the share's heads
  for (int hl = 0; hl < hs; ++hl) {
    float d[16];
    for (int k0 = 0; k0 < Cp; k0 += 128) {
      const bf16* w = ring.wait();
      wg_fence();
      fence_regs(d);
#pragma unroll
      for (int k = 0; k < 128; k += 16)
        mma_n32_ss(d, desc_at(xs, kRowsQ, 0, k0 + k), desc_at(w, 64, 32 * wg, k), k0 + k > 0);
      wg_commit();
      ring.retire2(mc);
    }
    ring.drain(mc);
    fence_regs(d);
    const int col0 = (h0 + hl) * kHeadDim + 32 * wg;
#pragma unroll
    for (int i = 0; i < 16; ++i)
      qs[swz_at(kRowsQ, acc_row(i), hl * kHeadDim + 32 * wg + acc_col(i))] =
          __float2bfloat16(d[i] + __bfloat162float(bq[col0 + acc_col(i)]));
  }

  // 3. attention, head by head; o_h into xs at its own columns (x is no
  // longer read). The K/V projection launch has finished from here on.
  grid_wait();
  for (int hl = 0; hl < hs; ++hl) {
    const int hc = (h0 + hl) * kHeadDim;
    consumers_sync();  // q is complete; the last head's P.V has read p (in ks) and vt
    PF_STAMP_STEP(2, hl);
    // (K_h: a 16-byte store a key row; V_h^T: neighbouring lanes take
    // neighbouring keys, so their 2-byte stores into one row do not collide)
    constexpr int kVecs = kKeys * (kHeadDim / 8) / kConsumerThreads;
    uint4 kval[kVecs], vval[kVecs];
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const int i = threadIdx.x + u * kConsumerThreads;
      const int km = i / (kHeadDim / 8), kv8 = i % (kHeadDim / 8);
      const int vm = i % kKeys, vv8 = i / kKeys;
      kval[u] = vval[u] = make_uint4(0, 0, 0, 0);
      if (km < M) kval[u] = reinterpret_cast<const uint4*>(kvb + (size_t)km * 2 * C + hc)[kv8];
      if (vm < M) vval[u] = reinterpret_cast<const uint4*>(kvb + (size_t)vm * 2 * C + C + hc)[vv8];
    }
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const int i = threadIdx.x + u * kConsumerThreads;
      *reinterpret_cast<uint4*>(ks + swz_at(kKeys, i / (kHeadDim / 8), (i % (kHeadDim / 8)) * 8)) =
          kval[u];
      const bf16* ve = reinterpret_cast<const bf16*>(&vval[u]);
#pragma unroll
      for (int e = 0; e < 8; ++e) vt[swz_at(kHeadDim, (i / kKeys) * 8 + e, i % kKeys)] = ve[e];
    }
    fence_async_smem();
    consumers_sync();
    PF_STAMP_STEP(3, hl);

    // logits of this warpgroup's 64 keys: q_h . K_h[64 wg ..]^T
    float s[32];
    wg_fence();
    fence_regs(s);
#pragma unroll
    for (int k = 0; k < kHeadDim; k += 16)
      mma_n64_ss(s, desc_at(qs, kRowsQ, 0, hl * kHeadDim + k), desc_at(ks, kKeys, 64 * wg, k),
                 k > 0);
    wg_commit();
    wg_wait0();
    PF_STAMP_STEP(4, hl);
    fence_regs(s);
    // p = T(softmax(s * scale)) over all M keys: row max and sum over the
    // thread's quad, then across the two warpgroups through shared memory;
    // p overwrites K_h, which both warpgroups' logits have read by the
    // first exchange
    // (in base 2: s * scale * log2(e), so each exponential is one exp2f)
    const float scale2 = scale * 1.4426950408889634f;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int key = 64 * wg + acc_col(i);
      s[i] = key < M ? s[i] * scale2 : -INFINITY;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    const int row0 = acc_row(0), row1 = acc_row(2);
    if (lane % 4 == 0) {
      xmax[wg * kRowsQ + row0] = mx[0];
      xmax[wg * kRowsQ + row1] = mx[1];
    }
    consumers_sync();
    mx[0] = fmaxf(xmax[row0], xmax[kRowsQ + row0]);
    mx[1] = fmaxf(xmax[row1], xmax[kRowsQ + row1]);
    float sm[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = exp2f(s[i] - mx[(i >> 1) & 1]);  // masked keys: exp2(-inf) = 0
      sm[(i >> 1) & 1] += s[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sm[r] += __shfl_xor_sync(0xffffffffu, sm[r], 1);
      sm[r] += __shfl_xor_sync(0xffffffffu, sm[r], 2);
    }
    if (lane % 4 == 0) {
      xsum[wg * kRowsQ + row0] = sm[0];
      xsum[wg * kRowsQ + row1] = sm[1];
    }
    consumers_sync();
    const float inv[2] = {1.f / (xsum[row0] + xsum[kRowsQ + row0]),
                          1.f / (xsum[row1] + xsum[kRowsQ + row1])};
#pragma unroll
    for (int i = 0; i < 32; i += 2)
      *reinterpret_cast<__nv_bfloat162*>(ps + swz_at(kRowsQ, acc_row(i), 64 * wg + acc_col(i))) =
          __floats2bfloat162_rn(s[i] * inv[(i >> 1) & 1], s[i + 1] * inv[(i >> 1) & 1]);
    fence_async_smem();
    consumers_sync();
    PF_STAMP_STEP(5, hl);

    // o_h[:, 32 wg ..] = T(p . V_h[:, 32 wg ..])
    float o[16];
    wg_fence();
    fence_regs(o);
#pragma unroll
    for (int k = 0; k < kKeys; k += 16)
      mma_n32_ss(o, desc_at(ps, kRowsQ, 0, k), desc_at(vt, kHeadDim, 32 * wg, k), k > 0);
    wg_commit();
    PF_STAMP_STEP(9, hl);
    wg_wait0();
    PF_STAMP_STEP(6, hl);
    fence_regs(o);
#pragma unroll
    for (int i = 0; i < 16; i += 2)
      *reinterpret_cast<__nv_bfloat162*>(
          xs + swz_at(kRowsQ, acc_row(i), hc + 32 * wg + acc_col(i))) =
          __floats2bfloat162_rn(o[i], o[i + 1]);
  }
  fence_async_smem();
  consumers_sync();  // o is complete
  PF_STAMP(90);
  if (split) {
    // gather the other blocks' heads of o into xs at the same (swizzled)
    // offsets: each block then holds all of o and projects its own columns
    cluster_sync();
    for (int r = 0; r < S; ++r) {
      if (r == rank) continue;
      int g0, g1;
      head_share(heads, S, r, g0, g1);
      const int kb0 = g0 * kHeadDim / kKb, nkb = (g1 - g0) * kHeadDim / kKb;  // 32-column k-blocks
      const uint4* src =
          reinterpret_cast<const uint4*>(cluster.map_shared_rank(xs, r) + kb0 * kRowsQ * kKb);
      uint4* dst = reinterpret_cast<uint4*>(xs + kb0 * kRowsQ * kKb);
      const int n = nkb * kRowsQ * kKb / 8;
      for (int i0 = threadIdx.x; i0 < n; i0 += 4 * kConsumerThreads) {
        uint4 v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (i0 + u * kConsumerThreads < n) v[u] = src[i0 + u * kConsumerThreads];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (i0 + u * kConsumerThreads < n) dst[i0 + u * kConsumerThreads] = v[u];
      }
    }
    fence_async_smem();
    consumers_sync();
    PF_STAMP(91);
  }

  // 4. the out projection of this block's columns [c0, c1) (all of C, or
  // its share at a split) over every head, 64 columns at a time (each
  // warpgroup 32): acc = o . Wp[col0 + 32 wg + (0..31), :]^T, then out =
  // T(T(acc + bp) + residual)
  int c0 = 0, c1 = C;
  if (split) col_share(C, S, rank, c0, c1);
  for (int col0 = c0; col0 < c1; col0 += 64) {
    float acc[16];
    for (int h = 0; h < heads; ++h) {
      const bf16* w = ring.wait();
      wg_fence();
      fence_regs(acc);
#pragma unroll
      for (int k = 0; k < kHeadDim; k += 16)
        mma_n32_ss(acc, desc_at(xs, kRowsQ, 0, h * kHeadDim + k), desc_at(w, 64, 32 * wg, k),
                   h > 0 || k > 0);
      wg_commit();
      ring.retire2(mc);
    }
    ring.drain(mc);
    PF_STAMP_STEP(7, (col0 - c0) / 64);
    fence_regs(acc);
#pragma unroll
    for (int i = 0; i < 16; i += 2) {
      const int t = acc_row(i), c = col0 + 32 * wg + acc_col(i);
      if (!real || t >= rows || c >= c1) continue;
      const size_t g = ((size_t)b * N + n0 + t) * C + c;
      const float2 bias = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bp + c));
      float y0 = rnd(acc[i] + bias.x), y1 = rnd(acc[i + 1] + bias.y);
      if (res != nullptr) {
        const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(res + g));
        y0 += r.x;
        y1 += r.y;
      }
      *reinterpret_cast<__nv_bfloat162*>(out + g) = __floats2bfloat162_rn(y0, y1);
    }
  }
  cluster_sync();  // no block leaves while others may still read or write into it
}

int launch_bf16(const void* x, const void* kv_in, const void* wq, const void* bq, const void* wkv,
                const void* bkv, const void* wp, const void* bp, const void* res,
                void* kv_scratch, void* out, int B, int N, int M, int C, int heads, int cluster,
                int split, int stages, float scale, cudaStream_t stream) {
  const int mc = split ? 1 : cluster, R = B * M;
  CUtensorMap mkv, mq, mp;
  int err = make_map(&mkv, wkv, 2 * C, C, 128);
  if (err == 0) err = make_map(&mq, wq, C, C, 64 / mc);
  if (err == 0) err = make_map(&mp, wp, C, C, 64 / mc);
  if (err != 0) return err;
  err = launch_cluster(kvproj_bf16, dim3((R + 63) / 64, 2 * C / 128), kHopperThreads,
                       kvproj_smem(C), 1, stream, false, mkv, static_cast<const bf16*>(kv_in),
                       static_cast<const bf16*>(bkv), static_cast<bf16*>(kv_scratch), R, C,
                       2 * C);
  if (err != 0) return err;
  const int tiles = B * ((N + kRowsQ - 1) / kRowsQ);
  const int grid = split ? tiles * cluster : (tiles + cluster - 1) / cluster * cluster;
  const int hs = split ? (heads + cluster - 1) / cluster : heads;
  return launch_cluster(attn_bf16, dim3(grid), kHopperThreads,
                        AttnLayout(C, hs, stages).bytes(), cluster, stream, true, mq, mp,
                        static_cast<const bf16*>(x), static_cast<const bf16*>(kv_scratch),
                        static_cast<const bf16*>(bq), static_cast<const bf16*>(bp),
                        static_cast<const bf16*>(res), static_cast<bf16*>(out), B, N, M, C, heads,
                        split, stages, scale);
}

}  // namespace

extern "C" {

// Shared memory of one bf16 attention block whose share is ``hs`` heads,
// with a ring of ``stages`` stages; kernels/fused_attention.py: smem_bytes
// mirrors it (the GPU tests hold them equal).
int pf_fused_attention_smem(int C, int hs, int stages) {
  return (int)AttnLayout(C, hs, stages).bytes();
}

// How many clusters of ``cluster`` bf16 blocks (a share of ``hs`` heads, a
// ring of ``stages`` stages) the card runs at once
// (kernels/fused_attention.py: plan).
int pf_fused_attention_max_clusters(int C, int hs, int stages, int cluster) {
  return max_clusters(attn_bf16, kHopperThreads, AttnLayout(C, hs, stages).bytes(), cluster);
}

// dtype: 0 = float32, 1 = bfloat16. res may be null. Every pointer is a
// contiguous device buffer; kv_scratch holds B * M * 2C elements. Requires
// C = heads * 64 and 1 <= M <= 128 (the wrapper checks). bfloat16 takes a
// ``cluster`` of 1, 2, 4 or 8 blocks that multicast the weights over as
// many row tiles (split 0) or share out one row tile's heads and output
// columns (split 1, cluster <= heads), and a ring of ``stages`` stages (2
// to 6), from kernels/fused_attention.py: plan; float32 ignores the three.
// Returns cudaGetLastError() after the launches (0 on success); a launch
// the card refuses is an error.
int pf_fused_attention(int dtype, const void* x, const void* kv_in,
                       const void* wq, const void* bq, const void* wkv,
                       const void* bkv, const void* wp, const void* bp,
                       const void* res, void* kv_scratch, void* out, int B,
                       int N, int M, int C, int heads, int cluster, int split,
                       int stages, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (heads < 1 || C != heads * kHeadDim || M < 1 || M > kMaxM || N < 1)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    const size_t smem =
        (2 * (size_t)kTQ * C + kKT * kWtLd + kHeadDim * kKtLd +
         kMaxM * kHeadDim + kTQ * kMaxM) * sizeof(float);
    return launch<float>(attn_block_f32, kThreads, smem, x, kv_in, wq, bq,
                         wkv, bkv, wp, bp, res, kv_scratch, out, B, N, M, C,
                         heads, scale, st);
  }
  if (dtype != 1 || (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) || (split != 0 && split != 1) ||
      (split && cluster > heads) ||
      stages < 2 || stages > kMaxStagesA)
    return (int)cudaErrorInvalidValue;
  return launch_bf16(x, kv_in, wq, bq, wkv, bkv, wp, bp, res, kv_scratch, out, B, N, M, C, heads,
                     cluster, split, stages, scale, st);
}

const char* pf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// Stage-1 SR-attention sub-block (one head, C = 64) for Hopper (sm_90a),
// bfloat16 and float32.
//
// Replaces the TPU kernel perspectivefields_tpu/kernels/stage1_attention.py:
// stage1_attention (its pallas_call; body _kernel) and computes the function
// of its oracle fused_attention._xla_reference with one head, with the casts
// of fused_attention.cu:
//
//   q  = T(x . Wq^T + bq)                      f32 accumulation, one rounding
//   kv = T(kv_in . Wkv^T + bkv)                columns [k | v]
//   p  = T(softmax_f32(q . k^T * scale));  o = T(p . v)
//   out = T(o . Wp^T + bp)                     (+ residual, added in T)
//
// for x (B, N, 64), kv_in (B, M, 64) with M <= 128 and any N (MiT stage 1:
// N = 6400, M = 100). The TPU kernel packs token pairs into 128 lanes
// because C = 64 is half a TPU register; Hopper has no such width to fill,
// so this kernel ports the function, not the packing.
//
// What bounds it on the H100 (kernels/roofline.py): bytes. Per image it
// reads N x 64 tokens (and the residual) and writes as many, ~4 us a call
// at B=8 (13 MB; under the 50 MB L2, so back-to-back calls run L2-warm;
// B=32 does not fit). The tensor-core work, ~47 FLOP a byte, is 2.2 us.
//
// The WMMA version of this kernel (32-row tiles, one 16 x 16 tile a warp)
// ran at ~6% of the bound: every tile went x -> q -> f32 logits in shared
// memory -> softmax -> P.V -> out through about six block-wide barriers, with
// no overlap of the next tile's load, and a first launch wrote K/V into a
// scratch tensor that the second read back.
//
// bfloat16, this design (hopper_gemm.cuh; kernels/stage1_attention.py: plan
// counts the blocks and tiles): one launch of persistent blocks, each
// serving one image, two consumer warpgroups and one producer thread.
//   - K/V in the block, once: recomputing them (128 padded keys x 128
//     columns x 64, ~2 MFLOP, ~1k cycles on wgmma) costs each block less
//     than a second launch would (~4 us a call for B1's, plus a scratch
//     tensor written and read back): K as the logits' B operand and V^T as
//     P.V's, each warpgroup 64 keys, while the first tiles arrive.
//   - The producer fills, by TMA, a ring of two 64-row slots per consumer
//     warpgroup with x's tile and the residual's, ahead of the consumers.
//   - Each warpgroup walks its own run of 64-row tiles of the image, all in
//     registers: q = x . Wq^T (A from shared memory); the logits q . K^T on
//     128 padded keys with q as register A (keys past M set to -inf);
//     the softmax in registers (exp2, one reciprocal a row: a row's 128
//     keys sit in one quad, so no exchange between warps); P as register A
//     of P . V; o as register A of o . Wp^T; out = T(T(. + bp) + residual)
//     straight to HBM. The two warpgroups' tiles interleave on the tensor
//     cores and the CUDA cores.
// The weights (Wq, Wp, Wkv: 32 KB) and the image's kv_in arrive once per
// block by TMA. A slot goes back to the producer with one arrive a warp
// (128 arrives on one mbarrier cost ~2k cycles a tile).
//
// What bounds it now (PERF.md; chip_smoke.py --phases, the PF_STAMP clock64
// counts of one block): a tile takes a warpgroup ~6.5k cycles: the softmax
// ~2.2k (8,192 exponentials a tile on the SFU, which the two warpgroups
// share), the out projection and its stores ~2.2k, q, the logits and P.V
// ~0.5k each; the prologue ~3.3k (weights and kv_in 2k, K/V 1.3k). At the
// flagship's B=8 a call's device time (~17 us) is below the host's time to
// issue it (~0.03-0.04 ms), which sets the pace back to back. Next: skip
// the exponentials of 8-key groups past M, a third warpgroup.
//
// float32 runs scalar FMAs summed in cuBLAS's order (one FMA chain over k),
// as fused_attention.cu does, on 32-row tiles a block walks, after a first
// launch projects K/V into a scratch tensor (attention_common.cuh).

#include "attention_common.cuh"
#include "hopper_gemm.cuh"

namespace {

constexpr int kC = 64;  // channels = head_dim


// ---------------------------------------------------------------------------
// float32: scalar FMAs, 4 x 4 (4 x 8 for the logits) register tiles per
// thread; thread (tx, ty) owns rows ty + 8i and columns tx + 16c
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
    stage1_f32(const float* __restrict__ x, const float* __restrict__ kv,
               const float* __restrict__ wq, const float* __restrict__ bq,
               const float* __restrict__ wp, const float* __restrict__ bp,
               const float* __restrict__ res, float* __restrict__ out, int N,
               int M, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* wqt = reinterpret_cast<float*>(smem);  // 64 x kWtLd: wqt[k][j] = Wq[j][k]
  float* wpt = wqt + kC * kWtLd;                // 64 x kWtLd: Wp transposed
  float* kt = wpt + kC * kWtLd;                 // 64 x kKtLd: K transposed
  float* vs = kt + kC * kKtLd;                  // kMaxM x 64: V
  float* xs = vs + kMaxM * kC;                  // 32 x 64: x, then o
  float* qs = xs + kTQ * kC;                    // 32 x 64: q
  float* s = qs + kTQ * kC;                     // 32 x kMaxM: logits, then p

  const int b = blockIdx.y;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* kvb = kv + (size_t)b * M * 2 * kC;

  // the weights, K and V of this image, once per block
  for (int i = threadIdx.x; i < kC * kC; i += kThreads) {
    const int j = i / kC, k = i % kC;
    wqt[k * kWtLd + j] = wq[i];
    wpt[k * kWtLd + j] = wp[i];
  }
  for (int i = threadIdx.x; i < kMaxM * kC; i += kThreads) {
    const int m = i / kC, d = i % kC;
    kt[d * kKtLd + m] = m < M ? kvb[m * 2 * kC + d] : 0.f;
    vs[i] = m < M ? kvb[m * 2 * kC + kC + d] : 0.f;
  }

  const int ntiles = (N + kTQ - 1) / kTQ;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int n0 = tile * kTQ, rows = min(kTQ, N - n0);
    __syncthreads();  // the operands are staged; the last tile read xs
    for (int i = threadIdx.x; i < kTQ * kC; i += kThreads) {
      const int r = i / kC;
      xs[i] = r < rows ? x[((size_t)b * N + n0) * kC + i] : 0.f;
    }
    __syncthreads();

    // q = x . Wq^T + bq
    {
      float acc[4][4] = {};
#pragma unroll 8
      for (int k = 0; k < kC; ++k) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = xs[(ty + 8 * i) * kC + k];
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = wqt[k * kWtLd + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(av[i], bv[c], acc[i][c]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = tx + 16 * c;
          qs[(ty + 8 * i) * kC + j] = acc[i][c] + bq[j];
        }
    }
    __syncthreads();

    // logits; keys past M are masked to -inf
    {
      float lg[4][8] = {};
#pragma unroll 4
      for (int d = 0; d < kC; ++d) {
        float av[4], bv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = qs[(ty + 8 * i) * kC + d];
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
    }
    __syncthreads();
    softmax_rows_f32(s, kTQ);
    __syncthreads();

    // o = p . v into xs
    {
      float o[4][4] = {};
      for (int m = 0; m < M; ++m) {
        float pv[4], vv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[i] = s[(ty + 8 * i) * kMaxM + m];
#pragma unroll
        for (int c = 0; c < 4; ++c) vv[c] = vs[m * kC + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) o[i][c] = fmaf(pv[i], vv[c], o[i][c]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) xs[(ty + 8 * i) * kC + tx + 16 * c] = o[i][c];
    }
    __syncthreads();

    // out = o . Wp^T + bp (+ residual)
    {
      float acc[4][4] = {};
#pragma unroll 8
      for (int k = 0; k < kC; ++k) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = xs[(ty + 8 * i) * kC + k];
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = wpt[k * kWtLd + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(av[i], bv[c], acc[i][c]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 8 * i;
        if (r >= rows) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = tx + 16 * c;
          const size_t g = ((size_t)b * N + n0 + r) * kC + j;
          float y = acc[i][c] + bp[j];
          if (res != nullptr) y += res[g];
          out[g] = y;
        }
      }
    }
  }
}


// ---------------------------------------------------------------------------
// bfloat16: wgmma, a TMA ring of x tiles, persistent blocks (hopper_gemm.cuh)
// ---------------------------------------------------------------------------

constexpr int kRowsS = 64;    // query rows of a tile: wgmma's M
constexpr int kKeysS = 128;   // keys padded (M <= 128)
constexpr int kSlots = 2;     // x (and residual) slots of each consumer warpgroup
constexpr int kTileBytes = kRowsS * kC * 2;  // one 64 x 64 bf16 tile: 8 KB

// One bf16 block's shared memory, in bytes from its 1024-aligned base
// (kernels/stage1_attention.py: smem_bytes mirrors it): Wq and Wp (64 x 64),
// Wkv and the image's kv_in (128 x 64), K (128 keys x 64) and V^T (64 x 128
// keys), all swizzled; the slots, x then the residual, two per consumer
// warpgroup; the barriers (the weights', then each slot's full and empty).
struct S1Layout {
  size_t wq, wp, wkv, kvin, ks, vt, slots, bars, end;
  __host__ __device__ S1Layout() {
    wq = 0;
    wp = wq + kTileBytes;
    wkv = wp + kTileBytes;
    kvin = wkv + 2 * kTileBytes;
    ks = kvin + 2 * kTileBytes;
    vt = ks + 2 * kTileBytes;
    slots = vt + 2 * kTileBytes;
    bars = slots + 2 * kSlots * 2 * (size_t)kTileBytes;
    end = bars + (1 + 2 * 2 * kSlots) * 8;
  }
  __host__ __device__ size_t bytes() const { return end + 1024; }  // + aligning the base
};

// 2^x, flushing a result below 2^-126 to 0 (one MUFU op).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Block x serves image x / G; its two warpgroups take runs of ``per_unit``
// tiles: unit u = 2 (x % G) + wg owns tiles [u per_unit, (u + 1) per_unit)
// of the image's ceil(N / 64).
__device__ inline int unit_tiles(int N, int G, int unit, int& first) {
  const int per_image = (N + kRowsS - 1) / kRowsS;
  const int per_unit = (per_image + 2 * G - 1) / (2 * G);
  first = unit * per_unit;
  return max(0, min(per_unit, per_image - first));
}

__global__ void __launch_bounds__(kHopperThreads, 1)
    stage1_bf16(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap rmap,
                const __grid_constant__ CUtensorMap wqmap, const __grid_constant__ CUtensorMap wpmap,
                const __grid_constant__ CUtensorMap wkvmap, const __grid_constant__ CUtensorMap kvmap,
                const bf16* __restrict__ bq, const bf16* __restrict__ bkv,
                const bf16* __restrict__ bp, bf16* __restrict__ out, int N, int M, int G,
                int has_res, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* base = smem_raw + (1024 - smem_u32(smem_raw) % 1024) % 1024;
  const S1Layout L;
  bf16* wqs = reinterpret_cast<bf16*>(base + L.wq);
  bf16* wps = reinterpret_cast<bf16*>(base + L.wp);
  bf16* wkv = reinterpret_cast<bf16*>(base + L.wkv);
  bf16* kvs = reinterpret_cast<bf16*>(base + L.kvin);
  bf16* ks = reinterpret_cast<bf16*>(base + L.ks);
  bf16* vt = reinterpret_cast<bf16*>(base + L.vt);
  uint64_t* wbar = reinterpret_cast<uint64_t*>(base + L.bars);
  uint64_t* full = wbar + 1;              // [wg][slot]
  uint64_t* empty = full + 2 * kSlots;    // [wg][slot]
  const int b = blockIdx.x / G, unit0 = 2 * (blockIdx.x % G);
  const uint32_t slot_bytes = kTileBytes * (has_res ? 2 : 1);

  if (threadIdx.x == 0) {
    mbar_init(wbar, 1);
    for (int i = 0; i < 2 * kSlots; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4);  // each warp of the slot's warpgroup
    }
    fence_barrier_init();
  }
  __syncthreads();
  PF_STAMP(0);

  if (threadIdx.x >= kConsumerThreads) {  // the producer warpgroup; one thread issues
    producer_registers();
    if (threadIdx.x != kConsumerThreads) return;
    prefetch_map(&xmap);
    prefetch_map(&kvmap);
    mbar_expect_tx(wbar, 6 * kTileBytes);
    for (int kb = 0; kb < 2; ++kb) {
      tma_load(wqs + kb * kRowsS * kKb, &wqmap, kb * kKb, 0, wbar, 0);
      tma_load(wps + kb * kRowsS * kKb, &wpmap, kb * kKb, 0, wbar, 0);
      tma_load(wkv + kb * kKeysS * kKb, &wkvmap, kb * kKb, 0, wbar, 0);
      tma_load(kvs + kb * kKeysS * kKb, &kvmap, kb * kKb, b * M, wbar, 0);
    }
    // the two warpgroups' tiles in turn, each into its next slot
    int first[2], count[2];
    count[0] = unit_tiles(N, G, unit0, first[0]);
    count[1] = unit_tiles(N, G, unit0 + 1, first[1]);
    for (int i = 0; i < max(count[0], count[1]); ++i)
      for (int w = 0; w < 2; ++w) {
        if (i >= count[w]) continue;
        const int s = w * kSlots + i % kSlots;
        mbar_wait(&empty[s], (i / kSlots & 1) ^ 1);
        unsigned char* slot = base + L.slots + (size_t)s * 2 * kTileBytes;
        const int row = b * N + (first[w] + i) * kRowsS;
        mbar_expect_tx(&full[s], slot_bytes);
        for (int kb = 0; kb < 2; ++kb) {
          tma_load(slot + kb * kRowsS * kKb * 2, &xmap, kb * kKb, row, &full[s], 0);
          if (has_res)
            tma_load(slot + kTileBytes + kb * kRowsS * kKb * 2, &rmap, kb * kKb, row, &full[s], 0);
        }
      }
    return;
  }

  consumer_registers();
  const int wg = threadIdx.x / 128;
  // the biases at this thread's accumulator columns (a pair per 4 elements)
  float2 bqv[8], bpv[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = acc_col(4 * j);
    bqv[j] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bq + c));
    bpv[j] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bp + c));
  }

  // K = T(kv_in . Wk^T + bk) for this warpgroup's keys 64 wg .. (rows of
  // ks) and V^T = T(Wv . kv_in^T + bv) for the same keys (columns of vt)
  mbar_wait(wbar, 0);
  PF_STAMP(1);
  {
    float dk[32], dv[32];
    wg_fence();
    fence_regs(dk);
    fence_regs(dv);
#pragma unroll
    for (int k = 0; k < kC; k += 16) {
      mma_n64_ss(dk, desc_at(kvs, kKeysS, 64 * wg, k), desc_at(wkv, kKeysS, 0, k), k > 0);
      mma_n64_ss(dv, desc_at(wkv, kKeysS, 64, k), desc_at(kvs, kKeysS, 64 * wg, k), k > 0);
    }
    wg_commit();
    wg_wait0();
    fence_regs(dk);
    fence_regs(dv);
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = acc_row(i), c = acc_col(i);
      const float2 bk = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bkv + c));
      const float bv = __bfloat162float(bkv[kC + r]);
      *reinterpret_cast<__nv_bfloat162*>(ks + swz_at(kKeysS, 64 * wg + r, c)) =
          __floats2bfloat162_rn(dk[i] + bk.x, dk[i + 1] + bk.y);
      *reinterpret_cast<__nv_bfloat162*>(vt + swz_at(kC, r, 64 * wg + c)) =
          __floats2bfloat162_rn(dv[i] + bv, dv[i + 1] + bv);
    }
  }
  fence_async_smem();
  consumers_sync();  // both warpgroups' keys are in K and V^T
  PF_STAMP(2);

  const float scale2 = scale * 1.4426950408889634f;  // exp(x) = exp2(x log2(e))
  int first;
  const int count = unit_tiles(N, G, unit0 + wg, first);
  for (int i = 0; i < count; ++i) {
    const int s = wg * kSlots + i % kSlots;
    mbar_wait(&full[s], i / kSlots & 1);
    const bf16* xs = reinterpret_cast<const bf16*>(base + L.slots + (size_t)s * 2 * kTileBytes);
    const bf16* rs = xs + kRowsS * kC;
    PF_STAMP_STEP(3, i);

    // q = T(x . Wq^T + bq), as register A
    float dq[32];
    wg_fence();
    fence_regs(dq);
#pragma unroll
    for (int k = 0; k < kC; k += 16)
      mma_n64_ss(dq, desc_at(xs, kRowsS, 0, k), desc_at(wqs, kRowsS, 0, k), k > 0);
    wg_commit();
    wg_wait0();
    fence_regs(dq);
    uint32_t qa[4][4];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 bias = bqv[j / 2];
      qa[j / 4][j % 4] = pack_bf16(dq[2 * j] + bias.x, dq[2 * j + 1] + bias.y);
    }
    PF_STAMP_STEP(4, i);

    // the logits q . K^T, keys 0-63 and 64-127
    float sl[2][32];
    wg_fence();
    fence_regs(sl[0]);
    fence_regs(sl[1]);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        mma_n64_rs(sl[h], qa[k], desc_at(ks, kKeysS, 64 * h, 16 * k), k > 0);
    wg_commit();
    wg_wait0();
    fence_regs(sl[0]);
    fence_regs(sl[1]);
    PF_STAMP_STEP(5, i);

    // p = T(softmax(s * scale)) over the M keys, a row's 128 keys in its
    // quad: elements with (e >> 1) & 1 == 0 are row r, the others row r + 8.
    // scale > 0, so the row max of s * scale is scale times s's; each
    // exponential is one FFMA and one ex2
    if (M < kKeysS) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 32; ++e)
          if (64 * h + acc_col(e) >= M) sl[h][e] = -INFINITY;
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 32; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sl[h][e]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      mx[r] *= -scale2;
    }
    float sm[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        sl[h][e] = ex2(fmaf(sl[h][e], scale2, mx[(e >> 1) & 1]));  // masked keys: 0
        sm[(e >> 1) & 1] += sl[h][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sm[r] += __shfl_xor_sync(0xffffffffu, sm[r], 1);
      sm[r] += __shfl_xor_sync(0xffffffffu, sm[r], 2);
    }
    const float inv[2] = {1.f / sm[0], 1.f / sm[1]};
    uint32_t pa[8][4];  // k16 step 4 h + k: keys 64 h + 16 k ..
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 16; ++j)
        pa[4 * h + j / 4][j % 4] =
            pack_bf16(sl[h][2 * j] * inv[j & 1], sl[h][2 * j + 1] * inv[j & 1]);
    PF_STAMP_STEP(6, i);

    // o = T(p . V), as register A
    float dO[32];
    wg_fence();
    fence_regs(dO);
#pragma unroll
    for (int k = 0; k < 8; ++k) mma_n64_rs(dO, pa[k], desc_at(vt, kC, 0, 16 * k), k > 0);
    wg_commit();
    wg_wait0();
    fence_regs(dO);
    uint32_t oa[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k) acc_to_a(dO, k, oa[k]);
    PF_STAMP_STEP(7, i);

    // out = T(T(o . Wp^T + bp) + residual)
    float dy[32];
    wg_fence();
    fence_regs(dy);
#pragma unroll
    for (int k = 0; k < 4; ++k) mma_n64_rs(dy, oa[k], desc_at(wps, kRowsS, 0, 16 * k), k > 0);
    wg_commit();
    wg_wait0();
    fence_regs(dy);
    const int n0 = (first + i) * kRowsS;
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const int r = acc_row(e), c = acc_col(e);
      float y0 = rnd(dy[e] + bpv[e / 4].x), y1 = rnd(dy[e + 1] + bpv[e / 4].y);
      if (has_res) {
        const float2 rv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(rs + swz_at(kRowsS, r, c)));
        y0 += rv.x;
        y1 += rv.y;
      }
      if (n0 + r < N)
        *reinterpret_cast<__nv_bfloat162*>(out + ((size_t)b * N + n0 + r) * kC + c) =
            __floats2bfloat162_rn(y0, y1);
    }
    __syncwarp();  // the warp has read the slot
    if (threadIdx.x % 32 == 0) mbar_arrive_local(&empty[s]);
    PF_STAMP_STEP(8, i);
  }
}

// The bf16 launch: G blocks per image (kernels/stage1_attention.py: plan).
int launch_bf16(const void* x, const void* kv_in, const void* wq, const void* bq, const void* wkv,
                const void* bkv, const void* wp, const void* bp, const void* res, void* out, int B,
                int N, int M, int G, float scale, cudaStream_t stream) {
  CUtensorMap xm, rm, qm, pm, kvwm, kvm;
  int err = make_map(&xm, x, B * N, kC, kRowsS);
  if (err == 0) err = make_map(&rm, res != nullptr ? res : x, B * N, kC, kRowsS);
  if (err == 0) err = make_map(&qm, wq, kC, kC, kRowsS);
  if (err == 0) err = make_map(&pm, wp, kC, kC, kRowsS);
  if (err == 0) err = make_map(&kvwm, wkv, 2 * kC, kC, kKeysS);
  if (err == 0) err = make_map(&kvm, kv_in, B * M, kC, kKeysS);
  if (err != 0) return err;
  return launch_cluster(stage1_bf16, dim3(B * G), kHopperThreads, S1Layout().bytes(), 1, stream,
                        false, xm, rm, qm, pm, kvwm, kvm, static_cast<const bf16*>(bq),
                        static_cast<const bf16*>(bkv), static_cast<const bf16*>(bp),
                        static_cast<bf16*>(out), N, M, G, res != nullptr ? 1 : 0, scale);
}

// The f32 launch: the K/V projection into kv_scratch, then about one block
// per SM (the SM count read once), each walking several query tiles.
int launch_f32(const void* x, const void* kv_in, const void* wq, const void* bq, const void* wkv,
               const void* bkv, const void* wp, const void* bp, const void* res, void* kv_scratch,
               void* out, int B, int N, int M, float scale, cudaStream_t stream) {
  constexpr size_t kSmemF32 =
      (2 * (size_t)kC * kWtLd + kC * kKtLd + kMaxM * kC + 2 * kTQ * kC + kTQ * kMaxM) *
      sizeof(float);
  const int sms = sm_count();
  if (sms == 0) return (int)cudaErrorInvalidDevice;
  int err = (int)set_dynamic_smem(reinterpret_cast<const void*>(stage1_f32), kSmemF32);
  if (err != 0) return err;
  err = launch_kv_proj<float>(kv_in, wkv, bkv, kv_scratch, B * M, kC, stream);
  if (err != 0) return err;
  const int ntiles = (N + kTQ - 1) / kTQ;
  const int per_image = max(1, min(ntiles, (sms + B - 1) / B));
  stage1_f32<<<dim3(per_image, B), kThreads, kSmemF32, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(kv_scratch),
      static_cast<const float*>(wq), static_cast<const float*>(bq), static_cast<const float*>(wp),
      static_cast<const float*>(bp), static_cast<const float*>(res), static_cast<float*>(out), N,
      M, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory of one bf16 block; kernels/stage1_attention.py: smem_bytes
// mirrors it (the GPU tests hold them equal).
int pf_stage1_attention_smem() { return (int)S1Layout().bytes(); }

// dtype: 0 = float32, 1 = bfloat16. res may be null. Every pointer is a
// contiguous device buffer: x, res and out (B, N, 64); kv_in (B, M, 64);
// wq, wp (64, 64) and wkv (128, 64) as nn.Linear (out, in); float32's
// kv_scratch holds B * M * 128 elements (bfloat16 takes none: null). G is
// bfloat16's blocks per image (kernels/stage1_attention.py: plan), and
// bfloat16 needs scale > 0 (its softmax scales the row max). Requires
// 1 <= M <= 128 and N >= 1 (the wrapper checks). Returns cudaGetLastError()
// after the launches.
int pf_stage1_attention(int dtype, const void* x, const void* kv_in, const void* wq,
                        const void* bq, const void* wkv, const void* bkv, const void* wp,
                        const void* bp, const void* res, void* kv_scratch, void* out, int B,
                        int N, int M, int G, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M < 1 || M > kMaxM || N < 1 || B < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_f32(x, kv_in, wq, bq, wkv, bkv, wp, bp, res, kv_scratch, out, B, N, M, scale, st);
  if (dtype != 1 || G < 1 || !(scale > 0.f)) return (int)cudaErrorInvalidValue;
  return launch_bf16(x, kv_in, wq, bq, wkv, bkv, wp, bp, res, out, B, N, M, G, scale, st);
}

const char* pf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

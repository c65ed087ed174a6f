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
// What bounds it on the H100: bytes and latency. Per image it reads N x 64
// tokens and writes as many, against ~16 FLOP per byte of work; the
// attention kernel of the later stages (fused_attention.cu) would give every
// 32 query rows a block that stages Wq, Wp, K and V anew (200 blocks per
// image at N = 6400). What this design does about it: with one head and
// C = 64, Wq, Wp, K and V (M <= 128 rows) fit in shared memory together
// (~55 KB at bf16), so a block stages them once and then walks several
// 32-row query tiles of its image (grid: about two blocks per SM over all
// images). Logits never reach HBM. The K/V projection is the first launch
// into a (B, M, 128) scratch tensor (attention_common.cuh), as in
// fused_attention.cu: recomputing it in every block (~0.8 MFLOP) would cost
// more than the 26 KB per image it writes and the blocks re-read from L2.
//
// bfloat16 runs every product on the tensor cores with warp-level 16x16x16
// MMAs (WMMA), f32 accumulation; 8 warps, each owning one 16 x 16 tile of
// q, o and out. float32 runs scalar FMAs summed in cuBLAS's order (one FMA
// chain over k), as fused_attention.cu does. Simple by intent: no wgmma,
// no TMA, no pipelining.

#include "attention_common.cuh"

namespace {

constexpr int kC = 64;          // channels = head_dim
constexpr int kLd = kC + kPad;  // row of a bf16 64-wide tile in shared memory

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
// bfloat16: tensor-core 16x16x16 MMAs (WMMA), f32 accumulation, 8 warps
// ---------------------------------------------------------------------------

// acc = A[16i:16i+16, 0:64] . W[n0:n0+16, 0:64]^T, A and W (out, in) in
// shared memory with rows of kLd.
__device__ __forceinline__ void tile64(FragC& acc, const bf16* a, const bf16* w) {
  wmma::fill_fragment(acc, 0.f);
#pragma unroll
  for (int k = 0; k < kC; k += 16) {
    FragBCol bw;
    wmma::load_matrix_sync(bw, w + k, kLd);
    FragA fa;
    wmma::load_matrix_sync(fa, a + k, kLd);
    wmma::mma_sync(acc, fa, bw, acc);
  }
}

__global__ void __launch_bounds__(kTcThreads)
    stage1_bf16(const bf16* __restrict__ x, const bf16* __restrict__ kv,
                const bf16* __restrict__ wq, const bf16* __restrict__ bq,
                const bf16* __restrict__ wp, const bf16* __restrict__ bp,
                const bf16* __restrict__ res, bf16* __restrict__ out, int N, int M,
                float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* wqs = reinterpret_cast<bf16*>(smem);  // 64 x kLd: Wq (out, in)
  bf16* wps = wqs + kC * kLd;                 // 64 x kLd: Wp
  bf16* ks = wps + kC * kLd;                  // kMaxM x kLd: K
  bf16* vs = ks + kMaxM * kLd;                // kMaxM x kLd: V
  bf16* xs = vs + kMaxM * kLd;                // 32 x kLd: x, then o
  bf16* qs = xs + kTQ * kLd;                  // 32 x kLd: q
  bf16* ps = qs + kTQ * kLd;                  // 32 x kPLd: p
  float* ss = reinterpret_cast<float*>(ps + kTQ * kPLd);  // 32 x kSLd: logits
  float* bqs = ss + kTQ * kSLd;               // 64: bq in f32
  float* bps = bqs + kC;                      // 64: bp in f32
  const int warp = threadIdx.x / 32;
  float* sc = bps + kC + warp * 256;          // this warp's 16 x 16 scratch

  const int b = blockIdx.y;
  const int mp = (M + 15) / 16 * 16;  // keys padded to the MMA tile
  const bf16* kvb = kv + (size_t)b * M * 2 * kC;
  constexpr int vpr = kC / 8;  // 16-byte vectors per 64-wide row

  // the weights, K and V of this image, once per block; rows M..mp of K
  // and V are zero so padded keys contribute nothing
  for (int i = threadIdx.x; i < kC * vpr; i += kTcThreads) {
    const int r = i / vpr, v = i % vpr;
    *reinterpret_cast<uint4*>(wqs + r * kLd + v * 8) = reinterpret_cast<const uint4*>(wq + r * kC)[v];
    *reinterpret_cast<uint4*>(wps + r * kLd + v * 8) = reinterpret_cast<const uint4*>(wp + r * kC)[v];
  }
  for (int i = threadIdx.x; i < mp * vpr; i += kTcThreads) {
    const int m = i / vpr, v = i % vpr;
    uint4 kval = make_uint4(0, 0, 0, 0), vval = make_uint4(0, 0, 0, 0);
    if (m < M) {
      kval = reinterpret_cast<const uint4*>(kvb + m * 2 * kC)[v];
      vval = reinterpret_cast<const uint4*>(kvb + m * 2 * kC + kC)[v];
    }
    *reinterpret_cast<uint4*>(ks + m * kLd + v * 8) = kval;
    *reinterpret_cast<uint4*>(vs + m * kLd + v * 8) = vval;
  }
  for (int j = threadIdx.x; j < kC; j += kTcThreads) {
    bqs[j] = __bfloat162float(bq[j]);
    bps[j] = __bfloat162float(bp[j]);
  }

  // warp w owns the 16 x 16 tile (rows 16 ri, columns 16 ci) of q, o, out
  const int ri = warp / 4, ci = (warp % 4) * 16;
  const int ntiles = (N + kTQ - 1) / kTQ;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int n0 = tile * kTQ, rows = min(kTQ, N - n0);
    __syncthreads();  // the operands are staged; the last tile read xs
    for (int i = threadIdx.x; i < kTQ * vpr; i += kTcThreads) {
      const int r = i / vpr, v = i % vpr;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (r < rows) val = reinterpret_cast<const uint4*>(x + ((size_t)b * N + n0 + r) * kC)[v];
      *reinterpret_cast<uint4*>(xs + r * kLd + v * 8) = val;
    }
    __syncthreads();

    // q = bf16(x . Wq^T + bq)
    {
      FragC acc;
      tile64(acc, xs + 16 * ri * kLd, wqs + ci * kLd);
      for_each_acc(acc, sc, [&](int r, int c, float v) {
        qs[(16 * ri + r) * kLd + ci + c] = __float2bfloat16(v + bqs[ci + c]);
      });
    }
    __syncthreads();

    // f32 logits q . k^T (K read as a column-major B operand)
    for (int j = warp; j < 2 * (mp / 16); j += kTcWarps) {
      const int i = j % 2, nt = j / 2;
      FragC acc;
      tile64(acc, qs + 16 * i * kLd, ks + nt * 16 * kLd);
      wmma::store_matrix_sync(ss + 16 * i * kSLd + nt * 16, acc, kSLd, wmma::mem_row_major);
    }
    __syncthreads();
    softmax_rows_bf16(ss, ps, kTQ, M, mp, scale);
    __syncthreads();

    // o = bf16(p . v) into xs
    {
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
      for (int k = 0; k < mp; k += 16) {
        FragBRow bv;
        wmma::load_matrix_sync(bv, vs + k * kLd + ci, kLd);
        FragA fa;
        wmma::load_matrix_sync(fa, ps + 16 * ri * kPLd + k, kPLd);
        wmma::mma_sync(acc, fa, bv, acc);
      }
      for_each_acc(acc, sc, [&](int r, int c, float v) {
        xs[(16 * ri + r) * kLd + ci + c] = __float2bfloat16(v);
      });
    }
    __syncthreads();

    // out = bf16(bf16(o . Wp^T + bp) + residual)
    {
      FragC acc;
      tile64(acc, xs + 16 * ri * kLd, wps + ci * kLd);
      for_each_acc(acc, sc, [&](int r, int c, float v) {
        const int row = 16 * ri + r;
        if (row >= rows) return;
        const size_t g = ((size_t)b * N + n0 + row) * kC + ci + c;
        float y = rnd(v + bps[ci + c]);
        if (res != nullptr) y += __bfloat162float(res[g]);
        out[g] = __float2bfloat16(y);
      });
    }
  }
}

constexpr size_t kSmemF32 =
    (2 * (size_t)kC * kWtLd + kC * kKtLd + kMaxM * kC + 2 * kTQ * kC + kTQ * kMaxM) *
    sizeof(float);
constexpr size_t kSmemBf16 =
    (2 * (size_t)kC * kLd + 2 * kMaxM * kLd + 2 * kTQ * kLd + kTQ * kPLd) * sizeof(bf16) +
    ((size_t)kTQ * kSLd + 2 * kC + kTcWarps * 256) * sizeof(float);

template <typename T, typename Kernel>
int launch(Kernel kernel, int threads, size_t smem, int blocks_per_sm, const void* x,
           const void* kv_in, const void* wq, const void* bq, const void* wkv,
           const void* bkv, const void* wp, const void* bp, const void* res,
           void* kv_scratch, void* out, int B, int N, int M, float scale,
           cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;

  const int kv_err = launch_kv_proj<T>(kv_in, wkv, bkv, kv_scratch, B * M, kC, stream);
  if (kv_err != 0) return kv_err;

  // about blocks_per_sm blocks on every SM, each walking several query tiles
  const int ntiles = (N + kTQ - 1) / kTQ;
  const int per_image = max(1, min(ntiles, (blocks_per_sm * sms + B - 1) / B));
  kernel<<<dim3(per_image, B), threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(kv_scratch), static_cast<const T*>(wq),
      static_cast<const T*>(bq), static_cast<const T*>(wp), static_cast<const T*>(bp),
      static_cast<const T*>(res), static_cast<T*>(out), N, M, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. res may be null. Every pointer is a
// contiguous device buffer: x, res and out (B, N, 64); kv_in (B, M, 64);
// wq, wp (64, 64) and wkv (128, 64) as nn.Linear (out, in); kv_scratch
// holds B * M * 128 elements. Requires 1 <= M <= 128 and N >= 1 (the
// wrapper checks). Returns cudaGetLastError() after the launches.
int pf_stage1_attention(int dtype, const void* x, const void* kv_in, const void* wq,
                        const void* bq, const void* wkv, const void* bkv, const void* wp,
                        const void* bp, const void* res, void* kv_scratch, void* out, int B,
                        int N, int M, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M < 1 || M > kMaxM || N < 1 || B < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(stage1_f32, kThreads, kSmemF32, 1, x, kv_in, wq, bq, wkv, bkv, wp,
                         bp, res, kv_scratch, out, B, N, M, scale, st);
  if (dtype == 1)
    return launch<bf16>(stage1_bf16, kTcThreads, kSmemBf16, 2, x, kv_in, wq, bq, wkv, bkv, wp,
                        bp, res, kv_scratch, out, B, N, M, scale, st);
  return (int)cudaErrorInvalidValue;
}

const char* pf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

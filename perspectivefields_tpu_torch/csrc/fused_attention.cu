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
// What bounds it on the H100: latency and bytes, not FLOPs. The per-head
// products are tiny (N <= 1600 queries x M = 100 keys x 64), so an unfused
// chain of batched GEMMs spends its time launching kernels and moving the
// (B, heads, N, M) logits and every projection intermediate through HBM.
// What this design does about it: one block owns 32 query rows of one image
// and keeps everything after the KV projection on chip. The q projection,
// the logits, the softmax, P.V and the out projection (with the residual)
// run out of shared memory, so logits never reach HBM and the q/out
// projections are fused with the attention. Only the small (B, M, 2C) K/V
// projection goes through a scratch tensor, written by a first launch.
//
// bfloat16 (the serving dtype) runs every product on the tensor cores with
// warp-level 16x16x16 MMAs (WMMA), f32 accumulation. float32 runs scalar
// FMAs (the tensor cores' f32 input is TF32, which would not match f32).
// Simple by intent: no wgmma, no TMA, no pipelining; weights are read
// straight from L2. Making it fast is later work. The K/V projection, the
// projection tiles and the softmax are shared with the other attention
// kernels (attention_common.cuh).

#include "attention_common.cuh"

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

__global__ void __launch_bounds__(kTcThreads)
    attn_block_bf16(const bf16* __restrict__ x, const bf16* __restrict__ kv,
                    const bf16* __restrict__ wq, const bf16* __restrict__ bq,
                    const bf16* __restrict__ wp, const bf16* __restrict__ bp,
                    const bf16* __restrict__ res, bf16* __restrict__ out,
                    int N, int M, int C, int heads, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldx = C + kPad;
  bf16* xs = reinterpret_cast<bf16*>(smem);  // 32 x ldx: x, then concat(o_h)
  bf16* qs = xs + kTQ * ldx;                 // 32 x ldx: q
  bf16* ks = qs + kTQ * ldx;                 // kMaxM x kHdLd: K_h
  bf16* vs = ks + kMaxM * kHdLd;             // kMaxM x kHdLd: V_h
  bf16* ps = vs + kMaxM * kHdLd;             // 32 x kPLd: p
  float* ss = reinterpret_cast<float*>(ps + kTQ * kPLd);  // 32 x kSLd logits
  const int warp = threadIdx.x / 32;
  float* sc = ss + kTQ * kSLd + warp * 256;  // this warp's 16 x 16 scratch

  const int b = blockIdx.y, n0 = blockIdx.x * kTQ;
  const int rows = min(kTQ, N - n0);
  const int mp = (M + 15) / 16 * 16;  // keys padded to the MMA tile
  const size_t two_c = 2 * (size_t)C;

  const int vpr = C / 8;  // 16-byte vectors per token row
  for (int i = threadIdx.x; i < kTQ * vpr; i += kTcThreads) {
    const int r = i / vpr, v = i % vpr;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < rows)
      val = reinterpret_cast<const uint4*>(x + ((size_t)b * N + n0 + r) * C)[v];
    *reinterpret_cast<uint4*>(xs + r * ldx + v * 8) = val;
  }
  __syncthreads();

  // q = bf16(x . Wq^T + bq)
  for (int nt = warp; nt < C / 16; nt += kTcWarps) {
    FragC acc[2];
    proj_tiles(acc, xs, ldx, wq, C, C, nt * 16);
    for (int i = 0; i < 2; ++i)
      for_each_acc(acc[i], sc, [&](int r, int c, float v) {
        const int col = nt * 16 + c;
        qs[(16 * i + r) * ldx + col] = __float2bfloat16(v + __bfloat162float(bq[col]));
      });
  }
  __syncthreads();  // q is complete; xs is free for the head outputs

  const bf16* kvb = kv + (size_t)b * M * two_c;
  for (int h = 0; h < heads; ++h) {
    const int hc = h * kHeadDim;
    // K_h, V_h; rows M..mp are zero so padded keys contribute nothing
    for (int i = threadIdx.x; i < mp * (kHeadDim / 8); i += kTcThreads) {
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
    for (int nt = warp; nt < mp / 16; nt += kTcWarps) {
      FragC acc[2];
      wmma::fill_fragment(acc[0], 0.f);
      wmma::fill_fragment(acc[1], 0.f);
#pragma unroll
      for (int k = 0; k < kHeadDim; k += 16) {
        FragBCol bk;
        wmma::load_matrix_sync(bk, ks + nt * 16 * kHdLd + k, kHdLd);
        FragA a0, a1;
        wmma::load_matrix_sync(a0, qs + hc + k, ldx);
        wmma::load_matrix_sync(a1, qs + 16 * ldx + hc + k, ldx);
        wmma::mma_sync(acc[0], a0, bk, acc[0]);
        wmma::mma_sync(acc[1], a1, bk, acc[1]);
      }
      wmma::store_matrix_sync(ss + nt * 16, acc[0], kSLd, wmma::mem_row_major);
      wmma::store_matrix_sync(ss + 16 * kSLd + nt * 16, acc[1], kSLd, wmma::mem_row_major);
    }
    __syncthreads();

    // softmax in f32, one warp per row; p = bf16(softmax), 0 past M
    softmax_rows_bf16(ss, ps, kTQ, M, mp, scale);
    __syncthreads();

    // o_h = bf16(p . v_h): warp w owns rows 16(w/4).. and head columns
    // 16(w%4)..
    {
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
    __syncthreads();  // the next head overwrites ks, vs, ss and ps
  }

  // out = bf16(bf16(o . Wp^T + bp) + residual)
  for (int nt = warp; nt < C / 16; nt += kTcWarps) {
    FragC acc[2];
    proj_tiles(acc, xs, ldx, wp, C, C, nt * 16);
    for (int i = 0; i < 2; ++i)
      for_each_acc(acc[i], sc, [&](int r, int c, float v) {
        const int row = 16 * i + r, col = nt * 16 + c;
        if (row >= rows) return;
        const size_t g = ((size_t)b * N + n0 + row) * C + col;
        float y = rnd(v + __bfloat162float(bp[col]));
        if (res != nullptr) y += __bfloat162float(res[g]);
        out[g] = __float2bfloat16(y);
      });
  }
}

// ---------------------------------------------------------------------------
// launches
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

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. res may be null. Every pointer is a
// contiguous device buffer; kv_scratch holds B * M * 2C elements. Requires
// C = heads * 64 and 1 <= M <= 128 (the wrapper checks), so 2C is a
// multiple of the bf16 KV tile's 128 columns.
// Returns cudaGetLastError() after the launches (0 on success).
int pf_fused_attention(int dtype, const void* x, const void* kv_in,
                       const void* wq, const void* bq, const void* wkv,
                       const void* bkv, const void* wp, const void* bp,
                       const void* res, void* kv_scratch, void* out, int B,
                       int N, int M, int C, int heads, float scale,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const size_t smem =
        (2 * (size_t)kTQ * C + kKT * kWtLd + kHeadDim * kKtLd +
         kMaxM * kHeadDim + kTQ * kMaxM) * sizeof(float);
    return launch<float>(attn_block_f32, kThreads, smem, x, kv_in, wq, bq,
                         wkv, bkv, wp, bp, res, kv_scratch, out, B, N, M, C,
                         heads, scale, st);
  }
  if (dtype == 1) {
    const size_t smem =
        (2 * (size_t)kTQ * (C + kPad) + 2 * kMaxM * kHdLd + kTQ * kPLd) *
            sizeof(bf16) +
        ((size_t)kTQ * kSLd + kTcWarps * 256) * sizeof(float);
    return launch<bf16>(attn_block_bf16, kTcThreads, smem, x, kv_in, wq, bq,
                        wkv, bkv, wp, bp, res, kv_scratch, out, B, N, M, C,
                        heads, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

const char* pf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

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
// Simple by intent: no wgmma, no TMA, no warp specialisation. The tile, its
// index tables and the walk over the hidden chunks are shared with the
// whole-block kernel (mixffn_common.cuh, fused_block.cu).

#include "mixffn_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// float32: scalar FMAs
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreadsF32)
    mixffn_f32(const float* __restrict__ x, const float* __restrict__ w1,
               const float* __restrict__ b1, const float* __restrict__ dwk,
               const float* __restrict__ dwb, const float* __restrict__ w2,
               const float* __restrict__ b2, float* __restrict__ out, int H, int W,
               int C, int th, int tw) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Tile tl(H, W, th, tw);
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

  ffn_chunks_f32(os, xs, hf, gs, ws, b1s, dwbs, tb, tl, w1, b1, dwk, dwb, w2, C);

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

  ffn_chunks_bf16(acc, xs, w1s, w2s, hf, gs, b1s, dwbs, tb, tl, w1, b1, dwk, dwb, w2, C,
                  h_begin, h_end);

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

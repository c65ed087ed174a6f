// Fused SegFormer decoder tail for Hopper (sm_90a), bfloat16 and float32.
//
// Replaces the TPU kernel perspectivefields_tpu/kernels/decoder_tail.py:
// decoder_tail (its pallas_call; body _tail_kernel) and computes its function
// with its casts, for a (B, H, W, Ca) and ll (B, H, W, Cl):
//
//   c0  = T(relu(conv3x3(concat(a, ll), w0) + b0))   f32 accumulation; the
//                                                    zero padding is on the
//                                                    concat
//   u   = T(up2x(c0))                                bilinear, align_corners=
//                                                    False, edge clamp; f32
//   c1  = T(relu(conv3x3(u, w1) + b1))               zero padding on u
//   out = T(c1 . wp^T + bp)                          (B, 2H, 2W, Co)
//
// T is the compute dtype. Weights keep the torch layouts: w0 (64, Ca+Cl, 3,
// 3), w1 (32, 64, 3, 3), wp (Co, 32[, 1, 1]); a first small kernel packs them
// once per call into the GEMM layouts below (tap-major, K rows, N columns).
//
// What bounds it on the H100: the tensor-core work of conv0 (K = 9 x 320 for
// each of the H x W coarse pixels), ~0.1 ms a call at B=8 for Co <= 73; at
// Co = 180 the output's bytes (kernels/roofline.py). Unfused, the concat, the
// conv0 map, its 2x upsample (B, 2H, 2W, 64) and the conv1 map all go through
// HBM. What this design does about it: a block owns an 8 x 8 tile of the
// coarse grid and keeps every intermediate in shared memory. It stages the
// (8+4) x (8+4) input window from a and ll in 32-channel chunks (the concat
// is never formed; outside the image the window is zero), runs conv0 for the
// (8+2) x (8+2) coarse halo, upsamples that into the 18 x 18 fine halo (zero
// outside the image: conv1's padding), runs conv1 on the 16 x 16 fine tile
// and the 1x1 prediction, and writes each fine row of Co channels as one
// contiguous run. HBM sees a and ll once (plus the halo) and out once.
//
// The 3x3 convs are shifted GEMMs over a row-major pixel grid: conv output
// row p = i * Wg + j reads grid row p + dy * Wg + dx for tap (dy, dx), so each
// tap's A operand is the grid itself at a constant offset. Rows whose j falls
// in the last two columns are computed and dropped. bfloat16 runs the GEMMs
// on the tensor cores (WMMA 16x16x16, f32 accumulation; a row pitch of a
// multiple of 16 elements keeps every shifted tile 32-byte aligned), the
// conv0 chunks double-buffered by cp.async; the 1x1 runs on WMMA for Co > 8
// (N padded to 16) and on the CUDA cores otherwise. float32 runs scalar FMAs
// (the tensor cores' f32 input is TF32, which would not match f32). Simple by
// intent: no wgmma, no TMA, no warp specialisation.

#include <cuda_pipeline.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTH = 8, kTW = 8;  // coarse output tile of a block
constexpr int kC0 = 64, kC1 = 32;  // conv0 and conv1 widths (the heads')
constexpr int kMaxCo = 192;
constexpr int kSmallCo = 8;  // bf16: Co <= this runs the 1x1 on the CUDA cores
constexpr int kKC = 32;  // input channels per bf16 conv0 chunk (packed K is padded to it)
constexpr int kKCf = 16;  // input channels per f32 conv0 chunk

// Input window: (kTH + 4) x (kTW + 4) coarse pixels, row-major, then zero
// rows for the shifted reads past its end.
constexpr int kWinW = kTW + 4, kWinH = kTH + 4;
constexpr int kHaloW = kTW + 2, kHaloH = kTH + 2;  // conv0 outputs kept
constexpr int kM0 = ceil16(kHaloH * kWinW);         // conv0 rows: 128
constexpr int kWinRows = kM0 + 2 * kWinW + 2;       // 154
// Fine halo: (2 kTH + 2) x (2 kTW + 2) upsampled pixels, then zero rows.
constexpr int kFW = 2 * kTW + 2, kFH = 2 * kTH + 2;
constexpr int kFTW = 2 * kTW;                       // fine tile width: 16
constexpr int kM1 = 2 * kTH * kFW;                  // conv1 rows: 288
constexpr int kFineRows = kM1 + 2 * kFW + 2;        // 326
constexpr int kNo = 4 * kTH * kTW;                  // fine outputs of a tile: 256

// bf16 row pitches (elements). Shifted WMMA A tiles start at any row, so
// their pitches are multiples of 16 elements (32 bytes).
constexpr int kLdX = kKC + 16;   // 48
constexpr int kLdW0 = kC0 + kPad;
constexpr int kLdC0 = kC0 + kPad;
constexpr int kLdU = kC0 + 16;   // 80
constexpr int kLdW1 = kC1 + kPad;
constexpr int kLdC1 = kC1 + kPad;
// f32 row pitches: odd, so the scalar loops' rows fall on distinct banks
constexpr int kLdXf = kKCf + 1;
constexpr int kLdUf = kC0 + 1;
constexpr int kLdC1f = kC1 + 1;

__host__ __device__ constexpr int ceil32(int n) { return (n + 31) / 32 * 32; }

// The packed weights in the caller's workspace (byte offsets): w0p (9, Kp,
// 64), w1p (9, 64, 32), wpp (32, Cop) in T, then the f32 biases b0 (64), b1
// (32), bp (Cop). Kp = Cin rounded up to kKC, Cop = Co rounded up to 16;
// the padding is zero.
struct Workspace {
  size_t w0p, w1p, wpp, b0f, b1f, bpf, total;
  __host__ __device__ Workspace(size_t es, int cin, int co) {
    const int kp = ceil32(cin), cop = ceil16(co);
    w0p = 0;
    w1p = w0p + align128(9 * (size_t)kp * kC0 * es);
    wpp = w1p + align128(9 * (size_t)kC0 * kC1 * es);
    b0f = wpp + align128((size_t)kC1 * cop * es);
    b1f = b0f + align128(kC0 * 4);
    bpf = b1f + align128(kC1 * 4);
    total = bpf + align128((size_t)cop * 4);
  }
};

template <typename T>
__global__ void __launch_bounds__(256)
    pack_weights(const T* __restrict__ w0, const T* __restrict__ b0, const T* __restrict__ w1,
                 const T* __restrict__ b1, const T* __restrict__ wp, const T* __restrict__ bp,
                 unsigned char* __restrict__ ws, int cin, int co) {
  const Workspace L(sizeof(T), cin, co);
  const int kp = ceil32(cin), cop = ceil16(co);
  T* w0p = reinterpret_cast<T*>(ws + L.w0p);
  T* w1p = reinterpret_cast<T*>(ws + L.w1p);
  T* wpp = reinterpret_cast<T*>(ws + L.wpp);
  float* b0f = reinterpret_cast<float*>(ws + L.b0f);
  float* b1f = reinterpret_cast<float*>(ws + L.b1f);
  float* bpf = reinterpret_cast<float*>(ws + L.bpf);
  const int n0 = 9 * kp * kC0, n1 = 9 * kC0 * kC1, n2 = kC1 * cop;
  const int total = n0 + n1 + n2 + kC0 + kC1 + cop;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total; i += gridDim.x * blockDim.x) {
    int j = i;
    if (j < n0) {  // w0p[t][k][n] = w0[n][k][t]
      const int n = j % kC0, k = (j / kC0) % kp, t = j / (kC0 * kp);
      w0p[j] = k < cin ? w0[((size_t)n * cin + k) * 9 + t] : from_f<T>(0.f);
    } else if ((j -= n0) < n1) {  // w1p[t][k][n] = w1[n][k][t]
      const int n = j % kC1, k = (j / kC1) % kC0, t = j / (kC1 * kC0);
      w1p[j] = w1[(n * kC0 + k) * 9 + t];
    } else if ((j -= n1) < n2) {  // wpp[k][n] = wp[n][k]
      const int n = j % cop, k = j / cop;
      wpp[j] = n < co ? wp[n * kC1 + k] : from_f<T>(0.f);
    } else if ((j -= n2) < kC0) {
      b0f[j] = to_f(b0[j]);
    } else if ((j -= kC0) < kC1) {
      b1f[j] = to_f(b1[j]);
    } else {
      j -= kC1;
      bpf[j] = j < co ? to_f(bp[j]) : 0.f;
    }
  }
}

// Tile geometry: image b, coarse origin (y0, x0).
struct TailTile {
  int b, y0, x0;
  __device__ TailTile(int W) {
    const int tiles_w = (W + kTW - 1) / kTW;
    b = blockIdx.y;
    y0 = (blockIdx.x / tiles_w) * kTH;
    x0 = (blockIdx.x % tiles_w) * kTW;
  }
};

// Source rows of the 2x bilinear upsample at fine index f (align_corners=
// False, as F.interpolate computes them): lo, hi = min(lo + 1, n - 1), and
// the weight of hi.
__device__ __forceinline__ void up_index(int f, int n, int& lo, int& hi, float& w) {
  const float src = fmaxf((f + 0.5f) * 0.5f - 0.5f, 0.f);
  lo = (int)src;
  hi = min(lo + 1, n - 1);
  w = src - (float)lo;
}

// The fine halo (kFH x kFW pixels, then zero rows) from the coarse halo c0s
// (kHaloH x kHaloW pixels at ldc0): bilinear with the edge clamp inside the
// image, zero outside it.
template <typename T, int kPairs>
__device__ __forceinline__ void upsample(T* us, int ldu, const T* c0s, int ldc0,
                                         const TailTile& tl, int H, int W) {
  for (int i = threadIdx.x; i < kFineRows * kPairs; i += kThreads) {
    const int r = i / kPairs, c = (i % kPairs) * 2;
    float v0 = 0.f, v1 = 0.f;
    const int fy = 2 * tl.y0 - 1 + r / kFW, fx = 2 * tl.x0 - 1 + r % kFW;
    if (r < kFH * kFW && fy >= 0 && fy < 2 * H && fx >= 0 && fx < 2 * W) {
      int ylo, yhi, xlo, xhi;
      float wy, wx;
      up_index(fy, H, ylo, yhi, wy);
      up_index(fx, W, xlo, xhi, wx);
      // coarse pixel (y, x) is halo pixel (y - y0 + 1, x - x0 + 1)
      const int r0 = (ylo - tl.y0 + 1) * kHaloW, r1 = (yhi - tl.y0 + 1) * kHaloW;
      const int q0 = xlo - tl.x0 + 1, q1 = xhi - tl.x0 + 1;
      const T* p00 = c0s + (r0 + q0) * ldc0 + c;
      const T* p01 = c0s + (r0 + q1) * ldc0 + c;
      const T* p10 = c0s + (r1 + q0) * ldc0 + c;
      const T* p11 = c0s + (r1 + q1) * ldc0 + c;
      const float ay = 1.f - wy, ax = 1.f - wx;
      v0 = ay * (ax * to_f(p00[0]) + wx * to_f(p01[0])) + wy * (ax * to_f(p10[0]) + wx * to_f(p11[0]));
      v1 = ay * (ax * to_f(p00[1]) + wx * to_f(p01[1])) + wy * (ax * to_f(p10[1]) + wx * to_f(p11[1]));
    }
    us[r * ldu + c] = from_f<T>(v0);
    us[r * ldu + c + 1] = from_f<T>(v1);
  }
}

// The 1x1 on the CUDA cores: out[px][co] = T(c1s[px] . wps[:, co] + bps[co])
// for the tile's fine pixels inside the image.
template <typename T>
__device__ __forceinline__ void pred_scalar(T* __restrict__ out, const T* c1s, int ldc1,
                                            const T* wps, int ldp, const float* bps,
                                            const TailTile& tl, int H, int W, int Co) {
  for (int e = threadIdx.x; e < kNo * Co; e += kThreads) {
    const int px = e / Co, co = e % Co;
    const int fy = 2 * tl.y0 + px / kFTW, fx = 2 * tl.x0 + px % kFTW;
    if (fy < 2 * H && fx < 2 * W) {
      float acc = 0.f;
#pragma unroll 8
      for (int k = 0; k < kC1; ++k) acc = fmaf(to_f(c1s[px * ldc1 + k]), to_f(wps[k * ldp + co]), acc);
      out[(((size_t)tl.b * 2 * H + fy) * 2 * W + fx) * Co + co] = from_f<T>(acc + bps[co]);
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor-core 16x16x16 MMAs (WMMA), f32 accumulation
// ---------------------------------------------------------------------------

// Shared memory of the bf16 kernel (byte offsets). Region 1 holds the two
// conv0 chunk buffers, then c0s + w1s + wps, then the 1x1's row buffers
// (over c0s and w1s); region 2 the fine halo, then c1s; region 3 the
// per-warp accumulator scratch and the f32 biases.
struct SmemBf16 {
  size_t xs[2], w0s[2], c0s, w1s, wps, rows, us, c1s, scratch, b0s, b1s, bps, total;
  __host__ __device__ SmemBf16(int co) {
    const int cop = ceil16(co);
    const size_t xs_b = align128((size_t)kWinRows * kLdX * 2);
    const size_t w0s_b = align128((size_t)9 * kKC * kLdW0 * 2);
    xs[0] = 0;
    w0s[0] = xs_b;
    xs[1] = xs_b + w0s_b;
    w0s[1] = 2 * xs_b + w0s_b;
    c0s = 0;
    w1s = align128((size_t)kHaloH * kHaloW * kLdC0 * 2);
    wps = w1s + align128((size_t)9 * kC0 * kLdW1 * 2);
    rows = 0;  // kWarps x 16 x Co: at most wps's offset for Co <= kMaxCo
    size_t r1 = 2 * (xs_b + w0s_b);
    const size_t wps_end = wps + align128((size_t)kC1 * (cop + kPad) * 2);
    if (wps_end > r1) r1 = wps_end;
    us = r1;
    c1s = us;
    scratch = us + align128((size_t)kFineRows * kLdU * 2);
    b0s = scratch + (size_t)kWarps * 256 * 4;
    b1s = b0s + align128(kC0 * 4);
    bps = b1s + align128(kC1 * 4);
    total = bps + align128((size_t)cop * 4);
  }
};

// Stage conv0's chunk kc: the input window's channels [kc * kKC, +kKC) from
// a and ll (zero outside the image and past Ca + Cl), and those K rows of
// the packed w0 for all 9 taps; cp.async, 16 bytes a copy.
__device__ __forceinline__ void stage_chunk_bf16(bf16* xs, bf16* w0s, const bf16* __restrict__ a,
                                                 const bf16* __restrict__ ll,
                                                 const bf16* __restrict__ w0p, int kc,
                                                 const TailTile& tl, int H, int W, int Ca,
                                                 int Cl, int kp) {
  constexpr int kVec = kKC / 8;
  for (int i = threadIdx.x; i < kWinRows * kVec; i += kThreads) {
    const int r = i / kVec, c = kc * kKC + (i % kVec) * 8;
    const int y = tl.y0 - 2 + r / kWinW, x = tl.x0 - 2 + r % kWinW;
    bf16* dst = xs + r * kLdX + (i % kVec) * 8;
    if (r < kWinH * kWinW && c < Ca + Cl && y >= 0 && y < H && x >= 0 && x < W) {
      const size_t pix = ((size_t)tl.b * H + y) * W + x;
      __pipeline_memcpy_async(dst, c < Ca ? a + pix * Ca + c : ll + pix * Cl + (c - Ca), 16);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  }
  constexpr int kWVec = kC0 / 8;
  for (int i = threadIdx.x; i < 9 * kKC * kWVec; i += kThreads) {
    const int row = i / kWVec, v = (i % kWVec) * 8;  // row = tap * kKC + k
    const int t = row / kKC, k = row % kKC;
    __pipeline_memcpy_async(w0s + row * kLdW0 + v, w0p + ((size_t)t * kp + kc * kKC + k) * kC0 + v,
                            16);
  }
}

__global__ void __launch_bounds__(kThreads)
    tail_bf16(const bf16* __restrict__ a, const bf16* __restrict__ ll,
              const unsigned char* __restrict__ ws, bf16* __restrict__ out, int H, int W, int Ca,
              int Cl, int Co) {
  extern __shared__ __align__(128) unsigned char smem[];
  const SmemBf16 S(Co);
  const Workspace L(2, Ca + Cl, Co);
  const int kp = ceil32(Ca + Cl), cop = ceil16(Co), ldp = cop + kPad;
  const bf16* w0p = reinterpret_cast<const bf16*>(ws + L.w0p);
  const bf16* w1p = reinterpret_cast<const bf16*>(ws + L.w1p);
  const bf16* wpp = reinterpret_cast<const bf16*>(ws + L.wpp);
  bf16* c0s = reinterpret_cast<bf16*>(smem + S.c0s);
  bf16* w1s = reinterpret_cast<bf16*>(smem + S.w1s);
  bf16* wps = reinterpret_cast<bf16*>(smem + S.wps);
  bf16* us = reinterpret_cast<bf16*>(smem + S.us);
  bf16* c1s = reinterpret_cast<bf16*>(smem + S.c1s);
  float* b0s = reinterpret_cast<float*>(smem + S.b0s);
  float* b1s = reinterpret_cast<float*>(smem + S.b1s);
  float* bps = reinterpret_cast<float*>(smem + S.bps);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* sc = reinterpret_cast<float*>(smem + S.scratch) + warp * 256;
  const TailTile tl(W);

  for (int i = threadIdx.x; i < kC0; i += kThreads)
    b0s[i] = reinterpret_cast<const float*>(ws + L.b0f)[i];
  for (int i = threadIdx.x; i < kC1; i += kThreads)
    b1s[i] = reinterpret_cast<const float*>(ws + L.b1f)[i];
  for (int i = threadIdx.x; i < cop; i += kThreads)
    bps[i] = reinterpret_cast<const float*>(ws + L.bpf)[i];

  // conv0: warp w owns conv0 rows [16w, 16w + 16) and all 64 channels
  FragC acc0[kC0 / 16];
#pragma unroll
  for (int n = 0; n < kC0 / 16; ++n) wmma::fill_fragment(acc0[n], 0.f);
  const int nchunks = kp / kKC;
  stage_chunk_bf16(reinterpret_cast<bf16*>(smem + S.xs[0]), reinterpret_cast<bf16*>(smem + S.w0s[0]),
                   a, ll, w0p, 0, tl, H, W, Ca, Cl, kp);
  __pipeline_commit();
  for (int kc = 0; kc < nchunks; ++kc) {
    if (kc + 1 < nchunks) {
      const int nb = (kc + 1) & 1;
      stage_chunk_bf16(reinterpret_cast<bf16*>(smem + S.xs[nb]),
                       reinterpret_cast<bf16*>(smem + S.w0s[nb]), a, ll, w0p, kc + 1, tl, H, W,
                       Ca, Cl, kp);
    }
    __pipeline_commit();
    __pipeline_wait_prior(1);
    __syncthreads();
    const bf16* xs = reinterpret_cast<const bf16*>(smem + S.xs[kc & 1]);
    const bf16* w0s = reinterpret_cast<const bf16*>(smem + S.w0s[kc & 1]);
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const int s = (t / 3) * kWinW + t % 3;
#pragma unroll
      for (int ks = 0; ks < kKC / 16; ++ks) {
        FragA fa;
        wmma::load_matrix_sync(fa, xs + (warp * 16 + s) * kLdX + ks * 16, kLdX);
#pragma unroll
        for (int n = 0; n < kC0 / 16; ++n) {
          FragBRow fb;
          wmma::load_matrix_sync(fb, w0s + (t * kKC + ks * 16) * kLdW0 + n * 16, kLdW0);
          wmma::mma_sync(acc0[n], fa, fb, acc0[n]);
        }
      }
    }
    __syncthreads();
  }

  // the conv0 buffers are free: fetch w1 and the 1x1 weights meanwhile
  for (int i = threadIdx.x; i < 9 * kC0 * (kC1 / 8); i += kThreads) {
    const int row = i / (kC1 / 8), v = (i % (kC1 / 8)) * 8;
    __pipeline_memcpy_async(w1s + row * kLdW1 + v, w1p + row * kC1 + v, 16);
  }
  for (int i = threadIdx.x; i < kC1 * (cop / 8); i += kThreads) {
    const int row = i / (cop / 8), v = (i % (cop / 8)) * 8;
    __pipeline_memcpy_async(wps + row * ldp + v, wpp + row * cop + v, 16);
  }
  __pipeline_commit();

  // c0 = T(relu(acc + b0)) for the halo pixels (conv0 row i * kWinW + j)
#pragma unroll
  for (int n = 0; n < kC0 / 16; ++n)
    for_each_acc(acc0[n], sc, [&](int r, int c, float v) {
      const int p = warp * 16 + r, i = p / kWinW, j = p % kWinW;
      if (i < kHaloH && j < kHaloW)
        c0s[(i * kHaloW + j) * kLdC0 + n * 16 + c] = __float2bfloat16(fmaxf(v + b0s[n * 16 + c], 0.f));
    });
  __syncthreads();
  upsample<bf16, kC0 / 2>(us, kLdU, c0s, kLdC0, tl, H, W);
  __pipeline_wait_prior(0);
  __syncthreads();

  // conv1: warp w owns conv1 row tiles w, w + 8, w + 16 (of 18), both
  // 16-channel halves
  constexpr int kMT1 = kM1 / 16, kPerWarp = (kMT1 + kWarps - 1) / kWarps;
  FragC acc1[kPerWarp][kC1 / 16];
#pragma unroll
  for (int m = 0; m < kPerWarp; ++m)
#pragma unroll
    for (int n = 0; n < kC1 / 16; ++n) wmma::fill_fragment(acc1[m][n], 0.f);
#pragma unroll 1
  for (int t = 0; t < 9; ++t) {
    const int s = (t / 3) * kFW + t % 3;
#pragma unroll
    for (int ks = 0; ks < kC0 / 16; ++ks) {
      FragBRow fb[kC1 / 16];
#pragma unroll
      for (int n = 0; n < kC1 / 16; ++n)
        wmma::load_matrix_sync(fb[n], w1s + (t * kC0 + ks * 16) * kLdW1 + n * 16, kLdW1);
#pragma unroll
      for (int m = 0; m < kPerWarp; ++m) {
        const int mt = warp + m * kWarps;
        if (mt < kMT1) {
          FragA fa;
          wmma::load_matrix_sync(fa, us + (mt * 16 + s) * kLdU + ks * 16, kLdU);
#pragma unroll
          for (int n = 0; n < kC1 / 16; ++n) wmma::mma_sync(acc1[m][n], fa, fb[n], acc1[m][n]);
        }
      }
    }
  }
  __syncthreads();  // c1s overwrites the fine halo

  // c1 = T(relu(acc + b1)) for the fine tile (conv1 row i * kFW + j, j < 16)
#pragma unroll
  for (int m = 0; m < kPerWarp; ++m) {
    const int mt = warp + m * kWarps;
    if (mt < kMT1) {
#pragma unroll
      for (int n = 0; n < kC1 / 16; ++n)
        for_each_acc(acc1[m][n], sc, [&](int r, int c, float v) {
          const int q = mt * 16 + r, i = q / kFW, j = q % kFW;
          if (j < kFTW)
            c1s[(i * kFTW + j) * kLdC1 + n * 16 + c] =
                __float2bfloat16(fmaxf(v + b1s[n * 16 + c], 0.f));
        });
    }
  }
  __syncthreads();

  if (Co <= kSmallCo) {
    pred_scalar(out, c1s, kLdC1, wps, ldp, bps, tl, H, W, Co);
    return;
  }
  // 1x1 on WMMA: warp w owns fine rows w and w + 8 (16 pixels each); a row's
  // Co-channel outputs gather in the warp's row buffer, then go out as one
  // contiguous run
  bf16* rb = reinterpret_cast<bf16*>(smem + S.rows) + warp * 16 * Co;
  const int npx = min(kFTW, 2 * W - 2 * tl.x0);
  for (int i = warp; i < 2 * kTH; i += kWarps) {
    const int fy = 2 * tl.y0 + i;
    for (int n = 0; n < cop / 16; ++n) {
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int ks = 0; ks < kC1 / 16; ++ks) {
        FragA fa;
        FragBRow fb;
        wmma::load_matrix_sync(fa, c1s + i * 16 * kLdC1 + ks * 16, kLdC1);
        wmma::load_matrix_sync(fb, wps + ks * 16 * ldp + n * 16, ldp);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      for_each_acc(acc, sc, [&](int r, int c, float v) {
        const int co = n * 16 + c;
        if (co < Co) rb[r * Co + co] = __float2bfloat16(v + bps[co]);
      });
    }
    if (fy < 2 * H) {
      bf16* dst = out + (((size_t)tl.b * 2 * H + fy) * 2 * W + 2 * tl.x0) * Co;
      for (int e = lane; e < npx * Co; e += 32) dst[e] = rb[e];
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// float32: scalar FMAs
// ---------------------------------------------------------------------------

// Shared memory of the f32 kernel (byte offsets): region 1 holds one conv0
// chunk, then c0s, then w1s, then wps; region 2 the fine halo, then c1s;
// region 3 the biases.
struct SmemF32 {
  size_t xs, w0s, c0s, w1s, wps, us, c1s, b0s, b1s, bps, total;
  __host__ __device__ SmemF32(int co) {
    xs = 0;
    w0s = align128((size_t)kWinRows * kLdXf * 4);
    c0s = w1s = wps = 0;
    size_t r1 = w0s + align128((size_t)9 * kKCf * kC0 * 4);
    const size_t sizes[3] = {align128((size_t)kHaloH * kHaloW * kC0 * 4),
                             align128((size_t)9 * kC0 * kC1 * 4), align128((size_t)kC1 * co * 4)};
    for (size_t s : sizes) r1 = s > r1 ? s : r1;
    us = c1s = r1;
    b0s = us + align128((size_t)kFineRows * kLdUf * 4);
    b1s = b0s + align128(kC0 * 4);
    bps = b1s + align128(kC1 * 4);
    total = bps + align128((size_t)co * 4);
  }
};

__global__ void __launch_bounds__(kThreads)
    tail_f32(const float* __restrict__ a, const float* __restrict__ ll,
             const unsigned char* __restrict__ ws, float* __restrict__ out, int H, int W, int Ca,
             int Cl, int Co) {
  extern __shared__ __align__(128) unsigned char smem[];
  const SmemF32 S(Co);
  const Workspace L(4, Ca + Cl, Co);
  const int cin = Ca + Cl, kp = ceil32(cin), cop = ceil16(Co);
  const float* w0p = reinterpret_cast<const float*>(ws + L.w0p);
  const float* w1p = reinterpret_cast<const float*>(ws + L.w1p);
  const float* wpp = reinterpret_cast<const float*>(ws + L.wpp);
  float* xs = reinterpret_cast<float*>(smem + S.xs);
  float* w0s = reinterpret_cast<float*>(smem + S.w0s);
  float* c0s = reinterpret_cast<float*>(smem + S.c0s);
  float* w1s = reinterpret_cast<float*>(smem + S.w1s);
  float* wps = reinterpret_cast<float*>(smem + S.wps);
  float* us = reinterpret_cast<float*>(smem + S.us);
  float* c1s = reinterpret_cast<float*>(smem + S.c1s);
  float* b0s = reinterpret_cast<float*>(smem + S.b0s);
  float* b1s = reinterpret_cast<float*>(smem + S.b1s);
  float* bps = reinterpret_cast<float*>(smem + S.bps);
  const TailTile tl(W);

  for (int i = threadIdx.x; i < kC0; i += kThreads)
    b0s[i] = reinterpret_cast<const float*>(ws + L.b0f)[i];
  for (int i = threadIdx.x; i < kC1; i += kThreads)
    b1s[i] = reinterpret_cast<const float*>(ws + L.b1f)[i];
  for (int i = threadIdx.x; i < Co; i += kThreads)
    bps[i] = reinterpret_cast<const float*>(ws + L.bpf)[i];

  // conv0: thread owns 4 channels (cg) of up to 7 halo pixels (pg + 16u)
  constexpr int kPx0 = (kHaloH * kHaloW + 15) / 16;
  const int cg = threadIdx.x % 16, pg = threadIdx.x / 16;
  int prow[kPx0];
#pragma unroll
  for (int u = 0; u < kPx0; ++u) {
    const int h = min(pg + 16 * u, kHaloH * kHaloW - 1);
    prow[u] = (h / kHaloW) * kWinW + h % kHaloW;
  }
  float acc0[kPx0][4] = {};
  for (int kc = 0; kc < kp / kKCf; ++kc) {
    for (int i = threadIdx.x; i < kWinRows * kKCf; i += kThreads) {
      const int r = i / kKCf, k = i % kKCf, c = kc * kKCf + k;
      const int y = tl.y0 - 2 + r / kWinW, x = tl.x0 - 2 + r % kWinW;
      float v = 0.f;
      if (r < kWinH * kWinW && c < cin && y >= 0 && y < H && x >= 0 && x < W) {
        const size_t pix = ((size_t)tl.b * H + y) * W + x;
        v = c < Ca ? a[pix * Ca + c] : ll[pix * Cl + (c - Ca)];
      }
      xs[r * kLdXf + k] = v;
    }
    for (int i = threadIdx.x; i < 9 * kKCf * kC0; i += kThreads) {
      const int n = i % kC0, k = (i / kC0) % kKCf, t = i / (kC0 * kKCf);
      w0s[i] = w0p[((size_t)t * kp + kc * kKCf + k) * kC0 + n];
    }
    __syncthreads();
#pragma unroll 1
    for (int t = 0; t < 9; ++t) {
      const int s = (t / 3) * kWinW + t % 3;
#pragma unroll 4
      for (int k = 0; k < kKCf; ++k) {
        const float4 w = *reinterpret_cast<const float4*>(w0s + (t * kKCf + k) * kC0 + cg * 4);
#pragma unroll
        for (int u = 0; u < kPx0; ++u) {
          const float x = xs[(prow[u] + s) * kLdXf + k];
          acc0[u][0] = fmaf(x, w.x, acc0[u][0]);
          acc0[u][1] = fmaf(x, w.y, acc0[u][1]);
          acc0[u][2] = fmaf(x, w.z, acc0[u][2]);
          acc0[u][3] = fmaf(x, w.w, acc0[u][3]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int u = 0; u < kPx0; ++u) {
    const int h = pg + 16 * u;
    if (h < kHaloH * kHaloW)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        c0s[h * kC0 + cg * 4 + q] = fmaxf(acc0[u][q] + b0s[cg * 4 + q], 0.f);
  }
  __syncthreads();
  upsample<float, kC0 / 2>(us, kLdUf, c0s, kC0, tl, H, W);
  __syncthreads();
  for (int i = threadIdx.x; i < 9 * kC0 * kC1; i += kThreads) w1s[i] = w1p[i];
  __syncthreads();

  // conv1: thread owns 4 channels (cg1) of 8 fine pixels (pg1 + 32u)
  constexpr int kPx1 = kNo / 32;
  const int cg1 = threadIdx.x % 8, pg1 = threadIdx.x / 8;
  int qrow[kPx1];
#pragma unroll
  for (int u = 0; u < kPx1; ++u) {
    const int px = pg1 + 32 * u;
    qrow[u] = (px / kFTW) * kFW + px % kFTW;
  }
  float acc1[kPx1][4] = {};
#pragma unroll 1
  for (int t = 0; t < 9; ++t) {
    const int s = (t / 3) * kFW + t % 3;
#pragma unroll 4
    for (int k = 0; k < kC0; ++k) {
      const float4 w = *reinterpret_cast<const float4*>(w1s + (t * kC0 + k) * kC1 + cg1 * 4);
#pragma unroll
      for (int u = 0; u < kPx1; ++u) {
        const float x = us[(qrow[u] + s) * kLdUf + k];
        acc1[u][0] = fmaf(x, w.x, acc1[u][0]);
        acc1[u][1] = fmaf(x, w.y, acc1[u][1]);
        acc1[u][2] = fmaf(x, w.z, acc1[u][2]);
        acc1[u][3] = fmaf(x, w.w, acc1[u][3]);
      }
    }
  }
  __syncthreads();  // c1s overwrites the fine halo, wps w1s
#pragma unroll
  for (int u = 0; u < kPx1; ++u)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      c1s[(pg1 + 32 * u) * kLdC1f + cg1 * 4 + q] = fmaxf(acc1[u][q] + b1s[cg1 * 4 + q], 0.f);
  for (int i = threadIdx.x; i < kC1 * Co; i += kThreads) wps[i] = wpp[(i / Co) * cop + i % Co];
  __syncthreads();
  pred_scalar(out, c1s, kLdC1f, wps, Co, bps, tl, H, W, Co);
}

int set_smem(const void* kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

}  // namespace

extern "C" {

// Bytes of the workspace pf_decoder_tail needs (dtype 0 = float32, 1 =
// bfloat16) for Cin = Ca + Cl input channels and Co outputs.
int pf_decoder_tail_workspace_bytes(int dtype, int cin, int co) {
  return (int)Workspace(dtype == 0 ? 4 : 2, cin, co).total;
}

// dtype: 0 = float32, 1 = bfloat16. Every pointer is a contiguous device
// buffer of that dtype: a (B, H, W, Ca), ll (B, H, W, Cl); w0 (64, Ca+Cl, 3,
// 3), b0 (64); w1 (32, 64, 3, 3), b1 (32); wp (Co, 32), bp (Co); out (B, 2H,
// 2W, Co); ws the workspace (pf_decoder_tail_workspace_bytes, 128-byte
// aligned). a and ll are 16-byte aligned, Ca % 8 == Cl % 8 == 0, 1 <= Co <=
// 192. Returns cudaGetLastError() after the launches (0 on success).
int pf_decoder_tail(int dtype, const void* a, const void* ll, const void* w0, const void* b0,
                    const void* w1, const void* b1, const void* wp, const void* bp, void* out,
                    void* ws, int B, int H, int W, int Ca, int Cl, int Co, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((dtype != 0 && dtype != 1) || B < 1 || H < 1 || W < 1 || Ca < 8 || Cl < 8 || Ca % 8 != 0 ||
      Cl % 8 != 0 || Co < 1 || Co > kMaxCo)
    return (int)cudaErrorInvalidValue;
  const int cin = Ca + Cl;
  const int n_pack = 9 * ceil32(cin) * kC0 + 9 * kC0 * kC1 + kC1 * ceil16(Co) + kC0 + kC1 + ceil16(Co);
  const int pack_blocks = (n_pack + 255) / 256;
  auto* wsb = static_cast<unsigned char*>(ws);
  const dim3 grid(((H + kTH - 1) / kTH) * ((W + kTW - 1) / kTW), B);
  if (dtype == 0) {
    pack_weights<float><<<pack_blocks, 256, 0, st>>>(
        static_cast<const float*>(w0), static_cast<const float*>(b0), static_cast<const float*>(w1),
        static_cast<const float*>(b1), static_cast<const float*>(wp), static_cast<const float*>(bp),
        wsb, cin, Co);
    int err = (int)cudaGetLastError();
    if (err != 0) return err;
    const size_t smem = SmemF32(Co).total;
    err = set_smem((const void*)tail_f32, smem);
    if (err != 0) return err;
    tail_f32<<<grid, kThreads, smem, st>>>(static_cast<const float*>(a),
                                           static_cast<const float*>(ll), wsb,
                                           static_cast<float*>(out), H, W, Ca, Cl, Co);
    return (int)cudaGetLastError();
  }
  pack_weights<bf16><<<pack_blocks, 256, 0, st>>>(
      static_cast<const bf16*>(w0), static_cast<const bf16*>(b0), static_cast<const bf16*>(w1),
      static_cast<const bf16*>(b1), static_cast<const bf16*>(wp), static_cast<const bf16*>(bp), wsb,
      cin, Co);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const size_t smem = SmemBf16(Co).total;
  err = set_smem((const void*)tail_bf16, smem);
  if (err != 0) return err;
  tail_bf16<<<grid, kThreads, smem, st>>>(static_cast<const bf16*>(a),
                                          static_cast<const bf16*>(ll), wsb,
                                          static_cast<bf16*>(out), H, W, Ca, Cl, Co);
  return (int)cudaGetLastError();
}

const char* pf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

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
// once per call into the layouts below (~0.4 MB at the heads' widths).
//
// What bounds it on the H100 (kernels/roofline.py): the tensor-core work of
// conv0 (K = 9 x 320 for each of the H x W coarse pixels) and conv1 (K = 9 x
// 64 for each of the 2H x 2W fine pixels), ~0.107 ms a call at B=8 on the
// 160 x 160 grid for Co <= 73; at Co = 180 the output's bytes. Unfused, the
// concat, the conv0 map, its 2x upsample (B, 2H, 2W, 64) and the conv1 map
// all go through HBM.
//
// The WMMA version of this kernel (8 x 8 coarse tiles, one per block) ran
// at ~17x its bound: conv0's row-shift GEMM computed 128 rows for 64
// outputs (half its tensor-core work was halo), all 3,200 blocks of a call
// re-read the whole packed w0 from L2 (~1.2 GB), each of 8 warps reloaded
// every B fragment from shared memory, and the upsample, conv1 and the 1x1
// ran after conv0 with nothing to overlap them.
//
// bfloat16, this design (hopper_gemm.cuh; kernels/decoder_tail.py: plan
// counts the tile, cluster, waves and L2 weight bytes): persistent blocks of
// two consumer warpgroups and one producer warp (the producer warpgroup's
// other three warps wait at the cluster barrier). A block walks coarse tiles
// of TH x TW outputs ((TH+2)(TW+2) <= 128 halo pixels: 8 x 10 at the heads'
// 160 x 160 grid, 1.5x halo on conv0 instead of 2x). Per tile:
//   1. conv0 as an implicit GEMM on wgmma: M = the halo's pixels (each
//      warpgroup 64), N = 64, K = 9 taps x the input channels. The producer
//      streams, per 32-channel k-block, the (TH+4) x (TW+4) input window by
//      TMA from a's or ll's own tensor map (the concat is never formed;
//      TMA's zero fill past the image is conv0's padding) and w0's 9 tap
//      tiles, multicast over a cluster of neighbouring tiles so L2 serves w0
//      once per cluster. A is read into registers at each tap's row shift
//      and gathered per halo pixel (ldmatrix; a wgmma descriptor cannot start
//      at a shifted row of a swizzled operand), so no GEMM row is wasted on
//      the window's edge columns; a k-block's 18 MMAs run in two groups,
//      the second's A loaded while the first runs, and its stage is
//      released as soon as they are done;
//   2. c0 = T(relu(. + b0)) into shared memory; the upsample into the fine
//      halo u (swizzled; zero outside the image: conv1's padding), each
//      thread 8 channels of a 2 x 2 block of fine pixels (they share their
//      four coarse pixels), the source rows, columns and weights from
//      per-tile tables;
//   3. conv1 on wgmma (m64n32, A gathered from u at each tap's shift in
//      three 3-tap chunks over two register sets, so a chunk's loads overlap
//      the last one's MMAs; w1 resident in shared memory), 64 fine outputs
//      at a time, the two warpgroups alternating groups; c1 = T(relu(. +
//      b1)) stays in registers as the 1x1's A operand (m64n64 per 64 columns
//      of Co, wp resident); out = T(. + bp) straight to HBM.
// The ring holds two k-blocks, so the next tile's first window chunks and
// w0 tiles arrive while this tile runs steps 2-3. w1, wp and the biases are
// loaded once per block. No branch that depends on the lane reads an
// accumulator or surrounds an MMA: ptxas then serialises every wgmma of the
// kernel (C7518), and two register sets of conv0's A (144 registers) made
// it do so for want of registers (C7511).
//
// What bounds it now (PERF.md; chip_smoke.py --phases, the PF_STAMP clock64
// counts of one block): the SM's own pipeline, not L2. A tile takes ~38k
// cycles: conv0 ~17-21k (36 MMAs a k-block on both warpgroups, whose
// ldmatrix A loads and wgmma B reads share the shared-memory bandwidth: ~1.8k
// cycles a k-block against ~1.15k of tensor-core time), the upsample ~7-8k
// (CUDA cores, the tensor cores idle), conv1 and the 1x1 8-12k (5 m64 groups
// split 3 / 2). Clusters of 1 to 8 run at the same time per tile at equal
// waves, so w0's L2 traffic is not the limit. Next: overlap the upsample and
// conv1 of one tile with the next tile's conv0 (a warpgroup each), a 2x2
// fine block per upsample thread (four outputs share four coarse pixels).
//
// float32 runs scalar FMAs (the tensor cores' f32 input is TF32, which would
// not match f32) on 8 x 8 coarse tiles, one per block: the input window in
// 16-channel chunks, conv0 on the (8+2) x (8+2) halo and conv1 as shifted-row
// GEMMs over a row-major pixel grid, the upsample into an 18 x 18 fine halo,
// the 1x1 on the CUDA cores. Simple by intent.

#include "hopper_gemm.cuh"

namespace {

constexpr int kThreads = 256;  // float32: 8 warps
constexpr int kTH = 8, kTW = 8;  // float32: coarse output tile of a block
constexpr int kC0 = 64, kC1 = 32;  // conv0 and conv1 widths (the heads')
constexpr int kMaxCo = 192;
constexpr int kKCf = 16;  // input channels per f32 conv0 chunk

// float32's input window: (kTH + 4) x (kTW + 4) coarse pixels, row-major,
// then zero rows for the shifted reads past its end.
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

// f32 row pitches: odd, so the scalar loops' rows fall on distinct banks
constexpr int kLdXf = kKCf + 1;
constexpr int kLdUf = kC0 + 1;
constexpr int kLdC1f = kC1 + 1;

__host__ __device__ constexpr int ceil32(int n) { return (n + 31) / 32 * 32; }

// float32's packed weights in the caller's workspace (byte offsets): w0p (9, Kp,
// 64), w1p (9, 64, 32), wpp (32, Cop) in T, then the f32 biases b0 (64), b1
// (32), bp (Cop). Kp = Cin rounded up to 32, Cop = Co rounded up to 16;
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
// bfloat16: wgmma, a TMA ring multicast over a cluster, persistent blocks
// (hopper_gemm.cuh)
// ---------------------------------------------------------------------------

constexpr int kC0Ld = kC0 + 8;          // row of the coarse halo c0: conflict-free stores
constexpr int kMaxHalo = 128;           // halo pixels a tile may have: one m64 group a warpgroup
constexpr int kMaxFine = 384;           // fine outputs a tile may have: six m64 groups of conv1
constexpr int kMaxStagesT = 6;
constexpr int kMaxSide = 96;            // fine-halo rows or columns a tile may have: 2 * 40 + 2
constexpr int kW0Tile = kC0 * kKb * 2;  // one tap's 64 x 32 tile of w0 (bytes)
constexpr int kW0Stage = 9 * kW0Tile;   // w0's 9 taps of one k-block
constexpr int kW1Bytes = 9 * kC1 * kC0 * 2;

__host__ __device__ constexpr size_t align1024(size_t n) { return (n + 1023) / 1024 * 1024; }
__host__ __device__ constexpr int ceil64(int n) { return (n + 63) / 64 * 64; }

// The packed bf16 weights in the caller's workspace (byte offsets): w0p (9
// x 64 rows, Kp columns: tap-major, then the output channel; columns are
// the input channels, a's, then ll's from Ca, zero from Ca + Cl to Kp = Ca
// + Cl rounded up to 32), w1p (9 x 32 rows, 64 columns), wpp (Cop = Co
// rounded up to 64 rows, 32 columns, zero past Co), then the f32 biases b0
// (64), b1 (32), bp (Cop), one after another.
struct WorkspaceB {
  size_t w0p, w1p, wpp, bias, total;
  int kp, cop;
  __host__ __device__ WorkspaceB(int ca, int cl, int co) {
    kp = ca + ceil32(cl);
    cop = ceil64(co);
    w0p = 0;
    w1p = align128((size_t)9 * kC0 * kp * 2);
    wpp = w1p + align128((size_t)kW1Bytes);
    bias = wpp + align128((size_t)cop * kC1 * 2);
    total = bias + align128((size_t)(kC0 + kC1 + cop) * 4);
  }
};

__global__ void __launch_bounds__(256)
    pack_bf16(const bf16* __restrict__ w0, const bf16* __restrict__ b0, const bf16* __restrict__ w1,
              const bf16* __restrict__ b1, const bf16* __restrict__ wp, const bf16* __restrict__ bp,
              unsigned char* __restrict__ ws, int ca, int cl, int co) {
  const WorkspaceB L(ca, cl, co);
  const int cin = ca + cl, kp = L.kp, cop = L.cop;
  bf16* w0p = reinterpret_cast<bf16*>(ws + L.w0p);
  bf16* w1p = reinterpret_cast<bf16*>(ws + L.w1p);
  bf16* wpp = reinterpret_cast<bf16*>(ws + L.wpp);
  float* bias = reinterpret_cast<float*>(ws + L.bias);
  const int n0 = 9 * kC0 * kp, n1 = 9 * kC1 * kC0, n2 = cop * kC1;
  const int total = n0 + n1 + n2 + kC0 + kC1 + cop;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total; i += gridDim.x * blockDim.x) {
    int j = i;
    if (j < n0) {  // w0p[t * 64 + n][k] = w0[n][k][t]
      const int k = j % kp, n = (j / kp) % kC0, t = j / (kp * kC0);
      w0p[j] = k < cin ? w0[((size_t)n * cin + k) * 9 + t] : __float2bfloat16(0.f);
    } else if ((j -= n0) < n1) {  // w1p[t * 32 + n][k] = w1[n][k][t]
      const int k = j % kC0, n = (j / kC0) % kC1, t = j / (kC0 * kC1);
      w1p[j] = w1[(n * kC0 + k) * 9 + t];
    } else if ((j -= n1) < n2) {  // wpp[n][k] = wp[n][k]
      const int k = j % kC1, n = j / kC1;
      wpp[j] = n < co ? wp[n * kC1 + k] : __float2bfloat16(0.f);
    } else if ((j -= n2) < kC0) {
      bias[j] = __bfloat162float(b0[j]);
    } else if ((j -= kC0) < kC1) {
      bias[kC0 + j] = __bfloat162float(b1[j]);
    } else {
      j -= kC1;
      bias[kC0 + kC1 + j] = j < co ? __bfloat162float(bp[j]) : 0.f;
    }
  }
}

// One bf16 block's shared memory, in bytes from its 1024-aligned base
// (kernels/decoder_tail.py: smem_bytes mirrors it): the ring, each stage
// w0's 9 tap tiles of one k-block and then that k-block of the (TH+4) x
// (TW+4) input window (swizzled, as TMA writes them); w1 (9 taps x 2
// k-blocks of 32 x 32); wp (Cop x 32); the fine halo u, (2TH+2) x (2TW+2)
// pixels in 2 k-blocks; the coarse halo c0 (kMaxHalo rows of kC0Ld: conv0's
// GEMM rows past the halo land there too, so no store is conditional); the
// f32 biases;
// the upsample's tables (kMaxSide rows, then kMaxSide columns); the ring's
// barriers and the resident weights' barrier.
struct TailLayout {
  size_t stage, ring, w1, wp, u, ukb, c0, bias, tab, bars, end;
  __host__ __device__ TailLayout(int th, int tw, int co, int stages) {
    const int nw = (th + 4) * (tw + 4), nu = (2 * th + 2) * (2 * tw + 2);
    const int cop = ceil64(co);
    stage = kW0Stage + align1024((size_t)nw * kKb * 2);
    ring = 0;
    w1 = ring + (size_t)stages * stage;
    wp = w1 + kW1Bytes;
    u = wp + (size_t)cop * kKb * 2;
    ukb = align1024((size_t)nu * kKb * 2);
    c0 = u + 2 * ukb;
    bias = c0 + (size_t)kMaxHalo * kC0Ld * 2;
    tab = bias + (size_t)(kC0 + kC1 + cop) * 4;
    bars = tab + 2 * kMaxSide * 16;
    end = bars + (2 * (size_t)stages + 1) * 8;
  }
  __host__ __device__ size_t bytes() const { return end + 1024; }  // + aligning the base
};

__global__ void __launch_bounds__(kHopperThreads, 1)
    tail_bf16(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap llmap,
              const __grid_constant__ CUtensorMap w0map, const __grid_constant__ CUtensorMap w1map,
              const __grid_constant__ CUtensorMap wpmap, const float* __restrict__ biases,
              bf16* __restrict__ out, int B, int H, int W, int Ca, int Cl, int Co, int th, int tw,
              int stages) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* base = smem_raw + (1024 - smem_u32(smem_raw) % 1024) % 1024;
  const TailLayout L(th, tw, Co, stages);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L.bars);
  uint64_t* empty = full + stages;
  uint64_t* wbar = empty + stages;  // w1 and wp, once
  bf16* w1s = reinterpret_cast<bf16*>(base + L.w1);
  bf16* wps = reinterpret_cast<bf16*>(base + L.wp);
  bf16* us = reinterpret_cast<bf16*>(base + L.u);
  bf16* c0s = reinterpret_cast<bf16*>(base + L.c0);
  float* b0s = reinterpret_cast<float*>(base + L.bias);
  const float* b1s = b0s + kC0;
  const float* bps = b1s + kC1;
  int4* tab_r = reinterpret_cast<int4*>(base + L.tab);  // a fine-halo row's coarse rows and weight
  int4* tab_q = tab_r + kMaxSide;                       // a fine-halo column's
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();

  const int cop = ceil64(Co), nkb = (Ca + ceil32(Cl)) / kKb, kba = Ca / kKb;
  const int hw2 = tw + 2, ww = tw + 4, fw = 2 * tw + 2, ftw = 2 * tw;
  const int hp = (th + 2) * hw2, no = 4 * th * tw, nw = (th + 4) * ww;
  const int ukb = (int)(L.ukb / 2);  // elements of one k-block of u
  // the tiles: block x takes tiles x, x + grid, ...; every block of a
  // cluster walks as many (a tile past the last redoes the last and writes
  // nothing), so the cluster shares each w0 tile
  const int tiles_w = (W + tw - 1) / tw, per_image = ((H + th - 1) / th) * tiles_w;
  const int tiles = B * per_image, iters = (tiles + (int)gridDim.x - 1) / (int)gridDim.x;
  auto tile_of = [&](int it, int& b, int& y0, int& x0) {
    const int t = it * (int)gridDim.x + (int)blockIdx.x, ti = min(t, tiles - 1);
    b = ti / per_image;
    y0 = (ti % per_image / tiles_w) * th;
    x0 = (ti % per_image % tiles_w) * tw;
    return t < tiles;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * S);  // the two consumer warpgroups of every block
    }
    mbar_init(wbar, 1);
    fence_barrier_init();
  }
  for (int i = threadIdx.x; i < kC0 + kC1 + cop; i += blockDim.x) b0s[i] = biases[i];
  __syncthreads();
  cluster_sync();  // every block's barriers are initialised before any multicast
  PF_STAMP(0);

  if (threadIdx.x >= kConsumerThreads) {  // the producer warpgroup
    producer_registers();
    if (threadIdx.x < kConsumerThreads + 32) {  // one warp; its first thread issues
      const bool issue = threadIdx.x == kConsumerThreads;
      if (issue) {
        prefetch_map(&amap);
        prefetch_map(&llmap);
        prefetch_map(&w0map);
        mbar_expect_tx(wbar, (uint32_t)(kW1Bytes + cop * kKb * 2));
        for (int t = 0; t < 9; ++t)
          for (int kb = 0; kb < 2; ++kb)
            tma_load(w1s + (t * 2 + kb) * kC1 * kKb, &w1map, kb * kKb, t * kC1, wbar, 0);
        tma_load(wps, &wpmap, 0, 0, wbar, 0);
      }
      // per tile and k-block: the window's k-block and w0's 9 taps of it,
      // this block's 64 / S rows of each multicast to the cluster
      const int part = kC0 / S;
      const uint16_t mask = S == 1 ? 0 : (uint16_t)((1u << S) - 1);
      int stage = 0, phase = 0;
      for (int it = 0; it < iters; ++it) {
        int b, y0, x0;
        tile_of(it, b, y0, x0);
        for (int kb = 0; kb < nkb; ++kb) {
          mbar_wait(&empty[stage], phase ^ 1);
          if (issue) {
            unsigned char* st = base + L.ring + (size_t)stage * L.stage;
            mbar_expect_tx(&full[stage], (uint32_t)(kW0Stage + nw * kKb * 2));
            if (kb < kba)
              tma_load_nhwc(st + kW0Stage, &amap, kb * kKb, x0 - 2, y0 - 2, b, &full[stage]);
            else
              tma_load_nhwc(st + kW0Stage, &llmap, (kb - kba) * kKb, x0 - 2, y0 - 2, b,
                            &full[stage]);
            for (int t = 0; t < 9; ++t)
              tma_load(st + t * kW0Tile + rank * part * kKb * 2, &w0map, kb * kKb,
                       t * kC0 + rank * part, &full[stage], mask);
          }
          __syncwarp();
          if (++stage == stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    cluster_sync();  // no block leaves while others may still multicast into it
    return;
  }

  consumer_registers();
  const int wg = threadIdx.x / 128, lrow = ldsm_row();
  // this lane's conv0 A row: halo pixel 64 wg + lrow (the last one past
  // the halo), as a window row at tap (0, 0)
  const int hpix = min(64 * wg + lrow, hp - 1);
  const int wrow = hpix / hw2 * ww + hpix % hw2;
  int stage = 0, phase = 0;
  for (int it = 0; it < iters; ++it) {
    int b, y0, x0;
    const bool real = tile_of(it, b, y0, x0);
    // the upsample's tables: fine-halo row r (fine row 2 y0 - 1 + r) reads
    // coarse rows lo, hi with hi's weight (offsets into c0), 0 outside the
    // image; columns alike. The last tile's upsample has read them.
    for (int i = threadIdx.x; i < 2 * kMaxSide; i += kConsumerThreads) {
      const bool row = i < kMaxSide;
      const int r = row ? i : i - kMaxSide, n = row ? H : W, o = row ? y0 : x0;
      const int f = 2 * o - 1 + r;
      int lo = 0, hi = 0;
      float wt = 0.f;
      if (f >= 0 && f < 2 * n) up_index(f, n, lo, hi, wt);
      const int step = row ? hw2 * kC0Ld : kC0Ld;  // coarse pixel y is halo row y - y0 + 1
      tab_r[i] = make_int4((lo - o + 1) * step, (hi - o + 1) * step, __float_as_int(wt),
                           f >= 0 && f < 2 * n);
    }

    // 1. conv0: acc0 = the window at each tap's shift . w0's tap tile, over
    // the k-blocks; a k-block's 18 MMAs in two groups (taps 0-4, 5-8), the
    // second's A loaded while the first runs; the stage is released as soon
    // as both are done
    float acc0[32];
    for (int kb = 0; kb < nkb; ++kb) {
      mbar_wait(&full[stage], phase);
      const unsigned char* st = base + L.ring + (size_t)stage * L.stage;
      const bf16* win = reinterpret_cast<const bf16*>(st + kW0Stage);
      uint32_t af[9][2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t0 = half ? 5 : 0, t1 = half ? 9 : 5;
#pragma unroll
        for (int t = t0; t < t1; ++t)
#pragma unroll
          for (int s = 0; s < 2; ++s) ldsm_a(win, wrow + t / 3 * ww + t % 3, 16 * s, af[t][s]);
        wg_fence();
        fence_regs(acc0);
#pragma unroll
        for (int t = t0; t < t1; ++t)
#pragma unroll
          for (int s = 0; s < 2; ++s)
            mma_n64_rs(acc0, af[t][s],
                       desc_at(reinterpret_cast<const bf16*>(st + t * kW0Tile), kC0, 0, 16 * s),
                       kb > 0 || t > 0 || s > 0);
        wg_commit();
      }
      wg_wait0();
      // release the stage in every block of the cluster (thread r: block
      // r), with no branch
      const int tl = threadIdx.x % 128;
      mbar_arrive_cluster_if(&empty[stage], tl < S ? tl : 0, tl < S);
      if (++stage == stages) {
        stage = 0;
        phase ^= 1;
      }
    }
    fence_regs(acc0);
    PF_STAMP_STEP(2, it);
    // c0 = T(relu(acc0 + b0)) for conv0's GEMM rows (the halo's pixels,
    // then rows never read). No branch reads an accumulator: ptxas would
    // serialise every wgmma of the kernel (C7518)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int c = acc_col(i);
      *reinterpret_cast<__nv_bfloat162*>(c0s + (64 * wg + acc_row(i)) * kC0Ld + c) =
          __floats2bfloat162_rn(fmaxf(acc0[i] + b0s[c], 0.f), fmaxf(acc0[i + 1] + b0s[c + 1], 0.f));
    }
    consumers_sync();  // c0 is complete; the last tile's conv1 has read u
    PF_STAMP_STEP(3, it);

    // 2. u = T(up2x(c0)) on the fine halo (origin 2 y0 - 1, 2 x0 - 1), zero
    // outside the image. Fine rows 2m - 1 and 2m read the same two coarse
    // rows (the one outside the image reads none), and columns alike, so a
    // thread takes a 2 x 2 block of fine pixels, 8 channels (a 16-byte
    // chunk) of each: four coarse loads and the row lerps shared by four
    // outputs, each output the reference's ay (ax p00 + wx p01) + wy (...).
    {
      const int c8 = threadIdx.x & 7, bw = tw + 1, nb = (th + 1) * bw;
      for (int blk = threadIdx.x >> 3; blk < nb; blk += kConsumerThreads / 8) {
        const int fr = 2 * (blk / bw), fq = 2 * (blk % bw);
        const int4 ra = tab_r[fr], rb = tab_r[fr + 1], qa = tab_q[fq], qb = tab_q[fq + 1];
        const int4 ry = ra.w ? ra : rb, qx = qa.w ? qa : qb;  // the pair's coarse rows, columns
        const bool in = (ra.w | rb.w) & (qa.w | qb.w);
        const bf16* c = c0s + 8 * c8;
        uint4 p[4];
        p[0] = *reinterpret_cast<const uint4*>(c + (in ? ry.x + qx.x : 0));
        p[1] = *reinterpret_cast<const uint4*>(c + (in ? ry.x + qx.y : 0));
        p[2] = *reinterpret_cast<const uint4*>(c + (in ? ry.y + qx.x : 0));
        p[3] = *reinterpret_cast<const uint4*>(c + (in ? ry.y + qx.y : 0));
        const float wx[2] = {__int_as_float(qa.z), __int_as_float(qb.z)};
        const float wy[2] = {__int_as_float(ra.z), __int_as_float(rb.z)};
        const bool okr[2] = {ra.w != 0, rb.w != 0}, okq[2] = {qa.w != 0, qb.w != 0};
        uint4 v[2][2];
#pragma unroll
        for (int k = 0; k < 4; ++k) {  // channel pair k of the chunk
          const float2 f00 = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(&p[0])[k]);
          const float2 f01 = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(&p[1])[k]);
          const float2 f10 = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(&p[2])[k]);
          const float2 f11 = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(&p[3])[k]);
#pragma unroll
          for (int j = 0; j < 2; ++j) {  // fine column fq + j
            const float ax = 1.f - wx[j];
            const float2 lo = make_float2(ax * f00.x + wx[j] * f01.x, ax * f00.y + wx[j] * f01.y);
            const float2 hi = make_float2(ax * f10.x + wx[j] * f11.x, ax * f10.y + wx[j] * f11.y);
#pragma unroll
            for (int i = 0; i < 2; ++i) {  // fine row fr + i
              const float ay = 1.f - wy[i];
              const bool ok = okr[i] & okq[j];
              reinterpret_cast<__nv_bfloat162*>(&v[i][j])[k] = __floats2bfloat162_rn(
                  ok ? ay * lo.x + wy[i] * hi.x : 0.f, ok ? ay * lo.y + wy[i] * hi.y : 0.f);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            *reinterpret_cast<uint4*>(us + (c8 >> 2) * ukb + swz((fr + i) * fw + fq + j, (c8 & 3) * 8)) =
                v[i][j];
      }
    }
    consumers_sync();  // u is complete; c0 has been read
    PF_STAMP_STEP(4, it);
    if (it == 0) mbar_wait(wbar, 0);  // w1 and wp are resident

    // 3. conv1 and the 1x1, 64 fine outputs at a time; the warpgroups take
    // alternate groups, starting with the other one at each tile (the
    // loop's count is the same for a warpgroup's four warps)
    const int ng = (no + 63) / 64;
    for (int g = wg ^ (it & 1); g < ng; g += 2) {
      const int opx = min(64 * g + lrow, no - 1);
      // this thread's two output rows of the group (accumulator rows r and
      // r + 8): their offsets into out, -1 past the outputs or the image
      long long obase[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = 64 * g + acc_row(2 * h), fy = 2 * y0 + o / ftw, fx = 2 * x0 + o % ftw;
        obase[h] = real && o < no && fy < 2 * H && fx < 2 * W
                       ? (((long long)b * 2 * H + fy) * 2 * W + fx) * Co : -1;
      }
      const int urow = opx / ftw * fw + opx % ftw;  // this lane's A row at tap (0, 0)
      // three chunks of 3 taps over two register sets: a chunk's A loads
      // while the one before it runs on the tensor cores
      float acc1[16];
      uint32_t a1[2][3][4][4];
#pragma unroll
      for (int t0 = 0; t0 < 9; t0 += 3) {
        uint32_t (&a)[3][4][4] = a1[t0 / 3 % 2];
        if (t0 == 6) wg_wait1();  // chunk 0 is done: its registers are free
#pragma unroll
        for (int t = 0; t < 3; ++t)
#pragma unroll
          for (int s = 0; s < 4; ++s)
            ldsm_a(us + (s / 2) * ukb, urow + (t0 + t) / 3 * fw + t, 16 * (s % 2), a[t][s]);
        wg_fence();
        fence_regs(acc1);
#pragma unroll
        for (int t = 0; t < 3; ++t)
#pragma unroll
          for (int s = 0; s < 4; ++s)
            mma_n32_rs(acc1, a[t][s],
                       desc_at(w1s + ((t0 + t) * 2 + s / 2) * kC1 * kKb, kC1, 0, 16 * (s % 2)),
                       t0 + t > 0 || s > 0);
        wg_commit();
      }
      wg_wait0();
      fence_regs(acc1);
      // c1 = T(relu(acc1 + b1)), the 1x1's register A (its k16 steps are
      // acc1's columns 0-15 and 16-31)
      uint32_t ca[2][4];
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = 8 * s + 2 * j, c = acc_col(i);
          ca[s][j] = pack_bf16(fmaxf(acc1[i] + b1s[c], 0.f), fmaxf(acc1[i + 1] + b1s[c + 1], 0.f));
        }
      for (int nc = 0; nc < cop; nc += 64) {
        float acc2[32];
        wg_fence();
        fence_regs(acc2);
        mma_n64_rs(acc2, ca[0], desc_at(wps, cop, nc, 0), 0);
        mma_n64_rs(acc2, ca[1], desc_at(wps, cop, nc, 16), 1);
        wg_commit();
        wg_wait0();
        fence_regs(acc2);
        // out = T(acc2 + bp), rounded before any branch (no branch reads an
        // accumulator)
        uint32_t v[16];
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int c = nc + acc_col(i);
          v[i / 2] = pack_bf16(acc2[i] + bps[c], acc2[i + 1] + bps[c + 1]);
          asm volatile("" : "+r"(v[i / 2]));
        }
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const long long ob = obase[(i >> 1) & 1];
          const int c = nc + acc_col(i);
          if (ob < 0 || c >= Co) continue;
          bf16* dst = out + ob + c;
          const __nv_bfloat162 pair = *reinterpret_cast<const __nv_bfloat162*>(&v[i / 2]);
          if (Co % 2 == 0) {
            *reinterpret_cast<__nv_bfloat162*>(dst) = pair;
          } else {
            dst[0] = pair.x;
            if (c + 1 < Co) dst[1] = pair.y;
          }
        }
      }
    }
    PF_STAMP_STEP(5, it);
  }
  cluster_sync();  // no block leaves while others may still multicast into it
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

int launch_bf16(const void* a, const void* ll, const void* w0, const void* b0, const void* w1,
                const void* b1, const void* wp, const void* bp, void* out, void* ws, int B, int H,
                int W, int Ca, int Cl, int Co, int th, int tw, int cluster, int grid, int stages,
                cudaStream_t st) {
  const WorkspaceB L(Ca, Cl, Co);
  auto* wsb = static_cast<unsigned char*>(ws);
  const int n = 9 * kC0 * L.kp + 9 * kC1 * kC0 + L.cop * kC1 + kC0 + kC1 + L.cop;
  pack_bf16<<<(n + 255) / 256, 256, 0, st>>>(
      static_cast<const bf16*>(w0), static_cast<const bf16*>(b0), static_cast<const bf16*>(w1),
      static_cast<const bf16*>(b1), static_cast<const bf16*>(wp), static_cast<const bf16*>(bp), wsb,
      Ca, Cl, Co);
  int err = (int)cudaGetLastError();
  CUtensorMap am, lm, w0m, w1m, wpm;
  if (err == 0) err = make_map_nhwc(&am, a, B, H, W, Ca, tw + 4, th + 4);
  if (err == 0) err = make_map_nhwc(&lm, ll, B, H, W, Cl, tw + 4, th + 4);
  if (err == 0) err = make_map(&w0m, wsb + L.w0p, 9 * kC0, L.kp, kC0 / cluster);
  if (err == 0) err = make_map(&w1m, wsb + L.w1p, 9 * kC1, kC0, kC1);
  if (err == 0) err = make_map(&wpm, wsb + L.wpp, L.cop, kC1, L.cop);
  if (err != 0) return err;
  return launch_cluster(tail_bf16, dim3(grid), kHopperThreads,
                        TailLayout(th, tw, Co, stages).bytes(), cluster, st, false, am, lm, w0m,
                        w1m, wpm, reinterpret_cast<const float*>(wsb + L.bias),
                        static_cast<bf16*>(out), B, H, W, Ca, Cl, Co, th, tw, stages);
}

}  // namespace

extern "C" {

// Bytes of the workspace pf_decoder_tail needs (dtype 0 = float32, 1 =
// bfloat16) for Ca + Cl input channels and Co outputs.
int pf_decoder_tail_workspace_bytes(int dtype, int ca, int cl, int co) {
  return dtype == 0 ? (int)Workspace(4, ca + cl, co).total : (int)WorkspaceB(ca, cl, co).total;
}

// Shared memory of one bf16 block with a (th, tw) coarse tile and a ring of
// ``stages`` stages; kernels/decoder_tail.py: smem_bytes mirrors it (the
// GPU tests hold them equal).
int pf_decoder_tail_smem(int th, int tw, int co, int stages) {
  return (int)TailLayout(th, tw, co, stages).bytes();
}

// How many clusters of ``cluster`` bf16 blocks the card runs at once
// (kernels/decoder_tail.py: plan).
int pf_decoder_tail_max_clusters(int th, int tw, int co, int stages, int cluster) {
  return max_clusters(tail_bf16, kHopperThreads, TailLayout(th, tw, co, stages).bytes(), cluster);
}

// dtype: 0 = float32, 1 = bfloat16. Every pointer is a contiguous device
// buffer of that dtype: a (B, H, W, Ca), ll (B, H, W, Cl); w0 (64, Ca+Cl, 3,
// 3), b0 (64); w1 (32, 64, 3, 3), b1 (32); wp (Co, 32), bp (Co); out (B, 2H,
// 2W, Co); ws the workspace (pf_decoder_tail_workspace_bytes, 128-byte
// aligned). a and ll are 16-byte aligned, Ca % 8 == Cl % 8 == 0 (bf16: Ca %
// 32 == 0), 1 <= Co <= 192. bfloat16 also takes the plan of
// kernels/decoder_tail.py: the coarse tile (th, tw) with (th+2)(tw+2) <= 128
// and 4 th tw <= 384, a ``cluster`` of 1, 2, 4 or 8 blocks multicasting w0, a
// grid of persistent blocks (a multiple of the cluster) and ``stages`` ring
// stages (2 to 6); float32 ignores them. Returns cudaGetLastError() after
// the launches (0 on success); a launch the card refuses is an error.
int pf_decoder_tail(int dtype, const void* a, const void* ll, const void* w0, const void* b0,
                    const void* w1, const void* b1, const void* wp, const void* bp, void* out,
                    void* ws, int B, int H, int W, int Ca, int Cl, int Co, int th, int tw,
                    int cluster, int grid, int stages, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((dtype != 0 && dtype != 1) || B < 1 || H < 1 || W < 1 || Ca < 8 || Cl < 8 || Ca % 8 != 0 ||
      Cl % 8 != 0 || Co < 1 || Co > kMaxCo)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    if (Ca % kKb != 0 || th < 1 || tw < 1 || (th + 2) * (tw + 2) > kMaxHalo ||
        4 * th * tw > kMaxFine || (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) ||
        grid < cluster || grid % cluster != 0 || stages < 2 || stages > kMaxStagesT)
      return (int)cudaErrorInvalidValue;
    return launch_bf16(a, ll, w0, b0, w1, b1, wp, bp, out, ws, B, H, W, Ca, Cl, Co, th, tw,
                       cluster, grid, stages, st);
  }
  const int cin = Ca + Cl;
  const int n_pack = 9 * ceil32(cin) * kC0 + 9 * kC0 * kC1 + kC1 * ceil16(Co) + kC0 + kC1 + ceil16(Co);
  auto* wsb = static_cast<unsigned char*>(ws);
  pack_weights<float><<<(n_pack + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(w0), static_cast<const float*>(b0), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(wp), static_cast<const float*>(bp),
      wsb, cin, Co);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const size_t smem = SmemF32(Co).total;
  err = (int)set_dynamic_smem((const void*)tail_f32, smem);
  if (err != 0) return err;
  const dim3 grid_f32(((H + kTH - 1) / kTH) * ((W + kTW - 1) / kTW), B);
  tail_f32<<<grid_f32, kThreads, smem, st>>>(static_cast<const float*>(a),
                                             static_cast<const float*>(ll), wsb,
                                             static_cast<float*>(out), H, W, Ca, Cl, Co);
  return (int)cudaGetLastError();
}

const char* pf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

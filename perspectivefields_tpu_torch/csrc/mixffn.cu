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
// What bounds it on the H100 (kernels/roofline.py, the least time at the
// flagship's B=8 shapes, ~3-6 us a call): the CUDA-core work on the 4C-wide
// hidden map (9 taps and GELU per element) at C = 64 and 512, the
// tensor-core work of fc1 + fc2 at C = 128 and 320. Unfused, the hidden map goes
// through HBM five times around two thin GEMMs. A block owns a TH x TW tile
// of one image plus the 1-pixel halo the 3x3 conv needs and walks the
// hidden dimension in chunks of 64 channels, so the hidden map never
// exists whole, on chip or in HBM: HBM sees one read of x and one write of
// out. The halo costs recomputing fc1 on (TH+2)(TW+2) tokens for TH*TW
// outputs.
//
// The WMMA version of this kernel was 30-35x above the bound and 1.6x
// slower than the unfused path: its 16x16 MMAs took ~200 cycles a
// tile-step, every block copied all of W1 and W2 from L2 once per tile,
// the taps and GELU ran while the tensor cores waited, and where tiles were
// few it split the hidden dimension into f32 partials that made an HBM
// round trip to a second launch.
//
// bfloat16, this design (hopper_gemm.cuh): a block owns at most 64 outputs
// (wgmma's M for fc2) in a halo of at most 128 tokens, one or two m64 row
// groups (HR). Two consumer warpgroups; one warp of a third (producer)
// warpgroup streams W1 and W2 as 16 KB tiles by TMA through a ring (its
// other three warps wait at the cluster barrier, taking no issue slots):
//   1. x's halo rows into shared memory (wgmma's swizzled A operand);
//   2. per 64-channel hidden chunk j: fc1 on wgmma (HR = 2: each warpgroup
//      its own 64 halo rows, m64n64; HR = 1: each warpgroup 32 of the 64
//      channels, m64n32); + b1, zero off the image, T(.) into a plain bf16
//      tile; the 3x3 taps and GELU (tanhf, as gelu<bf16>), each thread two
//      channels of up to 8 outputs (the taps read across both row groups),
//      into g (swizzled, double-buffered); fc2 into f32 accumulators that
//      stay in registers across all chunks (each warpgroup 64 of every 128
//      output columns);
//   3. out = T(acc + b2) for the tile's outputs.
// The accumulators of at most 5 W2 tiles (640 columns) fit the registers:
// a wider C (up to 1280, where x's halo rows still fit shared memory) runs
// steps 2-3 in passes over an even share of the tiles, fc1 and the taps
// recomputed each pass.
// The taps overlap the tensor cores: chunk j+1's fc1 is issued before
// chunk j's taps, and chunk j's fc2 stays in flight while chunk j+1's fc1
// output is masked and rounded; the ring keeps two stages' MMAs in flight
// (retire2). Every MMA of a ring stage is unconditional (x padded to whole
// 128-column tiles, the W2 tiles a template parameter): a conditional MMA
// makes ptxas serialise them.
// A thread-block cluster does one of two things (kernels/mixffn.py: plan,
// which counts the tile, HR, the cluster and the L2 weight bytes):
//   - multicast: k neighbouring tiles share the ring, each block loading
//     1/k of every weight tile's rows into all k, so L2 serves each tile
//     once per cluster (a grid the cluster does not divide is padded with
//     blocks that load and wait and write nothing);
//   - split, where the tiles alone leave SMs idle (stages 3-4 at B=8): the
//     S blocks of a cluster share one tile and take hidden chunks r, r + S,
//     ...; after the walk their f32 partial outputs (over the ring and x,
//     no longer read) meet in distributed shared memory, summed in rank
//     order (bit-reproducible), each block finishing 64 / S of the rows.
//     No partial reaches HBM; one launch.
//
// What bounds it now (PERF.md; chip_smoke.py --phases, the PF_STAMP clock64
// counts of one block): the CUDA-core work of the chunks. Per 64-channel
// chunk at C = 64-128 the taps and GELU take ~3.2-3.4k cycles for 56-60
// outputs on the 8 consumer warps (issue- and latency-bound: 2 warps a
// scheduler), the mask ~1.3k, fc1 and fc2 issue ~1.3k; at C = 320-512, fc1
// and fc2 (~3.6-4.4k cycles a chunk, weights from L2 without multicast at
// a split) come first. 3-8% of the bound. Next: fewer instructions in the taps (a sliding window
// along the tile's rows), a third consumer warpgroup where the accumulators
// are few (C <= 128), multicast within a split.
//
// float32 runs scalar FMAs (the tensor cores' f32 input is TF32, which
// would not match f32); its chunked fc2 continues one FMA chain over the
// hidden dimension and its taps run in row-major order, so it rounds as the
// unfused path on the card does. Its tile, index tables and walk are shared
// with the whole-block kernel (mixffn_common.cuh, fused_block.cu).

#include "hopper_gemm.cuh"
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
// bfloat16: wgmma, a TMA weight ring, clusters (hopper_gemm.cuh)
// ---------------------------------------------------------------------------

constexpr int kOut = 64;            // outputs a block owns at most: fc2's wgmma M
constexpr int kHfLdB = kHC + 8;     // row of the bf16 hidden chunk
constexpr int kMaxStagesB = 6;
constexpr int kMaxCB = 1280;        // widest C: x's 64 halo rows fit beside a 2-stage ring
constexpr int kMaxNT = 5;           // 128-column W2 tiles a pass keeps in registers
constexpr int kMaxNT2 = 3;          // two row groups: at most 3 W2 tiles a pass (registers)

__host__ __device__ constexpr size_t align1024(size_t n) { return (n + 1023) / 1024 * 1024; }

// One bf16 block's shared memory, in bytes from its 1024-aligned base
// (kernels/mixffn.py: smem_bytes mirrors it): the ring; xs, HR x 64 halo
// rows of x, zero-padded to whole 128-column tiles (swizzled); the hidden
// chunk as plain bf16 rows; g, two 64 x 64 buffers (swizzled); the valid
// and output tables; the ring's barriers. At a split the f32 partial
// output (64 x C, padded to whole 128-column tiles) goes over everything
// before the tables once the walk is done.
struct FfnLayout {
  size_t ring, xs, hf, gs, tables, bars, end;
  __host__ __device__ FfnLayout(int C, int hr, int stages) {
    ring = 0;
    xs = ring + (size_t)stages * kStageBytes;
    hf = xs + (size_t)hr * 64 * round_up(C, 128) * 2;
    gs = hf + align1024((size_t)hr * 64 * kHfLdB * 2);
    tables = gs + 2 * (size_t)kOut * kHC * 2;
    bars = tables + (2 * 64 + kOut) * 4;
    end = bars + 2 * (size_t)stages * 8;
  }
  __host__ __device__ size_t bytes() const { return end + 1024; }  // + aligning the base
};

// HR: m64 row groups of the halo (1: <= 64 tokens, 2: <= 128); NT: 128-row
// W2 tiles a pass (C <= 128 NT passes; w2_passes). split == 0: the cluster
// multicasts the weights over neighbouring tiles; split == 1 (one pass):
// the cluster's blocks share a tile and split its hidden chunks.
template <int HR, int NT>
__global__ void __launch_bounds__(kHopperThreads, 1)
    mixffn_bf16(const __grid_constant__ CUtensorMap w1map, const __grid_constant__ CUtensorMap w2map,
                const bf16* __restrict__ x, const bf16* __restrict__ b1,
                const bf16* __restrict__ dwk, const bf16* __restrict__ dwb,
                const bf16* __restrict__ b2, bf16* __restrict__ out, int B, int H, int W, int C,
                int th, int tw, int split, int stages) {
  constexpr int kRowsX = 64 * HR;  // halo rows held
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* base = smem_raw + (1024 - smem_u32(smem_raw) % 1024) % 1024;
  const FfnLayout L(C, HR, stages);
  Ring ring(base + L.ring, reinterpret_cast<uint64_t*>(base + L.bars), stages);
  bf16* xs = reinterpret_cast<bf16*>(base + L.xs);  // x's halo rows (swizzled)
  bf16* hf = reinterpret_cast<bf16*>(base + L.hf);  // the hidden chunk, rows of kHfLdB
  bf16* gs = reinterpret_cast<bf16*>(base + L.gs);  // g, two 64 x 64 buffers (swizzled)
  float* red = reinterpret_cast<float*>(base + L.ring);  // split: f32 64 x 128 NT, over ring and xs
  float* valid = reinterpret_cast<float*>(base + L.tables);
  int* obase = reinterpret_cast<int*>(base + L.tables + 2 * 64 * 4);
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int mc = split ? 1 : S, mrank = split ? 0 : rank;  // the ring's multicast

  // the tile: blocks past the last tile (the grid padded to the cluster)
  // redo the last one and write nothing
  const int tiles_w = (W + tw - 1) / tw, per_image = ((H + th - 1) / th) * tiles_w;
  const int tiles = B * per_image, tile_id = split ? (int)blockIdx.x / S : (int)blockIdx.x;
  const bool real = tile_id < tiles;
  const int ti = real ? tile_id : tiles - 1;
  const int b = ti / per_image, tt = ti % per_image;
  const int y0 = (tt / tiles_w) * th, x0 = (tt % tiles_w) * tw, hw = tw + 2;
  const int nhalo = (th + 2) * hw, no = th * tw;
  const int Cp = round_up(C, 128), nch = 4 * C / kHC;
  const int passes = (Cp / 128 + NT - 1) / NT;  // walks of the hidden chunks, NT W2 tiles each
  // this block's hidden chunks: all, or rank, rank + S, ... at a split
  const int c0 = split ? rank : 0, cstep = split ? S : 1;
  const int nloc = (nch - c0 + cstep - 1) / cstep;

  ring.init(mc);
  for (int t = threadIdx.x; t < kRowsX; t += blockDim.x) {
    const int yy = y0 - 1 + t / hw, xx = x0 - 1 + t % hw;
    valid[t] = t < nhalo && yy >= 0 && yy < H && xx >= 0 && xx < W ? 1.f : 0.f;
    if (t < kOut) obase[t] = (t / tw) * hw + t % tw;  // output t's top-left tap (t < no)
  }
  for (int i = threadIdx.x; i < kRowsX * (Cp - C); i += blockDim.x)  // xs's zero padding
    xs[swz_at(kRowsX, i / (Cp - C), C + i % (Cp - C))] = __float2bfloat16(0.f);
  __syncthreads();
  cluster_sync();  // every block's barriers are initialised before any multicast
  PF_STAMP(0);

  if (threadIdx.x >= kConsumerThreads) {  // the producer warpgroup: weight tiles by TMA
    producer_registers();
    if (threadIdx.x == kConsumerThreads) {
      prefetch_map(&w1map);
      prefetch_map(&w2map);
    }
    // the consumers' order: fc1(0), then fc1(j + 1) before fc2(j). One warp
    // waits on the ring; the other three wait at the cluster's barrier,
    // where they take no issue slots from the consumers.
    if (threadIdx.x < kConsumerThreads + 32) {
      auto fc1 = [&](int j) {
        for (int k0 = 0; k0 < Cp; k0 += 128)
          ring.produce({&w1map, (c0 + j * cstep) * kHC, k0, 64, 128}, mc, mrank);
      };
      for (int pass = 0; pass < passes; ++pass) {
        if (nloc > 0) fc1(0);
        for (int j = 0; j < nloc; ++j) {
          if (j + 1 < nloc) fc1(j + 1);
          for (int jt = 0; jt < NT; ++jt)
            ring.produce({&w2map, 128 * (pass * NT + jt), (c0 + j * cstep) * kHC, 128, 64}, mc,
                         mrank);
        }
      }
      __syncwarp();
    }
    if (split) cluster_sync();  // the consumers' exchange of the partial outputs
    cluster_sync();  // no block leaves while others may still read or write into it
    return;
  }

  consumer_registers();
  const int wg = threadIdx.x / 128;
  const size_t img = (size_t)b * H * W;

  // 1. x's halo rows (zero off the image), four 16-byte loads in flight a thread
  const int nvec = kRowsX * (C / 8);
  for (int i0 = threadIdx.x; i0 < nvec; i0 += 4 * kConsumerThreads) {
    uint4 val[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * kConsumerThreads, t = i / (C / 8), v = i % (C / 8);
      val[u] = make_uint4(0, 0, 0, 0);
      if (i < nvec && valid[t] != 0.f) {
        const size_t pix = img + (size_t)(y0 - 1 + t / hw) * W + (x0 - 1 + t % hw);
        val[u] = reinterpret_cast<const uint4*>(x + pix * C)[v];
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * kConsumerThreads, t = i / (C / 8), v = i % (C / 8);
      if (i < nvec) *reinterpret_cast<uint4*>(xs + swz_at(kRowsX, t, v * 8)) = val[u];  // 8 values share a chunk
    }
  }
  fence_async_smem();
  consumers_sync();
  PF_STAMP(1);

  // fc1 of chunk h into d1, issued through the ring; the last stage stays in flight
  constexpr int kD1 = HR == 2 ? 32 : 16;
  float d1[kD1];
  auto fc1_issue = [&](int h) {
    for (int k0 = 0; k0 < Cp; k0 += 128) {
      const bf16* w = ring.wait();
      wg_fence();
      fence_regs(d1);
      if constexpr (HR == 2) {
#pragma unroll
        for (int k = 0; k < 128; k += 16)
          mma_n64_ss(d1, desc_at(xs, kRowsX, 64 * wg, k0 + k),
                     desc_at(w, 64, 0, k), k0 + k > 0);
      } else {
#pragma unroll
        for (int k = 0; k < 128; k += 16)
          mma_n32_ss(d1, desc_at(xs, kRowsX, 0, k0 + k),
                     desc_at(w, 64, 32 * wg, k), k0 + k > 0);
      }
      wg_commit();
      ring.retire2(mc);
    }
  };
  // the chunk's b1 at this thread's fc1 columns (a pair per 4 accumulators),
  // the 3x3 taps of channels cp, cp + 1 and their conv bias, loaded a chunk
  // ahead so their latency hides behind the tensor cores
  const int cp = 2 * (threadIdx.x % 32), grp = threadIdx.x / 32;
  float2 b1v[kD1 / 4];
  float tap0[9], tap1[9], db0, db1;
  auto load_b1 = [&](int h) {
#pragma unroll
    for (int i = 0; i < kD1; i += 4)
      b1v[i / 4] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          b1 + (size_t)h * kHC + (HR == 2 ? 0 : 32 * wg) + acc_col(i)));
  };
  auto load_taps = [&](int h) {
    const int ch = h * kHC + cp;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      tap0[k] = __bfloat162float(dwk[(size_t)ch * 9 + k]);
      tap1[k] = __bfloat162float(dwk[(size_t)(ch + 1) * 9 + k]);
    }
    db0 = __bfloat162float(dwb[ch]);
    db1 = __bfloat162float(dwb[ch + 1]);
  };
  // d1 (complete) + b1, zero off the image, T(.) into hf
  auto mask_round = [&] {
    fence_regs(d1);
#pragma unroll
    for (int i = 0; i < kD1; i += 2) {
      const int t = (HR == 2 ? 64 * wg : 0) + acc_row(i);
      const int j = (HR == 2 ? 0 : 32 * wg) + acc_col(i);
      const float2 bias = b1v[i / 4];
      const bool in = valid[t] != 0.f;
      *reinterpret_cast<__nv_bfloat162*>(hf + t * kHfLdB + j) =
          __floats2bfloat162_rn(in ? d1[i] + bias.x : 0.f, in ? d1[i + 1] + bias.y : 0.f);
    }
  };

  // 4. out = T(acc + b2) for the tile's outputs
  auto store = [&](int o, int c, float v0, float v1) {
    if (!real || o >= no || c >= C) return;
    const int yy = y0 + o / tw, xx = x0 + o % tw;
    if (yy >= H || xx >= W) return;
    const float2 bias = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b2 + c));
    *reinterpret_cast<__nv_bfloat162*>(out + (img + (size_t)yy * W + xx) * C + c) =
        __floats2bfloat162_rn(v0 + bias.x, v1 + bias.y);
  };
  float acc[NT][32];
  // each pass walks the hidden chunks again for the next NT W2 tiles
  // (columns n0 ..); x's halo rows stay in shared memory
  for (int pass = 0; pass < passes; ++pass) {
    const int n0 = 128 * NT * pass;
    if (nloc > 0) {
      load_b1(c0);
      load_taps(c0);
      fc1_issue(c0);
      ring.drain(mc);
      mask_round();
    }
    consumers_sync();
    PF_STAMP(2);
    for (int j = 0; j < nloc; ++j) {
      const int h = c0 + j * cstep;
      if (j + 1 < nloc) {
        fc1_issue(h + cstep);  // in flight under the taps
        PF_STAMP_STEP(3, j);
        load_b1(h + cstep);    // mask_round(j) has read b1v
      }
      // 2. g = T(gelu(dw3x3(hidden) + dwb)) for the tile's outputs; g's rows
      // past no feed only output rows that are never stored
      // (outputs grp, grp + 8, ...: every load unconditional, from a clamped
      // output, so all of them can be in flight at once)
      bf16* g = gs + (j & 1) * kOut * kHC;
#pragma unroll
      for (int k = 0; k < kOut / 8; ++k) {
        const int o = grp + 8 * k;
        const bf16* hp = hf + obase[min(o, no - 1)] * kHfLdB + cp;
        float a0 = 0.f, a1 = 0.f;
#pragma unroll
        for (int dp = 0; dp < 3; ++dp)
#pragma unroll
          for (int dq = 0; dq < 3; ++dq) {
            const float2 v = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(hp + (dp * hw + dq) * kHfLdB));
            a0 = fmaf(v.x, tap0[dp * 3 + dq], a0);
            a1 = fmaf(v.y, tap1[dp * 3 + dq], a1);
          }
        if (o < no)
          *reinterpret_cast<__nv_bfloat162*>(g + swz_at(kOut, o, cp)) =
              __floats2bfloat162_rn(gelu<bf16>(a0 + db0), gelu<bf16>(a1 + db1));
      }
      fence_async_smem();
      consumers_sync();  // g is complete; hf has been read
      PF_STAMP_STEP(4, j);
      // 3. fc2: acc[jt] += g . W2[n0 + 128 jt + 64 wg + (0..63), h*64 : h*64 + 64]^T
#pragma unroll
      for (int jt = 0; jt < NT; ++jt) {
        const bf16* w = ring.wait();
        wg_fence();
        fence_regs(acc[jt]);
#pragma unroll
        for (int k = 0; k < kHC; k += 16)
          mma_n64_ss(acc[jt], desc_at(g, kOut, 0, k), desc_at(w, 128, 64 * wg, k), j > 0 || k > 0);
        wg_commit();
        ring.retire2(mc);
      }
      PF_STAMP_STEP(6, j);
      if (j + 1 < nloc) {  // while fc2(j) is in flight
        load_taps(h + cstep);
        if constexpr (NT >= 2)  // fc1(j + 1) is complete: only fc2(j)'s groups remain
          wg_wait2();
        else
          wg_wait1();
        mask_round();
      }
      consumers_sync();  // hf holds chunk j + 1
      PF_STAMP_STEP(5, j);
    }
    ring.drain(mc);
#pragma unroll
    for (int jt = 0; jt < NT; ++jt) fence_regs(acc[jt]);
    PF_STAMP(96);

    if (!split) {
#pragma unroll
      for (int jt = 0; jt < NT; ++jt)
#pragma unroll
        for (int i = 0; i < 32; i += 2)
          store(acc_row(i), n0 + 128 * jt + 64 * wg + acc_col(i), acc[jt][i], acc[jt][i + 1]);
      continue;
    }
    // a split (one pass): the cluster's partial outputs (all NT tiles at
    // once, over the ring and x: neither is read any more), summed in rank
    // order; block rank finishes rows rank * 64 / S ..
#pragma unroll
    for (int jt = 0; jt < NT; ++jt)
#pragma unroll
      for (int i = 0; i < 32; i += 2)
        *reinterpret_cast<float2*>(red + acc_row(i) * (NT * 128) + 128 * jt + 64 * wg + acc_col(i)) =
            make_float2(nloc > 0 ? acc[jt][i] : 0.f, nloc > 0 ? acc[jt][i + 1] : 0.f);
    cluster_sync();
    PF_STAMP(97);
    const int rows = kOut / S, r0 = rank * rows, n4 = rows * NT * 32;
    for (int e0 = threadIdx.x; e0 < n4; e0 += 4 * kConsumerThreads) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {  // four rows' float4 in flight a thread
        const int e = e0 + u * kConsumerThreads;
        if (e >= n4) break;
        const int row = r0 + e / (NT * 32), col = 4 * (e % (NT * 32));
        const float4 sum = cluster_sum4(cluster, red, row * (NT * 128) + col, S);
        store(row, col, sum.x, sum.y);
        store(row, col + 2, sum.z, sum.w);
      }
    }
  }
  cluster_sync();  // no block leaves while others may still read or write into it
}

// The kernel for (HR, C): NT W2 tiles a pass, the ceil(C / 128) tiles
// shared evenly over the fewest passes of at most kMaxNT (kernels/mixffn.py:
// w2_passes), up to kMaxCB; two row groups only up to kMaxNT2 tiles a pass.
// nullptr where there is none.
inline decltype(&mixffn_bf16<1, 1>) bf16_kernel(int hr, int C) {
  if (C < 32 || C % 32 != 0 || C > kMaxCB) return nullptr;
  const int tiles = (C + 127) / 128, passes = (tiles + kMaxNT - 1) / kMaxNT;
  const int nt = (tiles + passes - 1) / passes;
  if (hr == 2) {
    switch (nt) {
      case 1: return mixffn_bf16<2, 1>;
      case 2: return mixffn_bf16<2, 2>;
      case 3: return mixffn_bf16<2, 3>;
      default: return nullptr;  // more than kMaxNT2
    }
  }
  if (hr != 1) return nullptr;
  switch (nt) {
    case 1: return mixffn_bf16<1, 1>;
    case 2: return mixffn_bf16<1, 2>;
    case 3: return mixffn_bf16<1, 3>;
    case 4: return mixffn_bf16<1, 4>;
    default: return mixffn_bf16<1, 5>;
  }
}

__host__ __device__ inline int halo_groups(int th, int tw) {
  return (th + 2) * (tw + 2) > 64 ? 2 : 1;
}

// float32: shared memory of one block (kernels/mixffn.py: smem_bytes)
size_t smem_f32(int C, int th, int tw) {
  const int nhp = ceil16((th + 2) * (tw + 2)), nop = ceil16(th * tw);
  const size_t small = 2 * align128(kHC * 4) + 2 * kMaxHalo * 4;  // biases, tables
  return align128((size_t)nhp * C * 4) + align128((size_t)nhp * kHfLd * 4) +
         align128((size_t)nop * kHfLd * 4) + align128((size_t)nop * C * 4) +
         align128(32 * kWsLd * 4) + small;
}

int launch_bf16(const void* x, const void* w1, const void* b1, const void* dwk, const void* dwb,
                const void* w2, const void* b2, void* out, int B, int H, int W, int C, int th,
                int tw, int cluster, int split, int stages, cudaStream_t stream) {
  const int hr = halo_groups(th, tw), mc = split ? 1 : cluster;
  CUtensorMap m1, m2;
  int err = make_map(&m1, w1, 4 * C, C, 64 / mc);
  if (err == 0) err = make_map(&m2, w2, C, 4 * C, 128 / mc);
  if (err != 0) return err;
  const int tiles = B * ((H + th - 1) / th) * ((W + tw - 1) / tw);
  const int grid = split ? tiles * cluster : (tiles + cluster - 1) / cluster * cluster;
  return launch_cluster(bf16_kernel(hr, C), dim3(grid), kHopperThreads,
                        FfnLayout(C, hr, stages).bytes(), cluster, stream, false, m1, m2,
                        static_cast<const bf16*>(x), static_cast<const bf16*>(b1),
                        static_cast<const bf16*>(dwk), static_cast<const bf16*>(dwb),
                        static_cast<const bf16*>(b2), static_cast<bf16*>(out), B, H, W, C, th, tw,
                        split, stages);
}

}  // namespace

extern "C" {

// Shared memory of one block: float32 for a (th, tw) tile, bfloat16 for a
// tile of ``hr`` halo row groups and a ring of ``stages`` stages;
// kernels/mixffn.py: smem_bytes mirrors both (the GPU tests hold them equal).
int pf_mixffn_smem(int dtype, int C, int th, int tw, int stages) {
  if (dtype == 1) return (int)FfnLayout(C, halo_groups(th, tw), stages).bytes();
  return (int)smem_f32(C, th, tw);
}

// How many clusters of ``cluster`` bf16 blocks of the (th, tw) tile with a
// ring of ``stages`` stages the card runs at once (kernels/mixffn.py: plan).
int pf_mixffn_max_clusters(int C, int th, int tw, int stages, int cluster) {
  const int hr = halo_groups(th, tw);
  if (bf16_kernel(hr, C) == nullptr) return 0;
  return max_clusters(bf16_kernel(hr, C), kHopperThreads, FfnLayout(C, hr, stages).bytes(),
                      cluster);
}

// dtype: 0 = float32, 1 = bfloat16. Every pointer is a contiguous device
// buffer: x and out (B, H, W, C); w1 (4C, C); b1, dwb (4C); dwk (4C, 1, 3, 3);
// w2 (C, 4C); b2 (C). Requires C % 32 == 0. The tile (th, tw) comes from
// kernels/mixffn.py: float32 from choose_tile ((th+2)(tw+2) <= 128 and
// shared memory), bfloat16 from plan (th*tw <= 64 outputs, (th+2)(tw+2) <=
// 128 halo tokens, <= 64 where a pass has more than 3 W2 tiles; C <= 1280;
// a ``cluster`` of 1, 2, 4 or 8 blocks that multicast the weights over as
// many tiles (split 0) or split one tile's hidden chunks (split 1, cluster
// <= 4C / 64, C <= 640: one pass); ``stages``
// ring stages, 2 to 6); float32 ignores cluster, split and stages. Returns
// cudaGetLastError() after the launch (0 on success); a launch the card
// refuses is an error.
int pf_mixffn(int dtype, const void* x, const void* w1, const void* b1, const void* dwk,
              const void* dwb, const void* w2, const void* b2, void* out, int B, int H, int W,
              int C, int th, int tw, int cluster, int split, int stages, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C % 32 != 0 || th < 1 || tw < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    if (ceil16((th + 2) * (tw + 2)) > kMaxHalo) return (int)cudaErrorInvalidValue;
    const size_t smem = smem_f32(C, th, tw);
    cudaError_t err =
        cudaFuncSetAttribute(mixffn_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(((H + th - 1) / th) * ((W + tw - 1) / tw), B);
    mixffn_f32<<<grid, kThreadsF32, smem, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w1),
        static_cast<const float*>(b1), static_cast<const float*>(dwk),
        static_cast<const float*>(dwb), static_cast<const float*>(w2),
        static_cast<const float*>(b2), static_cast<float*>(out), H, W, C, th, tw);
    return (int)cudaGetLastError();
  }
  if (dtype != 1 || th * tw > kOut || (th + 2) * (tw + 2) > 128 ||
      bf16_kernel(halo_groups(th, tw), C) == nullptr ||
      (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) || (split != 0 && split != 1) ||
      (split && (cluster > 4 * C / kHC || C > 128 * kMaxNT ||
                 (size_t)kOut * round_up(C, 128) * 4 > FfnLayout(C, halo_groups(th, tw), stages).tables)) ||
      stages < 2 || stages > kMaxStagesB)
    return (int)cudaErrorInvalidValue;
  return launch_bf16(x, w1, b1, dwk, dwb, w2, b2, out, B, H, W, C, th, tw, cluster, split, stages,
                     st);
}

const char* pf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// The Hopper GEMM building block of the bf16 ConvNeXt-block (convnext_block.cu)
// and whole-MiT-block (fused_block.cu) kernels: warpgroup MMAs (wgmma) with
// f32 accumulators in registers, operands in 64-byte-swizzled shared memory,
// and a ring of weight tiles that one producer thread fills by TMA, each
// stage behind a "full" and an "empty" mbarrier. In a thread-block cluster
// the ring is shared: every block loads 1/k of each tile and multicasts it
// to all k blocks, and a stage is refilled only once the consumers of all k
// blocks have released it.
//
// Layout. A bf16 operand with K columns is stored as K/32 "k-blocks", each
// rows x 32 values (64-byte rows), swizzled as TMA's CU_TENSOR_MAP_SWIZZLE_64B
// writes it: the 16-byte chunk j of row r lands at chunk j ^ ((r >> 1) & 3).
// wgmma reads it K-major through a descriptor (64-byte swizzle, 8-row groups
// 512 bytes apart); a k16 step inside a k-block adds 32 bytes. Both the A
// operand (activations, written by threads with ``swz``) and the B operand
// (weights as nn.Linear stores them, (out, in) = N x K, K contiguous) use it.
//
// Threads: two consumer warpgroups (256 threads) and one producer
// warpgroup, whose first thread issues the loads (a whole warpgroup, so
// that setmaxnreg can move its registers to the consumers).
#pragma once

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums only: cuTensorMapEncodeTiled is looked up at run time
#include <stdint.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kConsumerThreads = 256;                   // two consumer warpgroups
constexpr int kHopperThreads = kConsumerThreads + 128;  // + the producer warpgroup
constexpr int kKb = 32;                                 // bf16 columns of a k-block
constexpr int kStageBytes = 16384;                      // one ring stage

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Element offset of (row, col < 32) in a swizzled k-block of 32 columns.
__host__ __device__ __forceinline__ int swz(int row, int col) {
  return row * kKb + ((((col >> 3) ^ (row >> 1)) & 3) << 3) + (col & 7);
}

// Element offset of (row, k) in a swizzled operand of ``rows`` rows.
__device__ __forceinline__ int swz_at(int rows, int row, int k) {
  return (k / kKb) * rows * kKb + swz(row, k % kKb);
}

// ---------------------------------------------------------------------------
// wgmma: descriptors, fences, m64n32k16 / m64n64k16 with A from shared
// memory (ss), m64n64k16 with A from registers (rs), f32 accumulators
// ---------------------------------------------------------------------------

// K-major, 64-byte swizzle, 8-row groups 512 bytes apart; ``p`` is the first
// row of a k-block (plus 32 bytes for its second k16 step).
__device__ __forceinline__ uint64_t desc(const void* p) {
  const uint32_t a = smem_u32(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(512 >> 4) << 32) |
         ((uint64_t)2 << 62);
}

// The descriptor of rows [row0, row0 + n) at column k (k % 16 == 0) of a
// swizzled operand of ``rows`` rows starting at ``base``.
__device__ __forceinline__ uint64_t desc_at(const bf16* base, int rows, int row0, int k) {
  return desc(base + (k / kKb) * rows * kKb + row0 * kKb + (k % kKb));
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}
// Keep the compiler from moving accumulator reads/writes across the async MMAs.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define PF_R8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
                 "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

__device__ __forceinline__ void mma_n32_ss(float (&d)[16], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : PF_R8(0), PF_R8(8)
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void mma_n64_ss(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : PF_R8(0), PF_R8(8), PF_R8(16), PF_R8(24)
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void mma_n64_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                           int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, {%32,%33,%34,%35}, %36, p, 1, 1, 0;\n}\n"
      : PF_R8(0), PF_R8(8), PF_R8(16), PF_R8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

#undef PF_R8

// Where accumulator element i of a m64nN tile lives, for this thread of its
// warpgroup: row (0..63) and column (0..N-1).
__device__ __forceinline__ int acc_row(int i) {
  const int t = threadIdx.x % 128;
  return (t / 32) * 16 + (t % 32) / 4 + ((i >> 1) & 1) * 8;
}
__device__ __forceinline__ int acc_col(int i) { return (i >> 2) * 8 + (threadIdx.x % 4) * 2 + (i & 1); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The register A operand of k16 step s from a m64n64 accumulator already
// rounded by the caller: the accumulator's columns 16s .. 16s+15 are that
// step's k (the accumulator and A fragments share their row mapping).
__device__ __forceinline__ void acc_to_a(const float (&d)[32], int s, uint32_t (&a)[4]) {
  a[0] = pack_bf16(d[8 * s + 0], d[8 * s + 1]);
  a[1] = pack_bf16(d[8 * s + 2], d[8 * s + 3]);
  a[2] = pack_bf16(d[8 * s + 4], d[8 * s + 5]);
  a[3] = pack_bf16(d[8 * s + 6], d[8 * s + 7]);
}

// The register A operand of k16 step at column k from a swizzled operand
// of 64 rows in shared memory.
__device__ __forceinline__ void load_a(const bf16* base, int k, uint32_t (&a)[4]) {
  const int t = threadIdx.x % 128;
  const int r = (t / 32) * 16 + (t % 32) / 4, c = k + (t % 4) * 2;
  a[0] = *reinterpret_cast<const uint32_t*>(base + swz_at(64, r, c));
  a[1] = *reinterpret_cast<const uint32_t*>(base + swz_at(64, r + 8, c));
  a[2] = *reinterpret_cast<const uint32_t*>(base + swz_at(64, r, c + 8));
  a[3] = *reinterpret_cast<const uint32_t*>(base + swz_at(64, r + 8, c + 8));
}

// ---------------------------------------------------------------------------
// mbarriers, TMA, barriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// Arrive on the barrier at the same offset in the shared memory of block
// ``rank`` of the cluster (this block included).
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, int rank) {
  asm volatile(
      "{\n.reg .b32 remAddr32;\nmapa.shared::cluster.u32 remAddr32, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remAddr32];\n}\n" ::"r"(
          smem_u32(bar)),
      "r"(rank)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive_local(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Every thread of every block of the cluster (the producer warpgroup included).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Register rebalancing between the roles (setmaxnreg): ptxas caps a
// 384-thread block at 168 registers a thread, too few for the consumers'
// accumulators (wgmma would be serialised); the producer warpgroup gives
// its registers back (168 -> 40) and each consumer warpgroup takes them
// (168 -> 232), within the block's allocation. Each role calls its own
// once, at the top of its branch, which it never leaves.
__device__ __forceinline__ void producer_registers() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
}
__device__ __forceinline__ void consumer_registers() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
}

// Generic-proxy writes to shared memory made visible to wgmma / TMA: this
// block's (fence_async_smem), or any block's of the cluster before a
// cluster sync (fence_async_all).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void fence_async_all() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
}

// The two consumer warpgroups only (named barrier 1); the producer warpgroup
// never takes part.
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerThreads) : "memory");
}

// Bring a tensor map into the TMA unit's cache ahead of its first load.
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// 2-D TMA load of a box at (col, row) into ``dst``, completing on ``bar``;
// with mask != 0 multicast to the blocks of the cluster that the mask names.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int col, int row,
                                         uint64_t* bar, uint16_t mask) {
  const uint64_t m = reinterpret_cast<uint64_t>(map);
  if (mask == 0) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
        "l"(m), "r"(smem_u32(bar)), "r"(col), "r"(row)
        : "memory");
  } else {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster "
        "[%0], [%1, {%4, %5}], [%2], %3;\n" ::"r"(smem_u32(dst)),
        "l"(m), "r"(smem_u32(bar)), "h"(mask), "r"(col), "r"(row)
        : "memory");
  }
}

// ---------------------------------------------------------------------------
// The weight ring
// ---------------------------------------------------------------------------

// A ring stage holds one weight tile: rows [row0, row0 + rows) and columns
// [col0, col0 + cols) of an N x K weight, as cols / 32 swizzled k-blocks of
// ``rows`` rows (rows * cols * 2 <= kStageBytes). Rows or columns past the
// tensor's edge arrive as zeros (TMA's out-of-bounds fill), and count.
struct WTile {
  const CUtensorMap* map;  // box: 32 columns x rows / cluster rows
  int row0, col0, rows, cols;
};

// Both sides walk the same sequence of tiles. ``stages`` stages of
// kStageBytes from ``data``; full[s] and empty[s] for each. Consumers keep
// one stage's MMAs in flight: ``retire`` releases the stage before.
struct Ring {
  unsigned char* data;
  uint64_t* full;
  uint64_t* empty;
  int stages, stage, phase, pending;

  __device__ Ring(unsigned char* d, uint64_t* bars, int n)
      : data(d), full(bars), empty(bars + n), stages(n), stage(0), phase(0), pending(-1) {}

  // Every thread of the block, once, before the cluster's first sync: each
  // stage's empty barrier counts the 2 consumer warpgroups of every block.
  __device__ void init(int cluster) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < stages; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], 2 * cluster);
      }
      fence_barrier_init();
    }
  }

  __device__ void advance() {
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }

  // Producer (the whole producer warpgroup; its first thread issues): wait
  // until every block of the cluster released this stage, then load this
  // block's 1/cluster of the tile's rows into every block's stage (a plain
  // load when cluster == 1).
  __device__ void produce(const WTile& t, int cluster, int rank) {
    mbar_wait(&empty[stage], phase ^ 1);
    if (threadIdx.x == kConsumerThreads) {
      unsigned char* dst = data + (size_t)stage * kStageBytes;
      mbar_expect_tx(&full[stage], (uint32_t)(t.rows * t.cols * 2));
      const int part = t.rows / cluster;
      const uint16_t mask = cluster == 1 ? 0 : (uint16_t)((1u << cluster) - 1);
      for (int kb = 0; kb < t.cols / kKb; ++kb)
        tma_load(dst + ((size_t)kb * t.rows + rank * part) * kKb * 2, t.map, t.col0 + kb * kKb,
                 t.row0 + rank * part, &full[stage], mask);
    }
    __syncwarp();
    advance();
  }

  // Consumers: the stage's data once it has arrived.
  __device__ const bf16* wait() {
    mbar_wait(&full[stage], phase);
    return reinterpret_cast<const bf16*>(data + (size_t)stage * kStageBytes);
  }

  // Each consumer warpgroup releases stage s in every block of the
  // cluster, its thread r in block r (in this block alone when cluster ==
  // 1). The caller's wgmma wait has retired the warpgroup's MMAs on it.
  __device__ void release(int s, int cluster) {
    const int t = threadIdx.x % 128;
    if (cluster == 1) {
      if (t == 0) mbar_arrive_local(&empty[s]);
    } else if (t < cluster) {
      mbar_arrive_cluster(&empty[s], t);
    }
  }

  // Consumers, every thread, after committing this stage's MMAs: once the
  // stage before has no MMA in flight, release it; step on.
  __device__ void retire(int cluster) {
    wg_wait1();
    if (pending >= 0) release(pending, cluster);
    pending = stage;
    advance();
  }

  // Consumers: wait for every MMA and release the last stage. Call before
  // reading the accumulators or rewriting a register A operand.
  __device__ void drain(int cluster) {
    wg_wait0();
    if (pending >= 0) release(pending, cluster);
    pending = -1;
  }
};

// ---------------------------------------------------------------------------
// Host side: tensor maps through cudaGetDriverEntryPoint (no -lcuda)
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess || q != cudaDriverEntryPointSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
            cudaSuccess || q != cudaDriverEntryPointSuccess)
      return nullptr;
#endif
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A tensor map of a row-major (rows, cols) bf16 matrix whose box is 32
// columns x box_rows rows, 64-byte swizzle, zeros past the edges. Returns a
// cudaError_t (cudaErrorInvalidValue if the encoding is refused).
inline int make_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kKb, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Launch ``kernel`` with ``cluster`` blocks per cluster along x (grid.x a
// multiple of it, at most 8: the portable size); a size the card refuses
// (shared memory, cluster size) is returned as an error, never retried
// smaller.
template <typename... Params, typename... Args>
int launch_cluster(void (*kernel)(Params...), dim3 grid, int threads, size_t smem, int cluster,
                   cudaStream_t stream, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many clusters of ``cluster`` blocks of ``kernel`` the card runs at
// once (0 if none fits).
template <typename... Params>
int max_clusters(void (*kernel)(Params...), int threads, size_t smem, int cluster) {
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) !=
      cudaSuccess)
    return 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return n;
}

// ---------------------------------------------------------------------------
// The core as one GEMM, for the GPU tests: out (M x N, f32) = A (M x K) .
// W (N x K)^T, bf16, K % 32 == 0. A block takes 64 rows of A, staged by
// its consumers with ``swz`` and zero-padded to whole tiles, and streams W
// through the ring (columns past K arrive as zeros):
//   MODE 0 (A from shared memory, as the projections and fc1 run): tiles
//     of 64 rows x 128 columns, each warpgroup a m64n32 half of the rows;
//   MODE 1 (A from registers, as B4's pwconv2 runs): tiles of 128 rows x
//     64 columns, each warpgroup a m64n64 half of the rows, A's 64-column
//     slice loaded into registers.
// Every MMA of a stage is unconditional, so ptxas keeps them pipelined.
// ---------------------------------------------------------------------------

constexpr int kGemmStages = 4;

__host__ __device__ constexpr int round_up(int n, int m) { return (n + m - 1) / m * m; }

template <int MODE>
__global__ void __launch_bounds__(kHopperThreads, 1)
    gemm_core(const __grid_constant__ CUtensorMap wmap, const bf16* __restrict__ a,
              float* __restrict__ out, int M, int N, int K) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* base = smem_raw + (1024 - smem_u32(smem_raw) % 1024) % 1024;
  Ring ring(base, reinterpret_cast<uint64_t*>(base + kGemmStages * kStageBytes), kGemmStages);
  bf16* as = reinterpret_cast<bf16*>(base + kGemmStages * kStageBytes + 1024);  // 64 x Kp
  constexpr int kTileK = MODE == 0 ? 128 : 64, kTileN = MODE == 0 ? 64 : 128;
  const int Kp = round_up(K, kTileK), m0 = blockIdx.x * 64;
  ring.init(1);
  for (int i = threadIdx.x; i < 64 * Kp; i += blockDim.x) {
    const int r = i / Kp, k = i % Kp;
    as[swz_at(64, r, k)] =
        m0 + r < M && k < K ? a[(size_t)(m0 + r) * K + k] : __float2bfloat16(0.f);
  }
  fence_async_smem();
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // the producer warpgroup
    producer_registers();
    for (int n0 = 0; n0 < N; n0 += kTileN)
        for (int k0 = 0; k0 < Kp; k0 += kTileK) ring.produce({&wmap, n0, k0, kTileN, kTileK}, 1, 0);
    return;
  }
  consumer_registers();
  constexpr int kAcc = MODE == 0 ? 16 : 32;
  for (int n0 = 0; n0 < N; n0 += kTileN) {
    float d[kAcc];
    for (int k0 = 0; k0 < Kp; k0 += kTileK) {
      const bf16* w = ring.wait();
      if constexpr (MODE == 0) {
        wg_fence();
        fence_regs(d);
#pragma unroll
        for (int k = 0; k < kTileK; k += 16)
          mma_n32_ss(d, desc_at(as, 64, 0, k0 + k), desc_at(w, 64, 32 * wg, k), k0 + k > 0);
        wg_commit();
        ring.retire(1);
      } else {
        uint32_t af[4][4];
#pragma unroll
        for (int s = 0; s < 4; ++s) load_a(as, k0 + 16 * s, af[s]);
        wg_fence();
        fence_regs(d);
#pragma unroll
        for (int s = 0; s < 4; ++s)
          mma_n64_rs(d, af[s], desc_at(w, 128, 64 * wg, 16 * s), k0 + 16 * s > 0);
        wg_commit();
        ring.retire(1);
        ring.drain(1);  // the next stage rewrites the register A operand
      }
    }
    ring.drain(1);
    fence_regs(d);
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int r = m0 + acc_row(i), c = n0 + (kTileN / 2) * wg + acc_col(i);
      if (r < M && c < N) out[(size_t)r * N + c] = d[i];
    }
  }
}

inline size_t gemm_core_smem(int K) {
  return 1024 + kGemmStages * kStageBytes + 1024 + (size_t)64 * round_up(K, 128) * 2;
}

inline int launch_gemm_core(const void* a, const void* w, void* out, int M, int N, int K, int mode,
                            cudaStream_t stream) {
  if (M < 1 || N < 1 || K < 32 || K % 32 != 0 || (mode != 0 && mode != 1))
    return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  int err = make_map(&map, w, N, K, mode == 0 ? 64 : 128);
  if (err != 0) return err;
  const dim3 grid((M + 63) / 64);
  const size_t smem = gemm_core_smem(K);
  if (mode == 0)
    return launch_cluster(gemm_core<0>, grid, kHopperThreads, smem, 1, stream, map,
                          static_cast<const bf16*>(a), static_cast<float*>(out), M, N, K);
  return launch_cluster(gemm_core<1>, grid, kHopperThreads, smem, 1, stream, map,
                        static_cast<const bf16*>(a), static_cast<float*>(out), M, N, K);
}

}  // namespace

// Tusk's commit-path window kernels for Hopper (sm_90a).
//
// Replaces the jitted JAX programs of narwhal_tpu/ops/reachability.py:
//   window_apply            <- window_apply (donated scatter-add)
//   window_shift            <- window_shift_op (donated gather)
//   leader_commit_scan      <- leader_commit_scan_counts / _chain_scan
//   leader_chain_scan       <- leader_chain_scan (the same _chain_scan on
//                              bool inputs, with the per-slot reach masks)
//   causal_mask_scan        <- causal_mask_scan
//   support_stake           <- support_stake
//
// The commit path's window is int32 presence COUNTS: exists[W][N] and
// parent[W][N][N], where parent[w][n][m] != 0 means certificate (w, n)
// cites (w-1, m).  The flagship commit step and the causal-cone scan take
// the same window as bools.
//
// What bounds them on the card: at the main path's W = 64, N = 50 the
// whole parent window is 640 KB (160 KB as bools), so each kernel moves at
// most ~1.3 MB, far below what a launch latency's worth of bandwidth
// carries.  The apply, shift and support kernels are bound by launch
// latency; the three scans by the latency of their W dependent steps.  The
// design answers: the launch count (one launch per flush chunk, one per
// shift, one for the support gate, one for a whole W-step scan, whose
// steps loop inside the kernel instead of one launch per step), and
// inside the scans a step with no memory round trip and no block barrier:
// a cluster of blocks packs the window into bits in shared memory first,
// then one warp steps the scan on them (csrc/window_bits.cuh).  The
// kernels take N <= 1024.
//
// Each entry point launches on the caller's stream, allocates nothing and
// returns the cudaError_t of the launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "window_bits.cuh"

namespace {

// One thread per (row, column) of the flush.  Rows whose slot lies outside
// [0, W) (the padding, slot index W) are dropped.  atomicAdd because one
// flush may legitimately hit one cell twice: a full row and a repair row.
__global__ void window_apply_kernel(int32_t* __restrict__ exists,
                                    int32_t* __restrict__ parent,
                                    const int32_t* __restrict__ ins_w,
                                    const int32_t* __restrict__ ins_i,
                                    const int32_t* __restrict__ row_w,
                                    const int32_t* __restrict__ row_c,
                                    const int32_t* __restrict__ row_v,
                                    int W, int N, int C) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (int64_t)C * N) return;
  const int r = (int)(t / N);
  const int col = (int)(t % N);
  if (col == 0) {
    const int w = ins_w[r], i = ins_i[r];
    if (w >= 0 && w < W && i >= 0 && i < N) atomicAdd(&exists[w * N + i], 1);
  }
  const int w = row_w[r], c = row_c[r];
  if (w >= 0 && w < W && c >= 0 && c < N) {
    const int32_t v = row_v[(int64_t)r * N + col];
    if (v != 0) atomicAdd(&parent[((int64_t)w * N + c) * N + col], v);
  }
}

// Out of place: dst slot w takes src slot w + d; vacated slots and parent
// slot 0 are zero.  (In place, a thread would read slot w + d while another
// writes it.)
__global__ void window_shift_kernel(const int32_t* __restrict__ exists,
                                    const int32_t* __restrict__ parent,
                                    int32_t* __restrict__ out_exists,
                                    int32_t* __restrict__ out_parent, int d,
                                    int W, int N) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t slot_p = (int64_t)N * N;
  if (t >= (int64_t)W * slot_p) return;
  const int w = (int)(t / slot_p);
  const int64_t rem = t % slot_p;
  const int64_t src = (int64_t)w + d;
  out_parent[t] = (src < W && w > 0) ? parent[src * slot_p + rem] : 0;
  if (t < (int64_t)W * N) {
    const int we = (int)(t / N);
    const int64_t srce = (int64_t)we + d;
    out_exists[t] = srce < W ? exists[srce * N + t % N] : 0;
  }
}

// The three scans, one body (csrc/window_bits.cuh): T is int32_t for the
// count window (leader_commit_scan) and uint8_t for the bool window of the
// flagship commit step (leader_chain_scan) and the causal cone
// (causal_mask_scan, kCone: the start is ORed in and the frontier only
// accumulates).  NW is the number of 32-bit words of a row, rounded up to
// a power of two; the launch picks it from N.  All warps pack a chunk of
// slots into shared memory, then warp 0 steps it.  The block is 512
// threads up to NW = 16 and 256 at 32, so that warp 0's frontier and row
// words (2 * NW registers and more) fit the registers a thread may have
// at that block size and nothing spills to local memory.
__host__ __device__ constexpr int scan_block(int nw) {
  return nw <= 16 ? 512 : 256;
}

//
// The pack is spread over a cluster of kClusterBlocks blocks on as many
// SMs: one SM alone pulls the int32 window from L2 too slowly (on an H100
// the pack then took as long as the 64 steps), so every block packs its
// share of the groups straight into the first block's shared memory
// (distributed shared memory), and the first block's warp 0 steps the
// scan.  The cluster barrier takes the place of the block barrier.
constexpr int kClusterBlocks = 8;

// The last scan's cycles (window_scan): pack, scan, whole, chunks.
__device__ uint64_t scan_cycles[4];

template <typename T, int NW, bool kCone>
__global__ void __cluster_dims__(kClusterBlocks, 1, 1) __launch_bounds__(scan_block(NW), 1)
    window_scan_kernel(ntw::ScanArgs<T> a, int S) {
  extern __shared__ uint32_t scan_smem[];
  namespace cg = cooperative_groups;
  const cg::cluster_group cluster = cg::this_cluster();
  const int warps = (int)(blockDim.x >> 5);
  const ntw::WarpGroup g{(int)(threadIdx.x & 31)};
  const int rank = (int)cluster.block_rank();
  ntw::window_scan<T, NW, kCone>(
      g, rank * warps + (int)(threadIdx.x >> 5), kClusterBlocks * warps, a, S,
      scan_smem, cluster.map_shared_rank(scan_smem, 0),
      rank == 0 && threadIdx.x == 0 ? scan_cycles : nullptr);
}

// The f+1 support gate: the stake of the certificates at slot s+1 (s =
// leader_slot) that exist and cite the leader.  One block, one thread per
// child m, then a block sum.  The slot index follows the JAX program's
// dynamic index exactly: s+1 below 0 counts from the end once, and the
// result is clamped into [0, W).
__global__ void support_stake_kernel(const bool* __restrict__ parent,
                                     const bool* __restrict__ exists,
                                     const int32_t* __restrict__ stake,
                                     int leader_slot,
                                     const bool* __restrict__ leader_onehot,
                                     int32_t* __restrict__ out, int W, int N) {
  __shared__ int32_t warp_sums[32];
  const int m = threadIdx.x;
  int s = leader_slot + 1;
  if (s < 0) s += W;
  s = s < 0 ? 0 : (s >= W ? W - 1 : s);
  int32_t v = 0;
  if (m < N && exists[(int64_t)s * N + m]) {
    const bool* row = parent + ((int64_t)s * N + m) * N;
    bool vote = false;
    for (int n = 0; n < N; ++n) vote |= row[n] && leader_onehot[n];
    if (vote) v = stake[m];
  }
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int warps = blockDim.x / 32;
  if ((m & 31) == 0) warp_sums[m >> 5] = v;
  __syncthreads();
  if (m < 32) {
    v = m < warps ? warp_sums[m] : 0;
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (m == 0) *out = v;
  }
}

}  // namespace

extern "C" int nt_window_apply(void* exists, void* parent, const void* ins_w,
                               const void* ins_i, const void* row_w,
                               const void* row_c, const void* row_v, int W,
                               int N, int C, void* stream) {
  const int64_t threads = (int64_t)C * N;
  if (threads == 0) return (int)cudaSuccess;
  const int block = 256;
  const int grid = (int)((threads + block - 1) / block);
  window_apply_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (int32_t*)exists, (int32_t*)parent, (const int32_t*)ins_w,
      (const int32_t*)ins_i, (const int32_t*)row_w, (const int32_t*)row_c,
      (const int32_t*)row_v, W, N, C);
  return (int)cudaGetLastError();
}

extern "C" int nt_window_shift(const void* exists, const void* parent,
                               void* out_exists, void* out_parent, int d, int W,
                               int N, void* stream) {
  const int64_t threads = (int64_t)W * N * N;
  const int block = 256;
  const int grid = (int)((threads + block - 1) / block);
  window_shift_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const int32_t*)exists, (const int32_t*)parent, (int32_t*)out_exists,
      (int32_t*)out_parent, d, W, N);
  return (int)cudaGetLastError();
}

static int smem_optin_bytes(int* bytes) {
  int dev;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (int)rc;
}

// A scan is one cluster of kClusterBlocks blocks of scan_block(NW)
// threads over chunks of as many slots as fit in the card's shared
// memory, with the bytes set by cudaFuncSetAttribute above the 48 KB a
// launch gets without it.  Launches the scan, or with `attrs` non-null
// only fills attrs[0..6]:
// registers, local bytes and static shared bytes per thread
// (cudaFuncGetAttributes), block size, dynamic shared bytes per block,
// slots per chunk, blocks (one cluster).
template <typename T, int NW, bool kCone>
static int launch_scan_nw(const ntw::ScanArgs<T>& a, cudaStream_t stream,
                          int* attrs) {
  const auto kernel = window_scan_kernel<T, NW, kCone>;
  int limit;
  int rc = smem_optin_bytes(&limit);
  if (rc != 0) return rc;
  const int block = scan_block(NW);
  const int slots = ntw::chunk_slots(a.W, a.N, NW, limit);
  const int64_t smem = 4 * ntw::smem_words(slots, a.N, NW);
  if (smem > limit) return (int)cudaErrorInvalidValue;
  if (attrs != nullptr) {
    cudaFuncAttributes fa;
    rc = (int)cudaFuncGetAttributes(&fa, kernel);
    if (rc != 0) return rc;
    const int out[7] = {fa.numRegs, (int)fa.localSizeBytes, (int)fa.sharedSizeBytes,
                        block, (int)smem, slots, kClusterBlocks};
    for (int i = 0; i < 7; ++i) attrs[i] = out[i];
    return 0;
  }
  if (smem > 48 * 1024) {
    rc = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
    if (rc != 0) return rc;
  }
  kernel<<<kClusterBlocks, block, (size_t)smem, stream>>>(a, slots);
  return (int)cudaGetLastError();
}

template <typename T, bool kCone>
static int launch_scan(const ntw::ScanArgs<T>& a, void* stream, int* attrs) {
  if (a.N < 1 || a.N > 1024 || a.W < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (ntw::nw_class(a.N)) {
    case 1: return launch_scan_nw<T, 1, kCone>(a, st, attrs);
    case 2: return launch_scan_nw<T, 2, kCone>(a, st, attrs);
    case 4: return launch_scan_nw<T, 4, kCone>(a, st, attrs);
    case 8: return launch_scan_nw<T, 8, kCone>(a, st, attrs);
    case 16: return launch_scan_nw<T, 16, kCone>(a, st, attrs);
    default: return launch_scan_nw<T, 32, kCone>(a, st, attrs);
  }
}

extern "C" int nt_leader_commit_scan(const void* parent, const void* exists,
                                     const void* leader_onehot,
                                     const void* is_leader_slot,
                                     const void* anchor_onehot, int anchor_slot,
                                     void* committed, int W, int N,
                                     void* stream) {
  const ntw::ScanArgs<int32_t> a{
      (const int32_t*)parent, (const int32_t*)exists, (const uint8_t*)leader_onehot,
      (const uint8_t*)is_leader_slot, (const uint8_t*)anchor_onehot, anchor_slot,
      (uint8_t*)committed, nullptr, W, N};
  return launch_scan<int32_t, false>(a, stream, nullptr);
}

extern "C" int nt_leader_chain_scan(const void* parent, const void* exists,
                                    const void* leader_onehot,
                                    const void* is_leader_slot,
                                    const void* anchor_onehot, int anchor_slot,
                                    void* committed, void* reach, int W, int N,
                                    void* stream) {
  const ntw::ScanArgs<uint8_t> a{
      (const uint8_t*)parent, (const uint8_t*)exists, (const uint8_t*)leader_onehot,
      (const uint8_t*)is_leader_slot, (const uint8_t*)anchor_onehot, anchor_slot,
      (uint8_t*)committed, (uint8_t*)reach, W, N};
  return launch_scan<uint8_t, false>(a, stream, nullptr);
}

extern "C" int nt_causal_mask_scan(const void* parent, const void* exists,
                                   int start_slot, const void* start_onehot,
                                   void* mask, int W, int N, void* stream) {
  const ntw::ScanArgs<uint8_t> a{
      (const uint8_t*)parent, (const uint8_t*)exists, nullptr, nullptr,
      (const uint8_t*)start_onehot, start_slot, nullptr, (uint8_t*)mask, W, N};
  return launch_scan<uint8_t, true>(a, stream, nullptr);
}

// The cycles of the last scan launched, once it has finished (the caller
// synchronizes): out[0..3] = pack (up to the barrier that ends it), scan,
// whole, chunks, in the clock cycles of the SM of the cluster's first
// block.  A diagnostic: concurrent scans overwrite each other's.
extern "C" int nt_window_scan_cycles(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, scan_cycles, 4 * sizeof(uint64_t));
}

// The launch of scan `which` (0 leader_commit_scan, 1 leader_chain_scan,
// 2 causal_mask_scan) at (W, N), without launching: out[0..6] as
// launch_scan_nw fills them.
extern "C" int nt_window_scan_attributes(int which, int W, int N, int* out) {
  ntw::ScanArgs<int32_t> c{};
  ntw::ScanArgs<uint8_t> b{};
  c.W = b.W = W;
  c.N = b.N = N;
  switch (which) {
    case 0: return launch_scan<int32_t, false>(c, nullptr, out);
    case 1: return launch_scan<uint8_t, false>(b, nullptr, out);
    case 2: return launch_scan<uint8_t, true>(b, nullptr, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int nt_support_stake(const void* parent, const void* exists,
                                const void* stake, int leader_slot,
                                const void* leader_onehot, void* out, int W,
                                int N, void* stream) {
  if (N < 1 || N > 1024 || W < 1) return (int)cudaErrorInvalidValue;
  const int block = (N + 31) / 32 * 32;
  support_stake_kernel<<<1, block, 0, (cudaStream_t)stream>>>(
      (const bool*)parent, (const bool*)exists, (const int32_t*)stake,
      leader_slot, (const bool*)leader_onehot, (int32_t*)out, W, N);
  return (int)cudaGetLastError();
}

// Tusk's commit-path window kernels for Hopper (sm_90a).
//
// Replaces the jitted JAX programs of narwhal_tpu/ops/reachability.py:
//   window_update           <- window_shift_op followed by window_apply (the
//                              donated gather and scatter-add), one launch
//                              over a mirrored ring window
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
// carries.  The update and support kernels are bound by launch latency;
// the three scans by the latency of their W dependent steps.  The design
// answers: the launch count (one update launch per commit opportunity for
// both the flush and the pending shift, one for the support gate, one for
// a whole W-step scan, whose steps loop inside the kernel instead of one
// launch per step), a shift that moves no counts (the ring's origin moves
// and only the retired slots are zeroed), and inside the scans a step with
// no memory round trip and no block barrier: a cluster of blocks packs
// the window into bits in shared memory first, then one warp steps the
// scan on them (csrc/window_bits.cuh).  The kernels take N <= 1024.
//
// Each entry point launches on the caller's stream, allocates nothing and
// returns the cudaError_t of the launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "window_bits.cuh"

namespace {

// window_update: the window's pending shift (JAX window_shift_op) and the
// flush of staged certificates (JAX window_apply) in one launch, over a
// MIRRORED RING.  The commit path keeps 2W physical slots, slot p and slot
// p + W always equal, so logical slot w is physical (origin + w) mod W and
// the logical window is the contiguous range [origin, origin + W) that the
// scans read unchanged.  A shift by d < W moves the origin on the host and
// leaves the retired slots to the next launch: no count moves.  The launch
//   1. zeroes the `retired` physical slots just below the origin (exists
//      and parent) and, with clear_slot0, the parent block of the origin
//      itself (JAX's slot 0 keeps no parent edges), in both copies;
//   2. adds the staged rows, parent[row_w, row_c, :] += row_v, and the
//      insert entries, exists[ins_w, ins_i] += 1, at logical slots, to both
//      copies, with atomics whose result is unused (RED).  Counts stay
//      counts: duplicate rows add, as JAX's scatter-add does.
// Without the mirror (buffers of W slots, origin 0, nothing retired) it is
// the standalone window_apply.
//
// The grid has two kinds of blocks of kUpdateThreads, so that the stores
// of a clear and the adds of a flush run on different SMs (on one SM they
// queue behind each other, as measured on an H100 in PERF.md).  A parent
// row q = s * N + c (s a physical slot in [0, W)) is cut into `chunks`
// chunks of kChunkCols columns, and a warp adds a row chunk by loading its
// values at once, then adding them.  Both kinds read the flush's index
// vectors kUpdateThreads entries a round; padding rows (slot outside
// [0, W)) are never read.
//   - Adders, 32 * chunks blocks: the entries whose slot is not being
//     cleared need no order, so adder l * chunks + k applies chunk k of
//     the row at lane l of every warp's 32 entries (one row chunk a warp a
//     round), and the insert at lane l in adder l * chunks.  On the commit
//     path every staged row is such (new rounds land above the retired
//     slots): the launch's chain is one load of the indices, one of the
//     values, then the adds.
//   - Clearers, a power of two B of them: unit u = q * chunks + k of a
//     cleared slot belongs to clearer u mod B, in both copies, and the
//     exists cell q to the owner of the row's first chunk.  A clearer
//     zeroes its units, waits at one __syncthreads, then applies the
//     entries that land in its units (a flush into the slots it just
//     retired, when the window's rounds reach its top).
// All index arithmetic is 32-bit: the launcher refuses a window of more
// than 2^31 - 1 parent counts.
struct UpdateArgs {
  int32_t* exists;  // [S][N], S = W, or 2W with the mirror
  int32_t* parent;  // [S][N][N]
  const int32_t* ins_w;
  const int32_t* ins_i;
  const int32_t* row_w;
  const int32_t* row_c;
  const int32_t* row_v;  // [C][N]
  int W, N, C;
  int origin;       // physical slot of logical slot 0, in [0, W)
  int mirror;       // 1: slot p + W repeats slot p
  int retired;      // slots below the origin to zero, in [0, W)
  int clear_slot0;  // zero the parent block of slot `origin`
};

constexpr int kUpdateThreads = 256;
constexpr int kChunkCols = 256;

// Zero n int32s from p by one warp: 16-byte stores where p and n allow.
__device__ __forceinline__ void zero_cols(int32_t* p, int n, int lane) {
  if ((n & 3) == 0 && ((uintptr_t)p & 15) == 0) {
    int4* v = reinterpret_cast<int4*>(p);
    for (int k = lane; k < (n >> 2); k += 32) v[k] = make_int4(0, 0, 0, 0);
  } else {
    for (int k = lane; k < n; k += 32) p[k] = 0;
  }
}

// dst[col] += src[col] for the n <= kChunkCols columns of a row chunk, in
// each copy, by one warp: every load first, then the adds.
__device__ __forceinline__ void add_cols(int32_t* dst, const int32_t* src, int n,
                                         int lane, int copies, int mirror_p) {
  constexpr int kSpan = kChunkCols / 32;
  int32_t x[kSpan];
#pragma unroll
  for (int i = 0; i < kSpan; ++i) x[i] = i * 32 + lane < n ? src[i * 32 + lane] : 0;
#pragma unroll
  for (int i = 0; i < kSpan; ++i)
    if (x[i] != 0)
      for (int c = 0; c < copies; ++c) atomicAdd(dst + c * mirror_p + i * 32 + lane, x[i]);
}

// One round's entry of this thread, resolved: the row's q, or -1 where the
// row is padding; the insert's cell, or -1; whether each lands in a slot
// being cleared.
struct Entry {
  int q, qi;
  bool row_cleared, ins_cleared;
};

__device__ __forceinline__ Entry resolve(const UpdateArgs& a, int rw, int rc, int iw,
                                         int ii, int from) {
  const int W = a.W, N = a.N;
  Entry e{-1, -1, false, false};
  if (rw >= 0 && rw < W && rc >= 0 && rc < N) {
    const int p = a.origin + rw - (a.origin + rw >= W ? W : 0);
    const int d = p - from + (p < from ? W : 0);
    e.q = p * N + rc;
    e.row_cleared = d < a.retired || (a.clear_slot0 && p == a.origin);
  }
  if (iw >= 0 && iw < W && ii >= 0 && ii < N) {
    const int p = a.origin + iw - (a.origin + iw >= W ? W : 0);
    const int d = p - from + (p < from ? W : 0);
    e.qi = p * N + ii;
    e.ins_cleared = d < a.retired;
  }
  return e;
}

__global__ void __launch_bounds__(kUpdateThreads)
    window_update_kernel(UpdateArgs a, int adders) {
  const int lane = (int)(threadIdx.x & 31), warp = (int)(threadIdx.x >> 5);
  const int W = a.W, N = a.N;
  const int chunks = (N + kChunkCols - 1) / kChunkCols;
  const int copies = 1 + a.mirror, mirror_e = W * N, mirror_p = W * N * N;
  const bool adder = (int)blockIdx.x < adders;
  const int b = (int)blockIdx.x - (adder ? 0 : adders);
  const int B = (int)gridDim.x - adders;  // clearers
  int from = a.origin - a.retired;
  if (from < 0) from += W;
  if (!adder) {
    const int first = min(a.retired, W - from);
    // Three runs of rows: the retired slots (one run, or two where they
    // wrap below slot 0; with their exists cells) and the origin's parent.
    for (int run = 0; run < 3; ++run) {
      int lo = from * N, hi = (from + first) * N;
      if (run == 1) lo = 0, hi = (a.retired - first) * N;
      if (run == 2) {
        if (!a.clear_slot0) break;
        lo = a.origin * N, hi = lo + N;
      }
      const int ulo = lo * chunks, uhi = hi * chunks, warps = kUpdateThreads / 32;
      for (int u = ulo + ((b - ulo) & (B - 1)) + warp * B; u < uhi; u += warps * B) {
        const int q = u / chunks, c0 = (u - q * chunks) * kChunkCols;
        for (int c = 0; c < copies; ++c) {
          zero_cols(a.parent + q * N + c * mirror_p + c0, min(kChunkCols, N - c0), lane);
          if (run < 2 && c0 == 0 && lane == 0) a.exists[q + c * mirror_e] = 0;
        }
      }
    }
    __syncthreads();
  }
  const int my_lane = b / chunks, c0 = (b - my_lane * chunks) * kChunkCols;  // an adder's
  for (int base = 0; base < a.C; base += kUpdateThreads) {
    const int k = base + (int)threadIdx.x;
    const Entry e = k < a.C ? resolve(a, a.row_w[k], a.row_c[k], a.ins_w[k], a.ins_i[k], from)
                            : Entry{-1, -1, false, false};
    if (adder) {
      if (e.qi >= 0 && !e.ins_cleared && lane * chunks == b)
        for (int c = 0; c < copies; ++c) atomicAdd(a.exists + e.qi + c * mirror_e, 1);
      const int q = __shfl_sync(0xffffffffu, e.row_cleared ? -1 : e.q, my_lane);
      if (q >= 0)
        add_cols(a.parent + q * N + c0, a.row_v + (base + warp * 32 + my_lane) * N + c0,
                 min(kChunkCols, N - c0), lane, copies, mirror_p);
      continue;
    }
    if (e.qi >= 0 && e.ins_cleared && ((e.qi * chunks) & (B - 1)) == b)
      for (int c = 0; c < copies; ++c) atomicAdd(a.exists + e.qi + c * mirror_e, 1);
    for (int j = 0; j < chunks; ++j) {
      const bool own = e.q >= 0 && e.row_cleared && ((e.q * chunks + j) & (B - 1)) == b;
      for (unsigned m = __ballot_sync(0xffffffffu, own); m != 0; m &= m - 1) {
        const int l = __ffs(m) - 1, cj = j * kChunkCols;
        add_cols(a.parent + __shfl_sync(0xffffffffu, e.q, l) * N + cj,
                 a.row_v + (base + warp * 32 + l) * N + cj, min(kChunkCols, N - cj), lane,
                 copies, mirror_p);
      }
    }
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

extern "C" int nt_window_update(void* exists, void* parent, const void* ins_w,
                                const void* ins_i, const void* row_w,
                                const void* row_c, const void* row_v, int W, int N,
                                int C, int origin, int mirror, int retired,
                                int clear_slot0, void* stream) {
  if (N < 1 || N > 1024 || W < 1 || C < 0 || origin < 0 || origin >= W ||
      retired < 0 || retired >= W || (mirror != 0 && mirror != 1) ||
      (int64_t)(1 + mirror) * W * N * N > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const UpdateArgs a{(int32_t*)exists, (int32_t*)parent, (const int32_t*)ins_w,
                     (const int32_t*)ins_i, (const int32_t*)row_w, (const int32_t*)row_c,
                     (const int32_t*)row_v, W, N, C, origin, mirror, retired,
                     clear_slot0 != 0};
  // The adders, and about one row chunk to zero a warp of the clearers.
  const int chunks = (N + kChunkCols - 1) / kChunkCols;
  const int adders = C > 0 ? 32 * chunks : 0;
  const int units = (retired + a.clear_slot0) * N * chunks;
  int clearers = units > 0 ? 16 : 0;
  while (clearers > 0 && clearers < 512 && clearers * (kUpdateThreads / 32) < units)
    clearers <<= 1;
  if (adders + clearers == 0) return (int)cudaSuccess;
  window_update_kernel<<<adders + clearers, kUpdateThreads, 0, (cudaStream_t)stream>>>(
      a, adders);
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

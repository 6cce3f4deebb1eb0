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
//   commit_step             <- support_stake and leader_chain_scan traced as
//                              one program (__graft_entry__.make_commit_step):
//                              the chain scan's launch, with the support
//                              gate on its idle blocks
//   chain_step_block,       <- the same program under jax.jit over a
//   support_votes_block        `committee` mesh (__graft_entry__.py:147-193),
//                              which GSPMD partitions on the cited parent's
//                              column: one descending slot of _chain_scan, and
//                              the support gate's per-child votes, on one
//                              rank's block of columns
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
// both the flush and the pending shift, one for a whole W-step scan, whose
// steps loop inside the kernel instead of one launch per step, and one for
// the flagship commit step, whose support gate runs beside its scan), a
// shift that moves no counts (the ring's origin moves
// and only the retired slots are zeroed), and inside the scans a step with
// no memory round trip and no block barrier: a cluster of blocks packs
// the window into bits in shared memory first, then one warp steps the
// scan on them (csrc/window_bits.cuh).  The kernels take N <= 1024.
//
// Each entry point launches on the caller's stream, allocates nothing and
// returns the cudaError_t of the launch.

#include <cstdint>
#include <initializer_list>
#include <type_traits>

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
//      counts: duplicate rows add, as JAX's scatter-add does.  A slot or
//      authority index below 0 counts from the end once and what is still
//      out of range is dropped, as JAX's .at[...].add(mode="drop") does;
//      the ring's origin applies after that.
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
  // JAX's indexing first: a slot in [-W, 0) or an authority in [-N, 0)
  // counts from the end; what is still out of range is dropped.
  rw += rw < 0 ? W : 0;
  iw += iw < 0 ? W : 0;
  rc += rc < 0 ? N : 0;
  ii += ii < 0 ? N : 0;
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
// slots into shared memory, then warp 0 steps it; the block is
// ntw::scan_block(NW) threads.
//
// The pack is spread over a cluster of kClusterBlocks blocks on as many
// SMs: one SM alone pulls the int32 window from L2 too slowly (on an H100
// the pack then took as long as the 64 steps), so every block packs its
// share of the groups straight into the first block's shared memory
// (distributed shared memory), and the first block's warp 0 steps the
// scan.  The cluster barrier takes the place of the block barrier.
using ntw::kClusterBlocks;
using ntw::scan_block;

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

// The split cluster barrier (PTX barrier.cluster): every thread of the
// cluster arrives once in a phase, and a thread that waits returns when all
// have arrived; an arrive with release orders the thread's earlier writes,
// distributed shared memory atomics included, before the waiter's reads.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

// The flagship commit step in one launch (JAX: support_stake and
// leader_chain_scan traced as one program, __graft_entry__.make_commit_step):
// leader_chain_scan's cluster and body, then the f+1 support gate
// (ntw::support_gate) on the blocks that are idle after the last pack,
// while warp 0 steps the chain.  window_scan returns to every warp but
// warp 0 right after the last pack's cluster barrier; there
//   - the warps of blocks 1..7 whose gate index k = 7 * (warp in block) +
//     rank - 1 is below the number of row groups run the gate, add their
//     part into one word of the first block's shared memory (an atomic
//     through distributed shared memory; the word is zeroed before the
//     first pack's barrier), and arrive at the cluster barrier with
//     release;
//   - warp 1 of the first block arrives and waits, then writes `support`;
//   - every other thread arrives and leaves;
// and warp 0 arrives once its last step is done.  So nothing is added to
// the steps, and neither they nor the support need a second launch or a
// memset.  The gate runs after the
// LAST pack, the one place where nothing waits for it: where the window
// is scanned in chunks the idle blocks pack every chunk, and a gate in an
// earlier window would hold back the next pack whenever it outlasted the
// steps of the chunk before.  The word lies behind the scan's (and the
// gate's) dynamic shared memory: static shared memory would move the
// dynamic words off the alignment the pack's stores have in the scan
// alone.
template <int NW>
__device__ __forceinline__ void commit_gate(const ntw::GateArgs& gate, uint32_t* smem,
                                            int32_t* word, int32_t* support, int rank,
                                            int block_warp, int lane) {
  if (rank == 0) {
    cluster_arrive_relaxed();
    if (block_warp == 1) {
      cluster_wait();
      if (lane == 0) *support = *word;
    }
    return;
  }
  const int k = (kClusterBlocks - 1) * block_warp + rank - 1;
  if (k < ntw::gate_groups(gate.N)) {
    const uint32_t part =
        ntw::support_gate<NW>(ntw::WarpGroup{lane}, k, ntw::gate_warps(NW), gate,
                              smem + block_warp * ntw::gate_words(gate.N, NW));
    if (lane == 0 && part != 0) atomicAdd(word, (int32_t)part);
    cluster_arrive_release();
  } else {
    cluster_arrive_relaxed();
  }
}

template <int NW>
__global__ void __cluster_dims__(kClusterBlocks, 1, 1) __launch_bounds__(scan_block(NW), 1)
    commit_step_kernel(ntw::ScanArgs<uint8_t> a, ntw::GateArgs gate, int32_t* support,
                       int S, int word_offset) {
  extern __shared__ uint32_t scan_smem[];
  namespace cg = cooperative_groups;
  const cg::cluster_group cluster = cg::this_cluster();
  const int warps = (int)(blockDim.x >> 5), block_warp = (int)(threadIdx.x >> 5);
  const int lane = (int)(threadIdx.x & 31), rank = (int)cluster.block_rank();
  int32_t* word = reinterpret_cast<int32_t*>(scan_smem + word_offset);
  if (rank == 0 && threadIdx.x == 32) *word = 0;
  ntw::window_scan<uint8_t, NW, false>(
      ntw::WarpGroup{lane}, rank * warps + block_warp, kClusterBlocks * warps, a, S,
      scan_smem, cluster.map_shared_rank(scan_smem, 0),
      rank == 0 && threadIdx.x == 0 ? scan_cycles : nullptr);
  if (rank == 0 && block_warp == 0) {
    cluster_arrive_relaxed();  // the steps are done
    return;
  }
  commit_gate<NW>(gate, scan_smem, cluster.map_shared_rank(word, 0), support, rank,
                  block_warp, lane);
}

// The standalone support gate (JAX support_stake): one block of one warp a
// group of 32 rows, up to kGateBlockWarps, each running ntw::support_gate
// on its own shared memory; the warps' parts meet behind one barrier.  It
// replaces one thread a row walking the row's N bytes one by one.
constexpr int kGateBlockWarps = 16;

template <int NW>
__global__ void __launch_bounds__(32 * kGateBlockWarps)
    support_stake_kernel(ntw::GateArgs a, int32_t* __restrict__ out) {
  extern __shared__ uint32_t gate_smem[];
  __shared__ uint32_t parts[kGateBlockWarps];
  const int lane = (int)(threadIdx.x & 31), warp = (int)(threadIdx.x >> 5);
  const int warps = (int)(blockDim.x >> 5);
  const uint32_t part = ntw::support_gate<NW>(
      ntw::WarpGroup{lane}, warp, warps, a, gate_smem + warp * ntw::gate_words(a.N, NW));
  if (lane == 0) parts[warp] = part;
  __syncthreads();
  if (warp == 0) {
    const uint32_t sum = __reduce_add_sync(0xffffffffu, lane < warps ? parts[lane] : 0u);
    if (lane == 0) *out = (int32_t)sum;
  }
}

// The committee-sharded commit step.  Rank r of k holds the columns
// [r * Nb, (r + 1) * Nb) of the window's cited-parent axis (Nb =
// ceil(N / k), the last block padded with columns that do not exist), and
// every slot's step needs the whole frontier, so the ranks all-gather each
// step's (g, g & leader) blocks (ops/reachability.py, commit_step_sharded).
//
// chain_step_block: one descending slot w on a rank's columns.  The block
// first rebuilds the frontier from the gathered record of slot w + 1,
// prev[k][2][Nb]: its g & leader where that slot is a leader slot and any
// of those bits is set (the chain's reset to the leader), else its g; it
// lists the frontier's rows in shared memory.  Then one thread a column
// ORs the listed rows of parent[w + 1] in that column (a warp's 32 loads of
// one row are neighbours) and ANDs exists and the leader.  What bounds it
// on the card: the bytes of the frontier's rows in the rank's columns,
// |frontier| * Nb, at most 50 * 13 bytes at the flagship's N = 50 over four
// ranks, so one launch costs its latency; the design keeps it to one
// launch a slot with no host work between (the frontier's rebuild is
// inside it), which is what lets a step's W launches and gathers be
// enqueued whole.
constexpr int kBlockStepThreads = 128;

struct BlockStepArgs {
  const uint8_t* parent_up;  // [N][Nb]: parent[w + 1] on the rank's columns
  const uint8_t* exists;     // [Nb]: exists[w] on the rank's columns
  const uint8_t* leader;     // [Nb]: leader_onehot[w] on the rank's columns
  const uint8_t* prev;       // [k][2][Nb]: every rank's (g, g & leader) at w + 1
  const uint8_t* prev_lead;  // is_leader_slot[w + 1]
  uint8_t* out;              // [2][Nb]: this rank's (g, g & leader) at w
  int N, Nb;
};

__global__ void __launch_bounds__(kBlockStepThreads)
    chain_step_block_kernel(BlockStepArgs a) {
  __shared__ int rows[1024];
  __shared__ int count;
  const int t = (int)threadIdx.x;
  if (t == 0) count = 0;
  // Gathered element i of a half (0: g, 1: g & leader) of slot w + 1.
  auto at = [&](int i, int half) {
    const int r = i / a.Nb;
    return a.prev[(2 * r + half) * a.Nb + (i - r * a.Nb)];
  };
  int any = 0;
  for (int i = t; i < a.N; i += kBlockStepThreads) any |= at(i, 1);
  const int half = __syncthreads_or(any) && *a.prev_lead ? 1 : 0;
  for (int i = t; i < a.N; i += kBlockStepThreads)
    if (at(i, half)) rows[atomicAdd(&count, 1)] = i;
  __syncthreads();
  const int j = (int)blockIdx.x * kBlockStepThreads + t;
  if (j >= a.Nb) return;
  uint8_t hit = 0;
  for (int q = 0; q < count && !hit; ++q) hit = a.parent_up[rows[q] * a.Nb + j];
  const uint8_t g = hit & a.exists[j];
  a.out[j] = g;
  a.out[a.Nb + j] = g & a.leader[j];
}

// support_votes_block: the f+1 gate's votes on a rank's columns,
// votes[i] = OR over the rank's columns j of parent_s[i][j] & leader[j],
// one warp a child row (its lanes' loads are neighbours), for the ranks
// to OR together.  Bound by its N * Nb bytes, a launch's latency at the
// main path's shapes.
constexpr int kVotesWarps = 8;

__global__ void __launch_bounds__(32 * kVotesWarps)
    support_votes_block_kernel(const uint8_t* __restrict__ parent_s,
                               const uint8_t* __restrict__ leader,
                               uint8_t* __restrict__ votes, int N, int Nb) {
  const int lane = (int)(threadIdx.x & 31);
  const int i = (int)blockIdx.x * kVotesWarps + (int)(threadIdx.x >> 5);
  if (i >= N) return;
  int v = 0;
  for (int j = lane; j < Nb; j += 32) v |= parent_s[i * Nb + j] & leader[j];
  v = __any_sync(0xffffffffu, v);
  if (lane == 0) votes[i] = (uint8_t)v;
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

// Calls f with std::integral_constant<int, NW>, NW the row words of N.
template <class F>
static int by_nw(int n, F&& f) {
  switch (ntw::nw_class(n)) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 8: return f(std::integral_constant<int, 8>{});
    case 16: return f(std::integral_constant<int, 16>{});
    default: return f(std::integral_constant<int, 32>{});
  }
}

// Launches `kernel` with `smem` dynamic shared bytes (above the 48 KB a
// launch gets without it only after cudaFuncSetAttribute), or with `attrs`
// non-null only fills attrs[0..2 + extra]: registers, local bytes and static
// shared bytes per thread (cudaFuncGetAttributes), then `extra` values.
template <class K, class... Args>
static int launch_or_describe(K kernel, dim3 grid, int block, int64_t smem,
                              cudaStream_t stream, int* attrs,
                              std::initializer_list<int> extra, Args... args) {
  if (attrs != nullptr) {
    cudaFuncAttributes fa;
    const int rc = (int)cudaFuncGetAttributes(&fa, kernel);
    if (rc != 0) return rc;
    attrs[0] = fa.numRegs;
    attrs[1] = (int)fa.localSizeBytes;
    attrs[2] = (int)fa.sharedSizeBytes;
    int i = 3;
    for (int v : extra) attrs[i++] = v;
    return 0;
  }
  if (smem > 48 * 1024) {
    const int rc = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != 0) return rc;
  }
  kernel<<<grid, block, (size_t)smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// A scan is one cluster of kClusterBlocks blocks of scan_block(NW)
// threads over chunks of as many slots as fit in the card's shared
// memory.  Launches the scan, or with `attrs` non-null only fills
// attrs[0..6]: registers, local bytes and static shared bytes per thread,
// block size, dynamic shared bytes per block, slots per chunk, blocks (one
// cluster).
template <typename T, int NW, bool kCone>
static int launch_scan_nw(const ntw::ScanArgs<T>& a, cudaStream_t stream,
                          int* attrs) {
  int limit;
  const int rc = smem_optin_bytes(&limit);
  if (rc != 0) return rc;
  const int block = scan_block(NW);
  const int slots = ntw::chunk_slots(a.W, a.N, NW, limit);
  const int64_t smem = 4 * ntw::smem_words(slots, a.N, NW);
  if (smem > limit) return (int)cudaErrorInvalidValue;
  return launch_or_describe(window_scan_kernel<T, NW, kCone>, kClusterBlocks, block,
                            smem, stream, attrs,
                            {block, (int)smem, slots, kClusterBlocks}, a, slots);
}

template <typename T, bool kCone>
static int launch_scan(const ntw::ScanArgs<T>& a, void* stream, int* attrs) {
  if (a.N < 1 || a.N > 1024 || a.W < 0) return (int)cudaErrorInvalidValue;
  return by_nw(a.N, [&](auto nw) {
    return launch_scan_nw<T, decltype(nw)::value, kCone>(a, (cudaStream_t)stream, attrs);
  });
}

// The commit step's launch: the chain scan's, with shared memory for the
// gate's warps too (each warp of an idle block that holds a row group
// packs it in its block's own shared memory) and, behind both, the word of
// the support sum.
template <int NW>
static int launch_commit_nw(const ntw::ScanArgs<uint8_t>& a, const ntw::GateArgs& gate,
                            int32_t* support, cudaStream_t stream, int* attrs) {
  int limit;
  const int rc = smem_optin_bytes(&limit);
  if (rc != 0) return rc;
  const int block = scan_block(NW);
  const int slots = ntw::chunk_slots(a.W, a.N, NW, limit - 4);
  const int gate_block_warps =
      (ntw::gate_groups(a.N) + kClusterBlocks - 2) / (kClusterBlocks - 1);
  const int64_t gate_words = (int64_t)gate_block_warps * ntw::gate_words(a.N, NW);
  const int64_t scan_words = ntw::smem_words(slots, a.N, NW);
  const int64_t words = scan_words > gate_words ? scan_words : gate_words;
  const int64_t smem = 4 * (words + 1);
  if (smem > limit) return (int)cudaErrorInvalidValue;
  return launch_or_describe(commit_step_kernel<NW>, kClusterBlocks, block, smem, stream,
                            attrs, {block, (int)smem, slots, kClusterBlocks}, a, gate,
                            support, slots, (int)words);
}

static int launch_commit(const ntw::ScanArgs<uint8_t>& a, const ntw::GateArgs& gate,
                         int32_t* support, void* stream, int* attrs) {
  if (a.N < 1 || a.N > 1024 || a.W < 1 || gate.slot < 0 || gate.slot >= a.W)
    return (int)cudaErrorInvalidValue;
  return by_nw(a.N, [&](auto nw) {
    return launch_commit_nw<decltype(nw)::value>(a, gate, support, (cudaStream_t)stream,
                                                 attrs);
  });
}

// The standalone gate: one block of min(row groups, kGateBlockWarps) warps.
// Launches, or with `attrs` non-null only fills attrs[0..4]: registers,
// local and static shared bytes per thread, block size, dynamic shared
// bytes.
static int launch_support(const ntw::GateArgs& a, int W, int32_t* out, void* stream,
                          int* attrs) {
  if (a.N < 1 || a.N > 1024 || W < 1 || a.slot < 0 || a.slot >= W)
    return (int)cudaErrorInvalidValue;
  int limit;
  const int rc = smem_optin_bytes(&limit);
  if (rc != 0) return rc;
  return by_nw(a.N, [&](auto nw) {
    constexpr int NW = decltype(nw)::value;
    const int groups = ntw::gate_groups(a.N);
    const int warps = groups < kGateBlockWarps ? groups : kGateBlockWarps;
    const int64_t smem = 4LL * warps * ntw::gate_words(a.N, NW);
    if (smem > limit - 4 * kGateBlockWarps) return (int)cudaErrorInvalidValue;
    return launch_or_describe(support_stake_kernel<NW>, 1, 32 * warps, smem,
                              (cudaStream_t)stream, attrs, {32 * warps, (int)smem}, a, out);
  });
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

// The flagship commit step: the chain scan's outputs, and in `support` the
// gate's stake sum of child slot gate_slot against row leader_row of
// leader_onehot (both resolved by the caller with JAX's index rule).
extern "C" int nt_commit_step(const void* parent, const void* exists,
                              const void* leader_onehot, const void* is_leader_slot,
                              const void* anchor_onehot, int anchor_slot,
                              const void* stake, int gate_slot, int leader_row,
                              void* support, void* committed, void* reach, int W,
                              int N, void* stream) {
  if (leader_row < 0 || leader_row >= W) return (int)cudaErrorInvalidValue;
  const ntw::ScanArgs<uint8_t> a{
      (const uint8_t*)parent, (const uint8_t*)exists, (const uint8_t*)leader_onehot,
      (const uint8_t*)is_leader_slot, (const uint8_t*)anchor_onehot, anchor_slot,
      (uint8_t*)committed, (uint8_t*)reach, W, N};
  const ntw::GateArgs gate{(const uint8_t*)parent, (const uint8_t*)exists,
                           (const int32_t*)stake,
                           (const uint8_t*)leader_onehot + (int64_t)leader_row * N,
                           gate_slot, N};
  return launch_commit(a, gate, (int32_t*)support, stream, nullptr);
}

// The stake of the certificates at child slot `slot` (resolved by the
// caller with JAX's index rule) that exist and cite the leader.
extern "C" int nt_support_stake(const void* parent, const void* exists,
                                const void* stake, int slot,
                                const void* leader_onehot, void* out, int W,
                                int N, void* stream) {
  const ntw::GateArgs a{(const uint8_t*)parent, (const uint8_t*)exists,
                        (const int32_t*)stake, (const uint8_t*)leader_onehot, slot, N};
  return launch_support(a, W, (int32_t*)out, stream, nullptr);
}

// The cycles of the last scan launched, once it has finished (the caller
// synchronizes): out[0..3] = pack (up to the barrier that ends it), scan,
// whole, chunks, in the clock cycles of the SM of the cluster's first
// block.  A diagnostic: concurrent scans overwrite each other's.
extern "C" int nt_window_scan_cycles(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, scan_cycles, 4 * sizeof(uint64_t));
}

// The launch of scan `which` (0 leader_commit_scan, 1 leader_chain_scan,
// 2 causal_mask_scan, 3 the commit step) at (W, N), without launching:
// out[0..6] as launch_scan_nw fills them.
extern "C" int nt_window_scan_attributes(int which, int W, int N, int* out) {
  ntw::ScanArgs<int32_t> c{};
  ntw::ScanArgs<uint8_t> b{};
  c.W = b.W = W;
  c.N = b.N = N;
  switch (which) {
    case 0: return launch_scan<int32_t, false>(c, nullptr, out);
    case 1: return launch_scan<uint8_t, false>(b, nullptr, out);
    case 2: return launch_scan<uint8_t, true>(b, nullptr, out);
    case 3: {
      ntw::GateArgs gate{};
      gate.N = N;
      return launch_commit(b, gate, nullptr, nullptr, out);
    }
    default: return (int)cudaErrorInvalidValue;
  }
}

// The standalone support_stake launch at N, without launching: out[0..4] =
// registers, local and static shared bytes per thread, block size, dynamic
// shared bytes.
extern "C" int nt_support_stake_attributes(int N, int* out) {
  ntw::GateArgs a{};
  a.N = N;
  return launch_support(a, 1, nullptr, nullptr, out);
}

// One descending slot of the committee-sharded chain on a rank's Nb
// columns of N (k ranks, k * Nb >= N): `out` [2][Nb] gets g and g & leader
// from the gathered record `prev` [k][2][Nb] of the slot above (see
// chain_step_block_kernel).
extern "C" int nt_chain_step_block(const void* parent_up, const void* exists,
                                   const void* leader, const void* prev,
                                   const void* prev_lead, void* out, int N, int Nb,
                                   int k, void* stream) {
  if (N < 1 || N > 1024 || Nb < 1 || k < 1 || (int64_t)k * Nb < N)
    return (int)cudaErrorInvalidValue;
  const BlockStepArgs a{(const uint8_t*)parent_up, (const uint8_t*)exists,
                        (const uint8_t*)leader,    (const uint8_t*)prev,
                        (const uint8_t*)prev_lead, (uint8_t*)out,
                        N,                         Nb};
  chain_step_block_kernel<<<(Nb + kBlockStepThreads - 1) / kBlockStepThreads,
                            kBlockStepThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The support gate's votes on a rank's Nb columns: votes [N] from the
// child slot's parent rows parent_s [N][Nb] and the leader's row [Nb].
extern "C" int nt_support_votes_block(const void* parent_s, const void* leader,
                                      void* votes, int N, int Nb, void* stream) {
  if (N < 1 || N > 1024 || Nb < 1 || Nb > 1024) return (int)cudaErrorInvalidValue;
  support_votes_block_kernel<<<(N + kVotesWarps - 1) / kVotesWarps, 32 * kVotesWarps, 0,
                               (cudaStream_t)stream>>>(
      (const uint8_t*)parent_s, (const uint8_t*)leader, (uint8_t*)votes, N, Nb);
  return (int)cudaGetLastError();
}

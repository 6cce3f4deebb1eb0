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
//   commit_step_block       <- the same program under jax.jit over a
//                              `committee` mesh (__graft_entry__.py:147-193),
//                              which GSPMD partitions on the cited parent's
//                              column: one slot of _chain_scan on one rank's
//                              block of columns, with its part of the
//                              support gate's votes and stake
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

// The committee-sharded commit step, one slot a launch (commit_step_block).
//
// Replaces what jax.jit of __graft_entry__.make_commit_step runs over a
// `committee` mesh (__graft_entry__.py:147-193): GSPMD partitions the
// lax.scan of _chain_scan (narwhal_tpu/ops/reachability.py:88) and the
// support_stake votes (reachability.py:268) on the cited parent's column.
// Rank r of k holds the columns [r * Nb, (r + 1) * Nb) of parent, exists,
// the leader one-hots and the stake (Nb = ceil(N / k), the last block
// padded with columns that do not exist), and every slot's step needs the
// whole frontier, so the ranks all-gather each slot's record
// (ops/reachability.py, commit_step_sharded).  The step follows the JAX
// scan: W launches, w = W-1 down to 0, whatever the anchor, each applying
// the scan's anchor rules to the anchor slot it reads on the card.
//
// A rank's record of a slot is R = 2 BW + VW + 1 words of 32 bits
// (BW = ceil(Nb / 32), VW = ceil(N / 32)): g on its columns, g & leader
// (written only where the slot may lead: is_leader_slot[w] and w below
// the anchor), the gate's votes on the N child rows from its columns, and
// one int32 of partial support.  The gate rides the chain's records: the
// top slot's launch writes this rank's votes, the next launch ORs every
// rank's votes and sums the stake of this rank's voters, and the caller
// sums the k partials after the last gather.  So the step has no
// reduction collective.
//
// What bounds a slot on the card: the bytes of the frontier's rows of
// parent[w + 1] in the rank's columns, at most N * Nb bits (32 KB at
// N = 1024 over four ranks, 2 KB at the flagship's N = 50), and the
// gathered record, k * R words: one launch's latency at every shape the
// step runs.  The design:
//   - the top launch packs the rank's whole parent block to bits, once a
//     step, into scratch the wrapper allocates (BWP words a row, BW rounded
//     up to a power of two; every slot padded to 16 bytes), on blocks of
//     their own, a warp a row word of 32 rows of a slot; the warps that
//     pack the gate's child slot also test each row against the leader's
//     row and write the votes;
//   - a slot's block rebuilds the frontier from the gathered record with
//     one ballot a frontier word, then splits the frontier's rows over its
//     warps: the slot's packed rows are read as one flat run of 16-byte
//     loads, a row being BWP / 4 lanes (or four rows a lane where BWP < 4),
//     neighbouring lanes on neighbouring addresses, each lane ORing the
//     words of the rows in the frontier into registers.  The lanes' words
//     meet through shuffles and one shared-memory atomic a word a warp.
//     No thread walks the frontier's rows one after another.
// One block, a thread an authority and a column (32 * ceil(max(N, Nb) /
// 32) threads rounded up to a multiple of 32 * BWP, at most
// kSlotThreads), holds every row of a
// slot at N <= 1024: at most 8,192 16-byte loads (N = 1024 on one rank),
// 8 a thread, issued together.  The launch sizes the block to the shape:
// with 1,024 threads at every shape the top launch at N = 50 took half as
// long again (PERF.md), its packing spread over fewer blocks.
constexpr int kSlotThreads = 1024;
constexpr int kSlotWarps = kSlotThreads / 32;

struct SlotArgs {
  const uint8_t* parent;         // [W][N][Nb]: the rank's parent columns (top launch)
  uint32_t* packed;              // [W][SP]: parent to bits, row i of slot w at w*SP + i*BWP
  const uint8_t* exists;         // [W][Nb]
  const uint8_t* leader;         // [W][Nb]: leader_onehot on the rank's columns
  const uint8_t* is_lead;        // [W]: is_leader_slot
  const int32_t* stake;          // [Nb]
  const int32_t* anchor;         // the anchor slot (0-d, on the card)
  const uint8_t* anchor_onehot;  // [N]
  const int32_t* prev;           // [k][R]: the gathered record of slot w + 1 (null at the top)
  int32_t* out;                  // [R]: this rank's record of slot w
  int w, W, N, Nb, k, lo, SP;    // lo = rank * Nb
};

// JAX's rule for a traced index into an axis of `size`: counted from the
// end once when negative, then clamped into [0, size).
__device__ __forceinline__ int dyn_index(int i, int size) {
  if (i < 0) i += size;
  return min(max(i, 0), size - 1);
}

// The top launch's packing blocks.  Warp v of pack block b packs row word
// c = v mod BWP of the 32 rows [32m, 32m + 32) of one slot, for row group
// gi = b * kGroups + v / BWP (kGroups = the block's warps / BWP, which
// the launch makes a whole number; slot gi / G, m = gi mod G, G = VW
// groups a slot): lane l reads byte 32c + l of each of the 32 rows (one 32-byte
// run a row, all 32 loads in flight), then a ballot a row gives the row's
// word c, kept by the lane of that row.  So the pack is one trip to
// memory on every warp.  In the gate's child slot s each warp also ANDs
// its words with the leader row's word c; the block's warps of a row
// group OR their ballots of the results into one shared word, votes word
// m.
template <int BWP>
__device__ __forceinline__ void pack_rows(const SlotArgs& a, int block) {
  __shared__ uint32_t votes[kSlotWarps];
  const int t = (int)threadIdx.x, lane = t & 31, warp = t >> 5;
  const int kGroups = (int)(blockDim.x >> 5) / BWP;
  const int G = (a.N + 31) >> 5, BW = (a.Nb + 31) >> 5;
  const int c = warp % BWP, gi = block * kGroups + warp / BWP;
  const int anchor = *a.anchor;
  const int s = dyn_index(anchor - 1, a.W), lrow = dyn_index(anchor - 2, a.W);
  const bool live = gi < a.W * G;
  const int slot = gi / G, m = gi - slot * G;
  if (t < kSlotWarps) votes[t] = 0;
  __syncthreads();
  if (live) {
    const int rows = min(32, a.N - 32 * m), col = 32 * c + lane;
    const uint8_t* base = a.parent + ((size_t)slot * a.N + 32 * m) * a.Nb + col;
    uint8_t x[32];
#pragma unroll
    for (int r = 0; r < 32; ++r) x[r] = r < rows && col < a.Nb ? base[r * a.Nb] : 0;
    const uint32_t lead =
        __ballot_sync(0xffffffffu, col < a.Nb && a.leader[(size_t)lrow * a.Nb + col] != 0);
    uint32_t word = 0;
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const uint32_t b = __ballot_sync(0xffffffffu, x[r] != 0);
      word = lane == r ? b : word;
    }
    if (lane < rows) a.packed[(size_t)slot * a.SP + (size_t)(32 * m + lane) * BWP + c] = word;
    if (slot == s) {
      const uint32_t v = __ballot_sync(0xffffffffu, (word & lead) != 0u);
      if (lane == 0 && v != 0u) atomicOr(&votes[warp / BWP], v);
    }
  }
  __syncthreads();
  if (live && slot == s && c == 0 && lane == 0) a.out[2 * BW + m] = (int32_t)votes[warp / BWP];
}

// Slot w of the chain on the rank's columns, and its part of the gate.
// Thread t owns authority t of the frontier and column t of the rank's
// block.  Every load that does not wait on another is issued first, with
// the anchor's: the gathered record's words, the slot's exists, leader
// and flags of the thread's column, and the thread's first two 16-byte
// runs of the packed rows of parent[w + 1] (those of rows outside the
// frontier are dropped later).  So at the shapes the step runs (up to
// 2 * 16 * threads bytes of packed rows: all but N = 1024 on one rank) a
// slot is one trip to memory and two block barriers.
template <int BWP>
__device__ __forceinline__ void slot_step(const SlotArgs& a) {
  __shared__ uint32_t front[32];  // the frontier, N bits
  __shared__ uint32_t hit[BWP];   // the OR of its rows on the rank's columns
  __shared__ int32_t part[kSlotWarps];
  const int t = (int)threadIdx.x, lane = t & 31, warp = t >> 5, T = (int)blockDim.x;
  const int W = a.W, N = a.N, Nb = a.Nb, w = a.w;
  const int BW = (Nb + 31) >> 5, VW = (N + 31) >> 5, R = 2 * BW + VW + 1;
  const int gate = W >= 2 ? W - 2 : -1;  // the slot that sums the gate's stake
  const int anchor = *a.anchor;
  const bool col = t < Nb && w >= 0;
  const bool ex = col && a.exists[(size_t)w * Nb + t] != 0;
  const bool ld = col && a.leader[(size_t)w * Nb + t] != 0;
  const bool on = col && a.lo + t < N && a.anchor_onehot[a.lo + t] != 0;
  const bool lead_slot = w >= 0 && a.is_lead[w] != 0;
  // Authority t's bit in the slot above's g (fg) and g & leader (fgl);
  // any: a word of some rank's g & leader, over the warp's lanes.
  uint32_t fg = 0, fgl = 0, votes = 0;
  int any = 0;
  const int r = t / Nb, j = t - r * Nb;
  const int n4 = a.SP >> 2;
  const bool above = a.prev != nullptr && w >= 0;  // a slot above to read
  const uint4* rows = reinterpret_cast<const uint4*>(a.packed + (size_t)(w + 1) * a.SP);
  uint4 v0 = make_uint4(0u, 0u, 0u, 0u), v1 = v0;
  if (above) {
    if (t < n4) v0 = rows[t];
    if (t + T < n4) v1 = rows[t + T];
  }
  if (a.prev != nullptr) {
    if (t < N) {
      fg = (uint32_t)a.prev[r * R + (j >> 5)] >> (j & 31) & 1u;
      fgl = (uint32_t)a.prev[r * R + BW + (j >> 5)] >> (j & 31) & 1u;
    }
    for (int i = lane; i < a.k * BW; i += 32) {
      const int q = i / BW;
      any |= a.prev[q * R + BW + (i - q * BW)];
    }
    if (w == gate && t < Nb && a.lo + t < N) {
      const int i = a.lo + t;
      for (int q = 0; q < a.k; ++q) votes |= (uint32_t)a.prev[q * R + 2 * BW + (i >> 5)];
      votes = votes >> (i & 31) & 1u;
    }
  }
  // Below an anchor inside the window the frontier comes from the slot
  // above; at the anchor it is the anchor; elsewhere it is empty.
  const bool chain = above && w < anchor && anchor < W;
  if (chain) {
    if (t < BWP) hit[t] = 0;
    // The chain's reset: the slot above's g & leader where any of it is
    // set (it is written only where that slot may lead), else its g.
    const bool reset = __any_sync(0xffffffffu, any != 0);
    const uint32_t word = __ballot_sync(0xffffffffu, reset ? fgl : fg);
    if (lane == 0 && warp < VW) front[warp] = word;
    __syncthreads();
    uint32_t acc[4] = {0u, 0u, 0u, 0u};
    auto in_front = [&](int q) { return q < N && (front[q >> 5] >> (q & 31) & 1u); };
    auto add = [&](int u, const uint4& v) {
      if constexpr (BWP >= 4) {
        if (in_front(4 * u / BWP)) acc[0] |= v.x, acc[1] |= v.y, acc[2] |= v.z, acc[3] |= v.w;
      } else {
        acc[0] |= in_front(4 * u / BWP) ? v.x : 0u;
        acc[1] |= in_front((4 * u + 1) / BWP) ? v.y : 0u;
        acc[2] |= in_front((4 * u + 2) / BWP) ? v.z : 0u;
        acc[3] |= in_front((4 * u + 3) / BWP) ? v.w : 0u;
      }
    };
    add(t, v0);
    add(t + T, v1);
#pragma unroll 4
    for (int u = t + 2 * T; u < n4; u += T) add(u, rows[u]);
    // Lane l's words are row words (4l + e) mod BWP: OR the lanes that
    // share them, then one shared atomic a word.
    constexpr int kKeep = BWP >= 4 ? BWP / 4 : 1;
#pragma unroll
    for (int off = 16; off >= kKeep; off >>= 1)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[e] |= __shfl_xor_sync(0xffffffffu, acc[e], off);
    if (lane < kKeep)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (acc[e] != 0u) atomicOr(&hit[(4 * lane + e) % BWP], acc[e]);
    __syncthreads();
  }
  // g and g & leader on the rank's columns, a ballot a word.
  const bool g = w == anchor ? on : chain && ex && (hit[t >> 5] >> (t & 31) & 1u);
  const bool lead = g && ld && lead_slot && w < anchor;
  const uint32_t gw = __ballot_sync(0xffffffffu, g), glw = __ballot_sync(0xffffffffu, lead);
  if (lane == 0 && warp < BW) {
    a.out[warp] = (int32_t)gw;
    a.out[BW + warp] = (int32_t)glw;
  }
  // The votes: the top launch's packing warps write them; zero elsewhere.
  if (w != W - 1 && t < VW) a.out[2 * BW + t] = 0;
  // The gate's slot (W - 2; -1, a launch of its own, for W = 1): the
  // stake of this rank's child rows that some rank's columns voted for
  // and that exist at the child slot.
  if (w != gate) {
    if (t == 0) a.out[R - 1] = 0;
    return;
  }
  const int s = dyn_index(anchor - 1, W);
  int32_t sum = votes && a.exists[(size_t)s * Nb + t] != 0 ? a.stake[t] : 0;
  sum = __reduce_add_sync(0xffffffffu, sum);
  if (lane == 0) part[warp] = sum;
  __syncthreads();
  if (t == 0) {
    int32_t total = 0;
    for (int i = 0; i < (int)(blockDim.x >> 5); ++i) total += part[i];
    a.out[R - 1] = total;
  }
}

// Block 0 steps slot w; the top launch's other blocks pack the parent
// block (and write the votes).
template <int BWP>
__global__ void __launch_bounds__(kSlotThreads) commit_step_block_kernel(SlotArgs a) {
  if (blockIdx.x == 0) {
    slot_step<BWP>(a);
    return;
  }
  pack_rows<BWP>(a, (int)blockIdx.x - 1);
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

// A slot's launch: block 0 and, at the top slot, the packing blocks,
// warps / BWP row groups of 32 rows each.  The warps are a multiple of
// BWP (a power of two, at most 32, so they stay at most 32), or the
// packing blocks would leave row groups unpacked.  Launches, or with
// `attrs` non-null only fills attrs[0..4] (launch_or_describe: then the
// block size and the blocks).
static int launch_slot(const SlotArgs& a, bool top, cudaStream_t st, int* attrs) {
  const int bwp = ntw::nw_class(a.Nb), groups = a.W * ((a.N + 31) >> 5);
  const int warps = (((max(a.N, a.Nb) + 31) >> 5) + bwp - 1) / bwp * bwp;
  const int per_block = warps / bwp, threads = 32 * warps;
  const int grid = 1 + (top ? (groups + per_block - 1) / per_block : 0);
  switch (bwp) {
#define NT_SLOT(B)                                                                      \
  case B:                                                                               \
    return launch_or_describe(commit_step_block_kernel<B>, grid, threads, 0, st, attrs, \
                              {threads, grid}, a);
    NT_SLOT(1) NT_SLOT(2) NT_SLOT(4) NT_SLOT(8) NT_SLOT(16) NT_SLOT(32)
#undef NT_SLOT
    default: return (int)cudaErrorInvalidValue;
  }
}

// Slot w (W-1 down to 0, or -1: the gate's own launch when W = 1) of the
// committee-sharded commit step on rank `rank` of k, Nb columns of N:
// `out` [R] gets the rank's record of the slot from the gathered record
// `prev` [k][R] of the slot above (null at the top, w = W-1, whose launch
// also packs `parent` into `packed` [W][SP] for the launches after it).
// See commit_step_block_kernel.
extern "C" int nt_commit_step_block(const void* parent, void* packed, const void* exists,
                                    const void* leader, const void* is_lead,
                                    const void* stake, const void* anchor,
                                    const void* anchor_onehot, const void* prev, void* out,
                                    int w, int W, int N, int Nb, int k, int rank, int SP,
                                    void* stream) {
  const bool top = w == W - 1;
  if (N < 1 || N > 1024 || Nb < 1 || Nb > 1024 || k < 1 || (int64_t)k * Nb < N ||
      rank < 0 || rank >= k || W < 1 || w < (W == 1 ? -1 : 0) || w >= W ||
      top != (prev == nullptr) || SP < 4 || (SP & 3) != 0 ||
      (int64_t)N * ntw::nw_class(Nb) > SP)
    return (int)cudaErrorInvalidValue;
  const SlotArgs a{(const uint8_t*)parent, (uint32_t*)packed,  (const uint8_t*)exists,
                   (const uint8_t*)leader, (const uint8_t*)is_lead, (const int32_t*)stake,
                   (const int32_t*)anchor, (const uint8_t*)anchor_onehot,
                   (const int32_t*)prev,   (int32_t*)out,       w, W, N, Nb, k, rank * Nb, SP};
  return launch_slot(a, top, (cudaStream_t)stream, nullptr);
}

// The launch of slot w (top: w = W - 1, whose launch also packs) at
// (W, N, Nb), without launching: out[0..4] = registers, local (spill) and
// static shared bytes per thread, block size, blocks.
extern "C" int nt_commit_step_block_attributes(int top, int W, int N, int Nb, int* out) {
  if (N < 1 || N > 1024 || Nb < 1 || Nb > 1024 || W < 1) return (int)cudaErrorInvalidValue;
  SlotArgs a{};
  a.W = W;
  a.N = N;
  a.Nb = Nb;
  return launch_slot(a, top != 0, nullptr, out);
}

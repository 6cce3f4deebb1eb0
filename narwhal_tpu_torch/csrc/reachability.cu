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
// latency; the three scans by their W dependent steps, each waiting on a
// memory round trip and the block's barriers.  The design answers: the
// launch count (one launch per flush chunk, one per shift, one for the
// support gate, one for a whole W-step scan, whose steps loop inside a
// single block instead of one launch per step), and inside the scans one
// round trip per step (each step's column of parent loads is spread over
// the whole block; see mark_hits).  The one-block kernels take N <= 1024.
//
// Each entry point launches on the caller's stream, allocates nothing and
// returns the cudaError_t of the launch.

#include <cstdint>
#include <cuda_runtime.h>

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

template <typename T>
__device__ __forceinline__ bool present(T v) {
  return static_cast<int32_t>(v) > 0;
}

// The two scans share one block layout: lane (m, k) is thread k * Npad + m,
// with Npad = N rounded up to a warp and K = blockDim.x / Npad lanes per
// authority m.  Shared memory holds the frontier and the step's hits, Npad
// bytes each.
struct ScanLanes {
  int m, k, K, npad;
  __device__ ScanLanes(int N) {
    npad = (N + 31) / 32 * 32;
    m = threadIdx.x % npad;
    k = threadIdx.x / npad;
    K = blockDim.x / npad;
  }
};

// One step's parent hits: lane (m, k) ORs frontier[n] && up[n][m] > 0 over
// its share of n (n = k, k + K, ...) and marks hits[m].  With K lanes per
// column each thread issues a few independent loads and 32 warps keep the
// rest in flight, so a step waits on about one memory round trip instead
// of one per frontier member.
template <typename T>
__device__ __forceinline__ void mark_hits(const T* __restrict__ up,
                                          const unsigned char* frontier,
                                          unsigned char* hits,
                                          const ScanLanes& l, int N) {
  if (l.m >= N) return;
  bool hit = false;
  for (int n0 = l.k; n0 < N; n0 += 4 * l.K) {
    T v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + j * l.K;
      v[j] = n < N ? up[(int64_t)n * N + l.m] : T(0);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + j * l.K;
      hit |= n < N && frontier[n] && present(v[j]);
    }
  }
  if (hit) hits[l.m] = 1;  // every writer writes 1: no atomic needed
}

// The whole linked-leader chain in one block.  T is int32_t for the count
// window (leader_commit_scan) and bool for the flagship commit step
// (leader_chain_scan): one scan body for both.  The frontier (over slot
// w+1's authorities) sits in shared memory; each of the W descending steps:
//   hit[m]  = OR_n frontier[n] && parent[w+1][n][m] > 0   (none at w = W-1)
//   g[m]    = hit[m] && exists[w][m] > 0, overridden by anchor_onehot at
//             w == anchor_slot
//   reach[w][m] = g[m]                 (only when reach is not null)
//   lead    = is_leader_slot[w] && w < anchor_slot && OR_m (g[m] && leader[w][m])
//   frontier = lead ? g && leader[w] : g ;  committed[w] = lead
// exactly the rules of the JAX _chain_scan, whose reach output is g, the
// frontier before the leader reset.  Lane k = 0 owns authority m.
template <typename T>
__global__ void chain_scan_kernel(const T* __restrict__ parent,
                                  const T* __restrict__ exists,
                                  const bool* __restrict__ leader_onehot,
                                  const bool* __restrict__ is_leader_slot,
                                  const bool* __restrict__ anchor_onehot,
                                  int anchor_slot, bool* __restrict__ committed,
                                  bool* __restrict__ reach, int W, int N) {
  extern __shared__ unsigned char smem[];  // frontier | hits
  const ScanLanes l(N);
  unsigned char* frontier = smem;
  unsigned char* hits = smem + l.npad;
  const bool owner = l.k == 0 && l.m < N;
  for (int i = threadIdx.x; i < 2 * l.npad; i += blockDim.x) smem[i] = 0;
  const bool anchor_m = owner && anchor_onehot[l.m];
  __syncthreads();
  for (int w = W - 1; w >= 0; --w) {
    // The owner's loads do not depend on the frontier: they go out first.
    bool present_m = false, leader_m = false;
    if (owner) {
      present_m = present(exists[(int64_t)w * N + l.m]);
      leader_m = leader_onehot[(int64_t)w * N + l.m];
    }
    const bool slot_leads = is_leader_slot[w] && w < anchor_slot;
    if (w + 1 < W) mark_hits(parent + (int64_t)(w + 1) * N * N, frontier, hits, l, N);
    __syncthreads();
    bool g = false;
    if (owner) {
      g = w == anchor_slot ? anchor_m : hits[l.m] && present_m;
      hits[l.m] = 0;
      if (reach != nullptr) reach[(int64_t)w * N + l.m] = g;
    }
    const bool mine = g && leader_m;
    const bool any_leader = __syncthreads_or(mine);
    const bool lead = slot_leads && any_leader;
    if (owner) frontier[l.m] = lead ? mine : g;
    if (threadIdx.x == 0) committed[w] = lead;
    __syncthreads();
  }
}

// The causal cone of one certificate, in the chain scan's block layout.
// Unlike the chain scan the frontier only accumulates: at every step
//   g[m] = (OR_n frontier[n] && parent[w+1][n][m]) && exists[w][m]
//          | (w == start_slot && start_onehot[m])
// and mask[w][m] = g[m].  A start_slot outside [0, W) never matches, so
// the mask is then all false, as in the JAX program.
__global__ void causal_mask_kernel(const bool* __restrict__ parent,
                                   const bool* __restrict__ exists,
                                   int start_slot,
                                   const bool* __restrict__ start_onehot,
                                   bool* __restrict__ mask, int W, int N) {
  extern __shared__ unsigned char smem[];  // frontier | hits
  const ScanLanes l(N);
  unsigned char* frontier = smem;
  unsigned char* hits = smem + l.npad;
  const bool owner = l.k == 0 && l.m < N;
  for (int i = threadIdx.x; i < 2 * l.npad; i += blockDim.x) smem[i] = 0;
  const bool start_m = owner && start_onehot[l.m];
  __syncthreads();
  for (int w = W - 1; w >= 0; --w) {
    const bool present_m = owner && exists[(int64_t)w * N + l.m];
    if (w + 1 < W) mark_hits(parent + (int64_t)(w + 1) * N * N, frontier, hits, l, N);
    __syncthreads();  // every lane has read the old frontier
    if (owner) {
      const bool g = (hits[l.m] && present_m) || (w == start_slot && start_m);
      hits[l.m] = 0;
      mask[(int64_t)w * N + l.m] = g;
      frontier[l.m] = g;
    }
    __syncthreads();
  }
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

// One block for a scan: npad threads per lane row, as many rows as fit in
// 1024 threads; the frontier and the hits in 2 * npad bytes of shared memory.
static void scan_launch_shape(int N, int* block, int* smem) {
  const int npad = (N + 31) / 32 * 32;
  *block = npad * (1024 / npad);
  *smem = 2 * npad;
}

template <typename T>
static int launch_chain_scan(const void* parent, const void* exists,
                             const void* leader_onehot,
                             const void* is_leader_slot,
                             const void* anchor_onehot, int anchor_slot,
                             void* committed, void* reach, int W, int N,
                             void* stream) {
  if (N < 1 || N > 1024) return (int)cudaErrorInvalidValue;
  int block, smem;
  scan_launch_shape(N, &block, &smem);
  chain_scan_kernel<T><<<1, block, smem, (cudaStream_t)stream>>>(
      (const T*)parent, (const T*)exists, (const bool*)leader_onehot,
      (const bool*)is_leader_slot, (const bool*)anchor_onehot, anchor_slot,
      (bool*)committed, (bool*)reach, W, N);
  return (int)cudaGetLastError();
}

extern "C" int nt_leader_commit_scan(const void* parent, const void* exists,
                                     const void* leader_onehot,
                                     const void* is_leader_slot,
                                     const void* anchor_onehot, int anchor_slot,
                                     void* committed, int W, int N,
                                     void* stream) {
  return launch_chain_scan<int32_t>(parent, exists, leader_onehot,
                                    is_leader_slot, anchor_onehot, anchor_slot,
                                    committed, nullptr, W, N, stream);
}

extern "C" int nt_leader_chain_scan(const void* parent, const void* exists,
                                    const void* leader_onehot,
                                    const void* is_leader_slot,
                                    const void* anchor_onehot, int anchor_slot,
                                    void* committed, void* reach, int W, int N,
                                    void* stream) {
  return launch_chain_scan<bool>(parent, exists, leader_onehot,
                                 is_leader_slot, anchor_onehot, anchor_slot,
                                 committed, reach, W, N, stream);
}

extern "C" int nt_causal_mask_scan(const void* parent, const void* exists,
                                   int start_slot, const void* start_onehot,
                                   void* mask, int W, int N, void* stream) {
  if (N < 1 || N > 1024) return (int)cudaErrorInvalidValue;
  int block, smem;
  scan_launch_shape(N, &block, &smem);
  causal_mask_kernel<<<1, block, smem, (cudaStream_t)stream>>>(
      (const bool*)parent, (const bool*)exists, start_slot,
      (const bool*)start_onehot, (bool*)mask, W, N);
  return (int)cudaGetLastError();
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

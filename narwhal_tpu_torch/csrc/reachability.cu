// Tusk's commit-path window kernels for Hopper (sm_90a).
//
// Replaces the jitted JAX programs of narwhal_tpu/ops/reachability.py:
//   window_apply            <- window_apply (donated scatter-add)
//   window_shift            <- window_shift_op (donated gather)
//   leader_commit_scan      <- leader_commit_scan_counts / _chain_scan
//
// The window is int32 presence COUNTS: exists[W][N] and parent[W][N][N],
// where parent[w][n][m] != 0 means certificate (w, n) cites (w-1, m).
//
// What bounds them on the card: at the main path's W = 64, N = 50 the
// whole parent window is 640 KB, so each kernel moves at most ~1.3 MB and
// finishes in well under the launch latency; all three are bound by launch
// latency, not by bytes or operations.  The design answer is the launch
// count: one launch per flush chunk, one per shift, and one for the whole
// leader chain (the W-step scan loops inside a single block instead of one
// launch per step).
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

// The whole linked-leader chain in one block, one thread per authority m.
// The frontier (over slot w+1's authorities) sits in shared memory; each of
// the W descending steps:
//   hit[m]  = OR_n frontier[n] && parent[w+1][n][m] > 0   (none at w = W-1)
//   g[m]    = hit[m] && exists[w][m] > 0, overridden by anchor_onehot at
//             w == anchor_slot
//   lead    = is_leader_slot[w] && w < anchor_slot && OR_m (g[m] && leader[w][m])
//   frontier = lead ? g && leader[w] : g ;  committed[w] = lead
// exactly the rules of the JAX _chain_scan.
__global__ void leader_commit_scan_kernel(const int32_t* __restrict__ parent,
                                          const int32_t* __restrict__ exists,
                                          const bool* __restrict__ leader_onehot,
                                          const bool* __restrict__ is_leader_slot,
                                          const bool* __restrict__ anchor_onehot,
                                          int anchor_slot,
                                          bool* __restrict__ committed, int W,
                                          int N) {
  extern __shared__ unsigned char frontier[];  // N bytes
  const int m = threadIdx.x;
  const bool active = m < N;
  if (active) frontier[m] = 0;
  __syncthreads();
  for (int w = W - 1; w >= 0; --w) {
    bool g = false;
    if (active) {
      if (w == anchor_slot) {
        g = anchor_onehot[m];
      } else if (w + 1 < W) {
        const int32_t* up = parent + (int64_t)(w + 1) * N * N;
        bool hit = false;
        for (int n = 0; n < N; ++n) hit |= frontier[n] && up[(int64_t)n * N + m] > 0;
        g = hit && exists[(int64_t)w * N + m] > 0;
      }
    }
    const bool mine = active && g && leader_onehot[(int64_t)w * N + m];
    // Every thread has read the old frontier once the OR-reduction returns.
    const bool any_leader = __syncthreads_or(mine);
    const bool lead = is_leader_slot[w] && w < anchor_slot && any_leader;
    if (active) frontier[m] = lead ? mine : g;
    if (m == 0) committed[w] = lead;
    __syncthreads();
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

extern "C" int nt_leader_commit_scan(const void* parent, const void* exists,
                                     const void* leader_onehot,
                                     const void* is_leader_slot,
                                     const void* anchor_onehot, int anchor_slot,
                                     void* committed, int W, int N,
                                     void* stream) {
  if (N < 1 || N > 1024) return (int)cudaErrorInvalidValue;
  const int block = (N + 31) / 32 * 32;
  leader_commit_scan_kernel<<<1, block, N, (cudaStream_t)stream>>>(
      (const int32_t*)parent, (const int32_t*)exists,
      (const bool*)leader_onehot, (const bool*)is_leader_slot,
      (const bool*)anchor_onehot, anchor_slot, (bool*)committed, W, N);
  return (int)cudaGetLastError();
}

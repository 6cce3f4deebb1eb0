// Batched strict ed25519 verification for Hopper (sm_90a): four lanes per
// signature, eight signatures per warp.
//
// Replaces the jitted JAX program _verify_kernel (narwhal_tpu/ops/ed25519.py)
// and the field ops of narwhal_tpu/ops/field25519.py beneath it.  Same
// inputs (the nine arrays of the host prep, prepare_batch) and the same
// bool mask:
// decompress A and R, reject small-order A or R, build the table j*(-A),
// run the 64-window MSB-first Straus ladder [S]B + [k](-A), and check
// projective equality with R; S >= L and non-canonical y were decided by
// the host prep.
//
// What bounds it on the card.  The work is integer multiplies: 3,937 field
// multiplies a signature in the plain algorithm, 1,558 of them squares
// (FIELD_MULS_PER_VERIFY and FIELD_SQS_PER_VERIFY in ops/ed25519.py, the
// bound's counts); the bytes moved (780 a signature) are negligible.  A
// one-thread-per-signature kernel spent most of its time elsewhere: at
// the main path's B = 2048 it ran on 32 SMs, one thread's chain of 3,937
// dependent multiplies set the time, and its 16-entry -A table and whole
// points spilled to local memory.  The design shortens the chain, spreads
// it over the card and keeps every operand on chip:
//
// - A group of four lanes works one signature (csrc/field25519.cuh, the
//   four-lane section): each point operation is two rounds of four
//   independent multiplies, exchanged with __shfl_sync inside the group.
//   Lanes 0-1 decompress A while lanes 2-3 decompress R.  The serial chain
//   falls to 1,078 rounds (4,312 multiplies over the four lanes, counted
//   by tests/test_torch_ed25519_lanes.py), and B = 2048 fills 128 blocks,
//   one per SM.
// - A field element is 10 limbs of 26/25 bits, so a limb product is one
//   32x32->64-bit multiply-add, and a round is ~100 of them plus carries.
// - The -A table lives in shared memory, each lane holding its cached
//   coordinate of j*(-A) for j = 0..8 (signed digits, recoded in the kernel
//   from k's windows): 360 bytes a lane.  No array is indexed by data in
//   registers, so nothing goes to local memory.
// - The base table j*B is copied once per block from constant memory into
//   shared memory, in cached form, so the ladder reads no __constant__
//   address that differs across a warp.  d, 2d and sqrt(-1) stay in
//   constant memory, where every lane reads the same address.
//
// What bounds it now.  At B = 2048 the grid is 256 warps on 132 SMs, at
// most one warp on each SM's scheduler, so one warp's issue rate through
// its rounds (multiply-adds, then a dependent carry chain and a shuffle)
// sets the time: ~0.48 ms on an H100 SXM at 700 W, 8 % of the operation
// bound.  At B = 16384 the card is full (6 blocks an SM, held by
// registers and shared memory) and the time follows the integer issue
// rate instead.
//
// Rows past B (the last warp's spare groups) verify row B-1 again and write
// nothing, so every exchange runs with the whole warp.

#include <cstdint>
#include <cuda_runtime.h>

#include "field25519.cuh"

namespace {

constexpr int kBlock = 64;  // threads a block: 16 signatures
constexpr int kLanes = 4;   // threads a signature

__constant__ nt::Ed25519Consts c_consts;

// Each thread's cached coordinate of j*(-A), [entry][limb][thread]: the
// lanes of a warp read consecutive words.
struct LaneTable {
  uint32_t (*t)[10][kBlock];
  int group;  // threadIdx.x of the group's lane 0

  NT_HD nt::fe get(int e, int lane) const {
    nt::fe r;
    for (int i = 0; i < 10; ++i) r.v[i] = t[e][i][group + lane];
    return r;
  }
  NT_HD void put(int e, int lane, const nt::fe& v) const {
    for (int i = 0; i < 10; ++i) t[e][i][group + lane] = v.v[i];
  }
};

__global__ void __launch_bounds__(kBlock)
    ed25519_verify_kernel(const int32_t* __restrict__ a_y,
                          const int32_t* __restrict__ a_sign,
                          const bool* __restrict__ a_canon,
                          const int32_t* __restrict__ r_y,
                          const int32_t* __restrict__ r_sign,
                          const bool* __restrict__ r_canon,
                          const int32_t* __restrict__ s_windows,
                          const bool* __restrict__ s_ok,
                          const int32_t* __restrict__ k_windows,
                          bool* __restrict__ out, int B) {
  __shared__ nt::fe s_base[16][4];
  __shared__ uint32_t s_tab[nt::LANE_TABLE_ENTRIES][10][kBlock];
  for (int i = threadIdx.x; i < 16 * 4; i += kBlock)
    s_base[i / 4][i % 4] = c_consts.base[i / 4][i % 4];
  __syncthreads();

  const int sig = blockIdx.x * (kBlock / kLanes) + threadIdx.x / kLanes;
  const int64_t row = sig < B ? sig : B - 1;
  const int q = threadIdx.x % kLanes;
  const bool is_r = q >= 2;  // lanes 0-1 decompress A, lanes 2-3 R
  bool valid;
  const nt::ge p = nt::ge_decompress(
      nt::fe_from_limbs8((is_r ? r_y : a_y) + row * 32),
      (is_r ? r_sign : a_sign)[row], (is_r ? r_canon : a_canon)[row],
      c_consts.d, c_consts.sqrt_m1, &valid);
  const bool ok = nt::lanes_verify(
      nt::WarpLanes{q}, LaneTable{s_tab, (int)threadIdx.x - q},
      nt::BaseTable{s_base}, c_consts.d2, p.X, p.Y, p.T, valid, s_ok[row],
      s_windows + row * 64, k_windows + row * 64);
  if (q == 0 && sig < B) out[sig] = ok;
}

int grid_for(int B) { return (int)(((int64_t)B * kLanes + kBlock - 1) / kBlock); }

}  // namespace

// Copies the curve constants and the base table into constant memory
// (synchronous; call once before the first verify launch).
extern "C" int nt_ed25519_set_consts(const void* consts) {
  return (int)cudaMemcpyToSymbol(c_consts, consts, sizeof(nt::Ed25519Consts));
}

extern "C" int nt_ed25519_verify(const void* a_y, const void* a_sign,
                                 const void* a_canon, const void* r_y,
                                 const void* r_sign, const void* r_canon,
                                 const void* s_windows, const void* s_ok,
                                 const void* k_windows, void* out, int B,
                                 void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  ed25519_verify_kernel<<<grid_for(B), kBlock, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a_y, (const int32_t*)a_sign, (const bool*)a_canon,
      (const int32_t*)r_y, (const int32_t*)r_sign, (const bool*)r_canon,
      (const int32_t*)s_windows, (const bool*)s_ok, (const int32_t*)k_windows,
      (bool*)out, B);
  return (int)cudaGetLastError();
}

// Registers and local memory per thread of the verify kernel, as the
// compiler laid it out.
extern "C" int nt_ed25519_verify_attributes(int* regs, int* local_bytes) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, ed25519_verify_kernel);
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return (int)cudaSuccess;
}

// The launch shape for B signatures: grid and block, static shared memory
// per block, and the blocks one SM holds at once.
extern "C" int nt_ed25519_verify_launch(int B, int* grid, int* block,
                                        int* shared_bytes, int* blocks_per_sm) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, ed25519_verify_kernel);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, ed25519_verify_kernel, kBlock, 0);
  if (e != cudaSuccess) return (int)e;
  *grid = grid_for(B);
  *block = kBlock;
  *shared_bytes = (int)a.sharedSizeBytes;
  return (int)cudaSuccess;
}

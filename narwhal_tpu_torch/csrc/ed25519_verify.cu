// Batched strict ed25519 verification for Hopper (sm_90a): one thread per
// signature.
//
// Replaces the jitted JAX program _verify_kernel (narwhal_tpu/ops/ed25519.py)
// with the field ops of narwhal_tpu/ops/field25519.py inlined.  Same inputs
// (the nine arrays of the host prep, prepare_batch) and the same bool mask:
// decompress A and R, reject small-order A or R, build the table j*(-A),
// run the 64-window MSB-first Straus ladder [S]B + [k](-A), and check
// projective equality with R; S >= L and non-canonical y were decided by
// the host prep.
//
// What bounds it on the card: integer multiply throughput.  One signature
// costs 3,937 field multiplies (FIELD_MULS_PER_VERIFY in ops/ed25519.py),
// each 25 64x64->128-bit limb products; the bytes moved (780 per
// signature) are negligible.  This first version keeps the whole ladder in one thread, so
// at the main path's B = 2048 the card holds only 2048 threads — far from
// filling 132 SMs — and each thread's serial chain of dependent multiplies
// sets the time.  The per-thread -A table (16 points, 2.5 KB) sits in local
// memory; it is the first limiter for a later version (split a signature
// over several threads, or keep the table in shared memory).
//
// Zero-padded rows decode to garbage points and are masked out; nothing
// indexes memory with data except the 4-bit windows, which are masked.

#include <cstdint>
#include <cuda_runtime.h>

#include "field25519.cuh"

namespace {

__constant__ nt::Ed25519Consts c_consts;

__global__ void __launch_bounds__(64)
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
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  out[i] = nt::verify_one(c_consts, a_y + (int64_t)i * 32, a_sign[i], a_canon[i],
                          r_y + (int64_t)i * 32, r_sign[i], r_canon[i],
                          s_windows + (int64_t)i * 64, s_ok[i],
                          k_windows + (int64_t)i * 64);
}

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
  const int block = 64;
  ed25519_verify_kernel<<<(B + block - 1) / block, block, 0,
                          (cudaStream_t)stream>>>(
      (const int32_t*)a_y, (const int32_t*)a_sign, (const bool*)a_canon,
      (const int32_t*)r_y, (const int32_t*)r_sign, (const bool*)r_canon,
      (const int32_t*)s_windows, (const bool*)s_ok, (const int32_t*)k_windows,
      (bool*)out, B);
  return (int)cudaGetLastError();
}

// Registers and local memory per thread of the verify kernel, as the
// compiler laid it out (the -A table's stack frame lives in local memory).
extern "C" int nt_ed25519_verify_attributes(int* regs, int* local_bytes) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, ed25519_verify_kernel);
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return (int)cudaSuccess;
}

// Host harness for the window scans' bit-packed form
// (narwhal_tpu_torch/csrc/window_bits.cuh): the same pack and step the
// CUDA kernels run, with the 32 lanes of the scanning warp stepped in
// lockstep by ntw::HostGroup and the block's warps packed one after
// another; and the support gate, its warps run one after another.  Built with g++ into a shared library by
// tests/test_torch_window_bits.py and called through ctypes.
//
// Bools cross as bytes.  `chunk` > 0 forces chunks of that many slots;
// 0 takes the card's choice under H100_SMEM_BYTES.  `warps` warps share
// the pack, as a cluster's do on the card.  Shared memory starts filled
// with a junk pattern: the card does not clear it either.

#include <cstdint>
#include <vector>

#include "window_bits.cuh"

namespace {

// The dynamic shared memory one H100 block may opt in to.
constexpr int64_t H100_SMEM_BYTES = 232448;

template <typename T, int NW, bool kCone>
int run_nw(const ntw::ScanArgs<T>& a, int chunk, int warps) {
  const int S = chunk > 0 ? (chunk < a.W ? chunk : (a.W > 0 ? a.W : 1))
                          : ntw::chunk_slots(a.W, a.N, NW, H100_SMEM_BYTES);
  std::vector<uint32_t> smem(ntw::smem_words(S, a.N, NW), 0xa5a5a5a5u);
  ntw::window_scan<T, NW, kCone>(ntw::HostGroup{warps}, 0, warps, a, S, smem.data(),
                                 smem.data(), nullptr);
  return S;
}

template <typename T, bool kCone>
int run(const ntw::ScanArgs<T>& a, int chunk, int warps) {
  if (a.N < 1 || a.N > 1024 || warps < 1) return -1;
  switch (ntw::nw_class(a.N)) {
    case 1: return run_nw<T, 1, kCone>(a, chunk, warps);
    case 2: return run_nw<T, 2, kCone>(a, chunk, warps);
    case 4: return run_nw<T, 4, kCone>(a, chunk, warps);
    case 8: return run_nw<T, 8, kCone>(a, chunk, warps);
    case 16: return run_nw<T, 16, kCone>(a, chunk, warps);
    default: return run_nw<T, 32, kCone>(a, chunk, warps);
  }
}

template <int NW>
int32_t gate_nw(const ntw::GateArgs& a, int warps) {
  std::vector<uint32_t> F(ntw::gate_words(a.N, NW), 0xa5a5a5a5u);
  uint32_t sum = 0;
  for (int k = 0; k < warps; ++k) {
    for (auto& w : F) w = 0x5a5a5a5au ^ (uint32_t)k;
    sum += ntw::support_gate<NW>(ntw::HostGroup{1}, k, warps, a, F.data());
  }
  return (int32_t)sum;
}

}  // namespace

extern "C" {

// Each returns the chunk size it scanned with, or -1 for N outside
// [1, 1024] or no warps.

int h_leader_commit_scan(const int32_t* parent, const int32_t* exists,
                         const uint8_t* leader_onehot,
                         const uint8_t* is_leader_slot,
                         const uint8_t* anchor_onehot, int anchor_slot,
                         uint8_t* committed, int W, int N, int chunk,
                         int warps) {
  const ntw::ScanArgs<int32_t> a{parent, exists, leader_onehot, is_leader_slot,
                                 anchor_onehot, anchor_slot, committed, nullptr,
                                 W, N};
  return run<int32_t, false>(a, chunk, warps);
}

int h_leader_chain_scan(const uint8_t* parent, const uint8_t* exists,
                        const uint8_t* leader_onehot,
                        const uint8_t* is_leader_slot,
                        const uint8_t* anchor_onehot, int anchor_slot,
                        uint8_t* committed, uint8_t* reach, int W, int N,
                        int chunk, int warps) {
  const ntw::ScanArgs<uint8_t> a{parent, exists, leader_onehot, is_leader_slot,
                                 anchor_onehot, anchor_slot, committed, reach,
                                 W, N};
  return run<uint8_t, false>(a, chunk, warps);
}

int h_causal_mask_scan(const uint8_t* parent, const uint8_t* exists,
                       int start_slot, const uint8_t* start_onehot,
                       uint8_t* mask, int W, int N, int chunk, int warps) {
  const ntw::ScanArgs<uint8_t> a{parent, exists, nullptr, nullptr, start_onehot,
                                 start_slot, nullptr, mask, W, N};
  return run<uint8_t, true>(a, chunk, warps);
}

// The support gate (ntw::support_gate) with `warps` warps splitting the
// row groups, each on its own junk-filled shared memory, their parts
// summed; `slot` is the child slot, already resolved.  Returns 0, or -1
// for N outside [1, 1024] or no warps.
int h_support_stake(const uint8_t* parent, const uint8_t* exists, const int32_t* stake,
                    const uint8_t* leader, int slot, int N, int warps, int32_t* out) {
  if (N < 1 || N > 1024 || warps < 1) return -1;
  const ntw::GateArgs a{parent, exists, stake, leader, slot, N};
  switch (ntw::nw_class(N)) {
    case 1: *out = gate_nw<1>(a, warps); break;
    case 2: *out = gate_nw<2>(a, warps); break;
    case 4: *out = gate_nw<4>(a, warps); break;
    case 8: *out = gate_nw<8>(a, warps); break;
    case 16: *out = gate_nw<16>(a, warps); break;
    default: *out = gate_nw<32>(a, warps); break;
  }
  return 0;
}

// The warps that split the gate's rows in the flagship commit step's
// cluster (every block's but the first) at N.
int h_gate_warps(int N) { return ntw::gate_warps(ntw::nw_class(N)); }

// The card's chunk size for (W, N) under `limit` bytes, and the shared
// bytes a chunk of S slots takes.
int h_chunk_slots(int W, int N, long long limit) {
  return ntw::chunk_slots(W, N, ntw::nw_class(N), limit);
}

long long h_smem_bytes(int S, int N) {
  return 4 * ntw::smem_words(S, N, ntw::nw_class(N));
}

// The kernel's gather of four bytes' nonzero flags into bits 0..3.
unsigned h_byte_bits(unsigned x) { return ntw::byte_bits(x); }

}  // extern "C"

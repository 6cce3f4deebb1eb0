// The window scans' bit-packed form: the pack and the step, written once
// over a 32-lane group.  csrc/reachability.cu runs them on the card
// (WarpGroup: ballots, shuffles, __reduce_or_sync), and
// tests/window_bits_host.cpp runs the same functions on the CPU with
// HostGroup, which steps the 32 lanes in lockstep
// (tests/test_torch_window_bits.py).
//
// The scans walk the slots w = W-1 .. 0 of a window parent[W][N][N],
// exists[W][N], where parent[w][n][m] present (> 0 for counts, true for
// bools) means certificate (w, n) cites (w-1, m).  Step w ORs the parent
// rows of slot w+1 whose child n is in the frontier, masks with exists[w]
// and applies the anchor (chain) or start (cone) rule.  What held the old
// kernel back was latency: every step waited on a global-memory round trip
// and on the barriers of a 1,024-thread block.  Here:
//
// 1. Pack, off the dependent chain.  The warps of a cluster of blocks
//    (csrc/reachability.cu) read a chunk of slots with coalesced 16-byte
//    loads (four counts or 16 bools a lane) and turn the chunk's parent
//    entries into one flat bit string F in the first block's shared
//    memory: bit (e - a0) is element e of the flat window, a0 being the
//    chunk's first element rounded down so the vector loads are 16-byte
//    aligned.  The row (w, n) is then the N bits from (w*N + n)*N - a0
//    on, cut out with a funnel shift.  exists[w], the anchor (start) and
//    the leader one-hots become three masks a slot, of NW words of 32
//    bits, with ballots; they fold the anchor rule into the step.
// 2. One warp steps the scan, with no block barrier inside a step.  The
//    frontier is NW words held by every lane of warp 0.  Lane l owns the
//    rows n = l, l+32, ...: it loads their words (the loads do not depend
//    on the frontier), keeps those whose frontier bit is set, and the warp
//    ORs the lanes' words with one __reduce_or_sync a word.  The rest of
//    the step is a few ANDs on words every lane holds; lanes write
//    committed[w] and the reach (mask) row straight to global memory, and
//    nothing waits on those stores.
//
// 3. The f+1 support gate (support_gate below), the JAX support_stake, on
//    warps of their own: in the flagship commit step's one launch the
//    blocks of the cluster that are idle after the last pack run it while
//    warp 0 steps the scan (window_scan returns to them there), and the
//    standalone support_stake kernel is one block of it.
//
// A window too large for shared memory is scanned in chunks of S slots
// (as many as fit), the frontier carried across chunks in warp 0's
// registers: pack, barrier, scan, and a barrier before the next chunk's
// pack.  Bits past N in a word (pad
// bits) may hold the next row's bits after the cut, or stale words of an
// earlier chunk; the AND with exists[w] (whose pad bits are 0) clears them
// before they reach the frontier, and the anchor and start masks have no
// pad bits.

#pragma once

#include <cstdint>

#ifdef __CUDACC__
#include <cooperative_groups.h>
#define NTW_HD __host__ __device__ __forceinline__
#define NTW_UNROLL _Pragma("unroll")
#else
#define NTW_HD inline
#define NTW_UNROLL
#endif

namespace ntw {

// The kernel's inputs.  Bools cross as bytes (0 or 1).
template <typename T>
struct ScanArgs {
  const T* parent;                // [W][N][N]
  const T* exists;                // [W][N]
  const uint8_t* leader_onehot;   // [W][N] (chain only)
  const uint8_t* is_leader_slot;  // [W] (chain only)
  const uint8_t* anchor_onehot;   // [N]: the anchor (chain) or start (cone)
  int anchor_slot;                // the anchor (chain) or start (cone) slot
  uint8_t* committed;             // [W] (chain only)
  uint8_t* reach;                 // [W][N], or null: reach (chain), mask (cone)
  int W, N;
};

// The kernel's words of 32 bits for a row of N bits: enough for N,
// rounded up to a power of two (1, 2, 4, 8, 16 or 32 for N <= 1024).
NTW_HD int nw_class(int n) {
  int c = 1;
  while (32 * c < n) c <<= 1;
  return c;
}

// The masks a slot keeps beside its parent rows (see pack_masks).
constexpr int kMasks = 3;

// The launch of a scan on the card (csrc/reachability.cu): one cluster of
// kClusterBlocks blocks of scan_block(NW) threads.  The block is 512
// threads up to NW = 16 and 256 at 32, so that warp 0's frontier and row
// words (2 * NW registers and more) fit the registers a thread may have at
// that block size and nothing spills to local memory.
constexpr int kClusterBlocks = 8;
NTW_HD constexpr int scan_block(int nw) { return nw <= 16 ? 512 : 256; }

// Shared memory of a chunk of S slots, in 32-bit words:
//   M[S][kMasks][NW] | F
// F holds the chunk's parent entries (at most S slots of N*N bits) from a0
// on: whole groups of 512 elements (or 128 for counts), up to 15 elements
// of alignment slack in front, and NW + 1 more words that the last row's
// words may read.
NTW_HD int64_t flat_words(int S, int N, int NW) {
  return ((int64_t)S * N * N + 15 + 511) / 512 * 16 + NW + 1;
}
NTW_HD int64_t smem_words(int S, int N, int NW) {
  return kMasks * (int64_t)S * NW + flat_words(S, N, NW);
}
// The most slots a chunk may hold under limit_bytes (at least 1).
NTW_HD int chunk_slots(int W, int N, int NW, int64_t limit_bytes) {
  int S = W < 1 ? 1 : W;
  while (S > 1 && 4 * smem_words(S, N, NW) > limit_bytes) --S;
  return S;
}

template <typename T>
NTW_HD bool present(T v) {
  return static_cast<int32_t>(v) > 0;
}

// A lane packs kPer elements from one 16-byte load: 4 counts or 16 bools.
template <typename T>
NTW_HD constexpr int per_lane() {
  return sizeof(T) == 1 ? 16 : 4;
}

// The four nonzero bytes of x as bits 0..3 (OR each byte into its bit 0,
// then gather the four bits with one multiply: no carries, the partial
// products land on distinct bits).
NTW_HD uint32_t byte_bits(uint32_t x) {
  x |= x >> 4;
  x |= x >> 2;
  x |= x >> 1;
  return ((x & 0x01010101u) * 0x01020408u) >> 24;
}

#ifdef __CUDA_ARCH__
__device__ __forceinline__ uint32_t vec_bits(const int32_t* p) {
  const int4 v = __ldg(reinterpret_cast<const int4*>(p));
  return (uint32_t)(v.x > 0) | (uint32_t)(v.y > 0) << 1 |
         (uint32_t)(v.z > 0) << 2 | (uint32_t)(v.w > 0) << 3;
}
__device__ __forceinline__ uint32_t vec_bits(const uint8_t* p) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  return byte_bits(v.x) | byte_bits(v.y) << 4 | byte_bits(v.z) << 8 |
         byte_bits(v.w) << 12;
}
#endif

// The presence bits of elements p[0 .. kPer-1], all inside the window.
template <typename T>
NTW_HD uint32_t full_bits(const T* p) {
#ifdef __CUDA_ARCH__
  return vec_bits(p);
#else
  uint32_t b = 0;
  for (int c = 0; c < per_lane<T>(); ++c) b |= (uint32_t)present(p[c]) << c;
  return b;
#endif
}

// The presence bits of elements e .. e+kPer-1; elements outside [e0, e1)
// are not read and give 0.
template <typename T>
NTW_HD uint32_t edge_bits(const T* src, int64_t e, int64_t e0, int64_t e1) {
  uint32_t b = 0;
  for (int c = 0; c < per_lane<T>(); ++c)
    if (e + c >= e0 && e + c < e1 && present(src[e + c])) b |= 1u << c;
  return b;
}

// Bits r .. r+31 of the 64-bit word hi:lo.
NTW_HD uint32_t funnel_r(uint32_t lo, uint32_t hi, int r) {
#ifdef __CUDA_ARCH__
  return __funnelshift_r(lo, hi, r);
#else
  return (uint32_t)(((uint64_t)hi << 32 | lo) >> r);
#endif
}

// The lane group.  Per-lane values are arrays of kLanes: one on the card
// (this thread's lane), 32 on the host.  warps() is the number of warps
// the caller plays in the pack: one on the card; on the host, every warp
// of a cluster in turn.
#ifdef __CUDACC__
struct WarpGroup {
  static constexpr int kLanes = 1;
  int lane_;
  NTW_HD int lane(int) const { return lane_; }
  NTW_HD int warps() const { return 1; }
  NTW_HD uint64_t clock() const {
#ifdef __CUDA_ARCH__
    return clock64();
#else
    return 0;
#endif
  }
  NTW_HD uint32_t ballot(const bool (&p)[1]) const {
#ifdef __CUDA_ARCH__
    return __ballot_sync(0xffffffffu, p[0]);
#else
    return p[0];
#endif
  }
  template <int NW>
  NTW_HD uint32_t or_all(const uint32_t (&v)[1][NW], int j) const {
#ifdef __CUDA_ARCH__
    return __reduce_or_sync(0xffffffffu, v[0][j]);
#else
    return v[0][j];
#endif
  }
  // Lane l's kPer bits are bits kPer*l .. of the warp's kPer words.
  template <int kPer>
  NTW_HD void store_lane_bits(const uint32_t (&bits)[1], uint32_t* words) const {
#ifdef __CUDA_ARCH__
    constexpr int kLanesPerWord = 32 / kPer;
    uint32_t v = bits[0] << (kPer * (lane_ % kLanesPerWord));
    NTW_UNROLL
    for (int o = 1; o < kLanesPerWord; o <<= 1) v |= __shfl_xor_sync(0xffffffffu, v, o);
    if (lane_ % kLanesPerWord == 0) words[lane_ / kLanesPerWord] = v;
#endif
  }
  // The lanes' sum (mod 2^32, as JAX's int32 sum wraps).
  NTW_HD uint32_t add_all(const uint32_t (&v)[1]) const {
#ifdef __CUDA_ARCH__
    return __reduce_add_sync(0xffffffffu, v[0]);
#else
    return v[0];
#endif
  }
  // Orders the warp's shared memory stores before its lanes' loads.
  NTW_HD void sync_warp() const {
#ifdef __CUDA_ARCH__
    __syncwarp();
#endif
  }
  // A barrier of the whole cluster, which also makes every block's
  // distributed shared memory stores visible to the first block.
  NTW_HD void sync() const {
#ifdef __CUDA_ARCH__
    cooperative_groups::this_cluster().sync();
#endif
  }
};
#endif  // __CUDACC__

struct HostGroup {
  static constexpr int kLanes = 32;
  int warps_;  // the warps it plays in the pack, one after another
  int lane(int q) const { return q; }
  int warps() const { return warps_; }
  uint64_t clock() const { return 0; }
  uint32_t ballot(const bool (&p)[32]) const {
    uint32_t m = 0;
    for (int q = 0; q < 32; ++q) m |= (uint32_t)p[q] << q;
    return m;
  }
  template <int NW>
  uint32_t or_all(const uint32_t (&v)[32][NW], int j) const {
    uint32_t m = 0;
    for (int q = 0; q < 32; ++q) m |= v[q][j];
    return m;
  }
  template <int kPer>
  void store_lane_bits(const uint32_t (&bits)[32], uint32_t* words) const {
    constexpr int kLanesPerWord = 32 / kPer;
    for (int k = 0; k < kPer; ++k) {
      uint32_t v = 0;
      for (int s = 0; s < kLanesPerWord; ++s) v |= bits[kLanesPerWord * k + s] << (kPer * s);
      words[k] = v;
    }
  }
  uint32_t add_all(const uint32_t (&v)[32]) const {
    uint32_t m = 0;
    for (int q = 0; q < 32; ++q) m += v[q];
    return m;
  }
  void sync_warp() const {}
  void sync() const {}
};

// A warp issues kBatch loads (groups or mask words) before it converts
// and stores any, so that kBatch loads of each warp are in flight at once.
constexpr int kBatch = 4;

// Pack elements [e0, e1) of the flat window into F, from a0 on, in
// groups of 32 * kPer elements (a warp's 16-byte loads), kPer words each.
// Only the first and the last group may hold elements outside [e0, e1):
// they are read element by element.  The warps take the groups between
// them in turn (warp k of nwarps: 1 + k, 1 + k + nwarps, ...), kBatch at
// a time with one vector load a lane each and no branch around the loads
// (a batch past the end reloads the last inner group).
template <typename T, class G>
NTW_HD void pack_flat(const G& g, int warp, int nwarps, const T* src,
                      int64_t a0, int64_t e0, int64_t e1, uint32_t* F) {
  if (e1 <= e0) return;
  constexpr int kPer = per_lane<T>();
  constexpr int kGroup = 32 * kPer;
  const int64_t groups = (e1 - a0 + kGroup - 1) / kGroup;
  for (int64_t k0 = 1 + warp; k0 < groups - 1; k0 += kBatch * nwarps) {
    uint32_t bits[kBatch][G::kLanes];
    NTW_UNROLL
    for (int u = 0; u < kBatch; ++u) {
      int64_t k = k0 + u * nwarps;
      if (k > groups - 2) k = groups - 2;
      for (int q = 0; q < G::kLanes; ++q)
        bits[u][q] = full_bits(src + a0 + kGroup * k + kPer * g.lane(q));
    }
    NTW_UNROLL
    for (int u = 0; u < kBatch; ++u)
      if (k0 + u * nwarps < groups - 1)
        g.template store_lane_bits<kPer>(bits[u], F + kPer * (k0 + u * nwarps));
  }
  for (int side = 0; side < 2; ++side) {
    const int64_t k = side == 0 ? 0 : groups - 1;
    if ((side == 1 && k == 0) || warp != side % nwarps) continue;
    uint32_t bits[G::kLanes];
    for (int q = 0; q < G::kLanes; ++q)
      bits[q] = edge_bits(src, a0 + kGroup * k + kPer * g.lane(q), e0, e1);
    g.template store_lane_bits<kPer>(bits, F + kPer * k);
  }
}

// The masks of a slot s, kMasks rows of NW words side by side (word i
// covers bits 32i .. 32i+31), so that one step reads them together:
//   kind 0, E[s]: exists[s], but 0 at the anchor slot of the chain, whose
//           frontier is the anchor alone;
//   kind 1, X[s]: the anchor (start) one-hot at its slot, else 0; a step
//           makes g = (h & E[s]) | X[s], which replaces g by the anchor in
//           the chain and ORs the start into it in the cone;
//   kind 2, L[s]: the leader one-hot where slot s may commit
//           (is_leader_slot and below the anchor; 0 otherwise and in the
//           cone).
// An anchor slot outside [0, W) matches no slot.

template <int kKind, bool kCone, typename T>
NTW_HD bool mask_bit(const ScanArgs<T>& a, int s, int m) {
  if (m >= a.N) return false;
  if (kKind == 0) return present(a.exists[(int64_t)s * a.N + m]) & (kCone || s != a.anchor_slot);
  if (kKind == 1) return (s == a.anchor_slot) & (a.anchor_onehot[m] != 0);
  if (kCone) return false;
  return (a.is_leader_slot[s] != 0) & (a.leader_onehot[(int64_t)s * a.N + m] != 0) &
         (s < a.anchor_slot);
}

// Mask kKind of slots lo .. lo+S-1 into M, one ballot a word, kBatch
// words of a warp at a time.
template <int kKind, bool kCone, typename T, int NW, class G>
NTW_HD void pack_mask_rows(const G& g, int warp, int nwarps, const ScanArgs<T>& a,
                           int lo, int S, uint32_t* M) {
  const int items = S * NW;
  for (int it0 = warp; it0 < items; it0 += kBatch * nwarps) {
    bool p[kBatch][G::kLanes];
    NTW_UNROLL
    for (int u = 0; u < kBatch; ++u) {
      const int it = it0 + u * nwarps < items ? it0 + u * nwarps : items - 1;
      for (int q = 0; q < G::kLanes; ++q)
        p[u][q] = mask_bit<kKind, kCone>(a, lo + it / NW, 32 * (it % NW) + g.lane(q));
    }
    NTW_UNROLL
    for (int u = 0; u < kBatch; ++u) {
      const int it = it0 + u * nwarps;
      if (it < items) {
        const uint32_t word = g.ballot(p[u]);
        if (g.lane(0) == 0) M[(it / NW * kMasks + kKind) * NW + it % NW] = word;
      }
    }
  }
}

template <typename T, int NW, bool kCone, class G>
NTW_HD void pack_masks(const G& g, int warp, int nwarps, const ScanArgs<T>& a,
                       int lo, int S, uint32_t* M) {
  pack_mask_rows<0, kCone, T, NW>(g, warp, nwarps, a, lo, S, M);
  pack_mask_rows<1, kCone, T, NW>(g, warp, nwarps, a, lo, S, M);
  pack_mask_rows<2, kCone, T, NW>(g, warp, nwarps, a, lo, S, M);
}

// One lane's row words of a parent slot: rows[i][j] is word j of the row
// whose first bit in F is pos[i] (row n = lane + 32i; a lane past the last
// row holds row N-1, and its frontier bit is 0 since the frontier has no
// pad bits, so the row is never kept).  A row spans NW + 1 words of F,
// each loaded once.  Words j with 32j >= N run into the next rows or F's
// pad: their bits lie past N, and exists[w] clears them.
template <int NW>
NTW_HD void load_rows(const uint32_t* F, const int (&pos)[NW],
                      uint32_t (&rows)[NW][NW]) {
  NTW_UNROLL
  for (int i = 0; i < NW; ++i) {
    const uint32_t* p = F + (pos[i] >> 5);
    const int r = pos[i] & 31;
    uint32_t w[NW + 1];
    NTW_UNROLL
    for (int k = 0; k <= NW; ++k) w[k] = p[k];
    NTW_UNROLL
    for (int j = 0; j < NW; ++j) rows[i][j] = funnel_r(w[j], w[j + 1], r);
  }
}

// Steps w = hi .. lo by one warp (run by warp 0 alone on the card):
//   h        = OR of parent[w+1] rows n in the frontier (none at w = W-1)
//   g        = (h & E[w]) | X[w]
//   reach[w] = g; lead = any(g & L[w]); committed[w] = lead (chain)
//   frontier = lead ? g & L[w] : g
// the rules of the JAX _chain_scan and causal_mask_scan (see the masks
// above for the anchor and the start).  Bit positions in F are relative
// to a0 and fit an int (F is at most 232,448 bytes).  A step has no
// branch but the uniform test for slot W-1, and its row loads do not
// depend on the frontier, so they issue while the previous step's
// reduction completes.
template <typename T, int NW, bool kCone, class G>
NTW_HD void scan_chunk(const G& g, const ScanArgs<T>& a, int lo, int hi,
                       int64_t a0, const uint32_t* M, const uint32_t* F,
                       uint32_t (&front)[NW]) {
  constexpr int kL = G::kLanes;
  const int N = a.N, NN = a.N * a.N;
  // pos[q][i]: the first bit in F of lane q's row i in slot w+1 (slot
  // hi+1 before the first step); each step moves it down one slot.
  int pos[kL][NW];
  const int rb = (int)((int64_t)(hi + 1) * NN - a0);
  for (int q = 0; q < kL; ++q) {
    NTW_UNROLL
    for (int i = 0; i < NW; ++i) {
      const int n = 32 * i + g.lane(q) < N ? 32 * i + g.lane(q) : N - 1;
      pos[q][i] = rb + n * N;
    }
  }
  const uint32_t* Mw = M + (hi - lo) * kMasks * NW;
  uint8_t* reach = a.reach != nullptr ? a.reach + (int64_t)hi * N : nullptr;
  for (int w = hi; w >= lo; --w, Mw -= kMasks * NW) {
    uint32_t acc[kL][NW];
    for (int q = 0; q < kL; ++q) {
      const int lane = g.lane(q);
      NTW_UNROLL
      for (int j = 0; j < NW; ++j) acc[q][j] = 0;
      if (w + 1 < a.W) {
        uint32_t rows[NW][NW];
        load_rows<NW>(F, pos[q], rows);
        NTW_UNROLL
        for (int i = 0; i < NW; ++i) {
          // All ones where the frontier holds the row's child, else 0.
          const uint32_t take = (uint32_t)((int32_t)(front[i] << (31 - lane)) >> 31);
          NTW_UNROLL
          for (int j = 0; j < NW; ++j) acc[q][j] |= rows[i][j] & take;
        }
      }
      NTW_UNROLL
      for (int i = 0; i < NW; ++i) pos[q][i] -= NN;
    }
    uint32_t h[NW];
    uint32_t hit = 0;
    NTW_UNROLL
    for (int j = 0; j < NW; ++j) {
      h[j] = (g.or_all(acc, j) & Mw[j]) | Mw[NW + j];
      hit |= h[j] & Mw[2 * NW + j];
    }
    const bool lead = hit != 0;
    NTW_UNROLL
    for (int j = 0; j < NW; ++j) front[j] = lead ? h[j] & Mw[2 * NW + j] : h[j];
    if (!kCone && g.lane(0) == 0) a.committed[w] = lead;
    if (reach != nullptr) {
      for (int q = 0; q < kL; ++q) {
        const int lane = g.lane(q);
        NTW_UNROLL
        for (int i = 0; i < NW; ++i)
          if (32 * i + lane < N) reach[32 * i + lane] = (h[i] >> lane) & 1u;
      }
      reach -= N;
    }
  }
}

// The whole scan in chunks of S slots, from the top: all nwarps warps pack
// a chunk into `pack` (on the card, the shared memory of the cluster's
// first block, which the other blocks reach through distributed shared
// memory), then warp 0 (of the first block) steps it from `smem`, the
// same memory seen locally.  Every warp runs every iteration and reaches
// its barriers; the frontier stays in warp 0's registers.  Every warp but
// warp 0 returns right after the last chunk's pack barrier.  With `cycles`
// not null (one thread of the first block) it records, in its SM's clock
// cycles, the pack of all chunks up to the barrier that ends it, the scan
// of all chunks, the whole, and the number of chunks.
template <typename T, int NW, bool kCone, class G>
NTW_HD void window_scan(const G& g, int warp, int nwarps, const ScanArgs<T>& a,
                        int S, uint32_t* smem, uint32_t* pack,
                        uint64_t* cycles) {
  const uint64_t t_start = g.clock();
  uint64_t t_pack = 0, t_scan = 0, t_end = t_start;
  int chunks = 0;
  uint32_t* F = smem + kMasks * S * NW;
  uint32_t* pF = pack + kMasks * S * NW;
  uint32_t front[NW];
  NTW_UNROLL
  for (int j = 0; j < NW; ++j) front[j] = 0;
  const int64_t NN = (int64_t)a.N * a.N;
  for (int hi = a.W - 1; hi >= 0; hi -= S) {
    const int lo = hi - S + 1 < 0 ? 0 : hi - S + 1;
    // Steps lo .. hi read the parent slots lo+1 .. min(hi+1, W-1).
    const int top = hi + 1 < a.W ? hi + 1 : a.W - 1;
    const int64_t e0 = (int64_t)(lo + 1) * NN;
    const int64_t e1 = top >= lo + 1 ? (int64_t)(top + 1) * NN : e0;
    const int64_t a0 =
        e0 - (int64_t)(reinterpret_cast<uintptr_t>(a.parent + e0) % 16) / (int64_t)sizeof(T);
    const uint64_t t0 = g.clock();
    for (int v = warp; v < warp + g.warps(); ++v) {
      pack_flat(g, v, nwarps, a.parent, a0, e0, e1, pF);
      pack_masks<T, NW, kCone>(g, v, nwarps, a, lo, hi - lo + 1, pack);
    }
    g.sync();
    const uint64_t t1 = g.clock();
    if (warp == 0) scan_chunk<T, NW, kCone>(g, a, lo, hi, a0, smem, F, front);
    t_end = g.clock();
    t_pack += t1 - t0;
    t_scan += t_end - t1;
    ++chunks;
    // The next chunk's pack must wait for the scan.  After the last chunk
    // nothing reads shared memory the others write, so nobody waits.
    if (lo > 0) g.sync();
  }
  if (cycles != nullptr) {
    cycles[0] = t_pack;
    cycles[1] = t_scan;
    cycles[2] = t_end - t_start;
    cycles[3] = (uint64_t)chunks;
  }
}

// ------------------------------------------------------------ the support gate
//
// The f+1 support gate of the JAX support_stake: the stake of the
// certificates at child slot s that exist and cite the leader,
//   sum over m of stake[m] where exists[s][m] and
//   any over n of (parent[s][m][n] and leader[n]).
// The rows m are split over warps in groups of 32 (group i holds rows
// 32i .. 32i+31, lane q row 32i + q; warp k of nwarps takes groups k,
// k + nwarps, ...).  A warp, per group:
//   1. loads its lanes' exists[s][m] and stake[m] (and, once, the leader
//      row) first, so that those loads are in flight with the rows';
//   2. packs the group's rows, 32 N contiguous bytes of the slot, into a
//      flat bit string F in its own shared memory (pack_gate_rows: 16-byte
//      loads, coalesced across the warp, all issued before any is used);
//   3. cuts each lane's row out of F with funnel shifts (NW + 1 words),
//      as the step does, and ANDs it with the leader's NW words, made
//      once with ballots (no bit at or past N, so bits past a row's end,
//      the next row's or junk behind the group, meet no leader bit);
//   4. masks with exists and sums stake over its lanes.
// Every input is read once, straight from global memory, so the gate
// needs none of a scan's chunk logic.  The sum is mod 2^32, as JAX's int32
// sum; the warp returns its part (the callers add the warps' parts).
struct GateArgs {
  const uint8_t* parent;  // [W][N][N]
  const uint8_t* exists;  // [W][N]
  const int32_t* stake;   // [N]
  const uint8_t* leader;  // [N]
  int slot;               // the child slot s, in [0, W) (the caller's rule)
  int N;
};

NTW_HD int gate_groups(int n) { return (n + 31) / 32; }

// Shared words of one warp's F: a group's 32 N elements from a0 on in whole
// groups of 512, up to 15 elements of alignment slack in front, and the
// NW + 1 words the last row's cut may read.
NTW_HD int gate_words(int n, int nw) { return (32 * n + 15 + 511) / 512 * 16 + nw + 1; }

// The warps of the flagship commit step's cluster that run the gate: those
// of every block but the first (which holds warp 0).
NTW_HD constexpr int gate_warps(int nw) {
  return (kClusterBlocks - 1) * (scan_block(nw) / 32);
}

// The gate packs a group's rows with whole 16-byte loads, its first and
// last vectors too: a vector that holds an element of [e0, e1) lies in the
// same aligned 16 bytes as that element, so inside the tensor's allocation
// (CUDA's allocators align and round allocations to far more than 16
// bytes), and its bits outside [e0, e1) are cleared.  A vector wholly past
// e1 is not loaded.  On the card a lane issues its kGateBatch loads before
// it reads any, so that one round trip to memory serves them all.  The
// host reads only the elements inside.
constexpr int kGateBatch = 4;

// Bits of the elements e .. e+15 whose bits `b` are, those outside
// [e0, e1) cleared (e0 - e < 16: a0 is e0 rounded down).
NTW_HD uint32_t clip_bits(uint32_t b, int64_t e, int64_t e0, int64_t e1) {
  if (e >= e1) return 0;
  if (e < e0) b &= ~0u << (e0 - e);
  if (e1 - e < 16) b &= (1u << (e1 - e)) - 1u;
  return b;
}

template <class G>
NTW_HD void pack_gate_rows(const G& g, const uint8_t* src, int64_t a0, int64_t e0,
                           int64_t e1, uint32_t* F) {
  constexpr int kPer = per_lane<uint8_t>(), kGroup = 32 * kPer;
  const int64_t groups = (e1 - a0 + kGroup - 1) / kGroup;
  for (int64_t k0 = 0; k0 < groups; k0 += kGateBatch) {
    uint32_t bits[kGateBatch][G::kLanes];
#ifdef __CUDA_ARCH__
    uint4 raw[kGateBatch];
    NTW_UNROLL
    for (int u = 0; u < kGateBatch; ++u) {
      const int64_t e = a0 + kGroup * (k0 + u) + kPer * g.lane(0);
      raw[u] = e < e1 ? __ldg(reinterpret_cast<const uint4*>(src + e)) : make_uint4(0, 0, 0, 0);
    }
    NTW_UNROLL
    for (int u = 0; u < kGateBatch; ++u) {
      const uint32_t b = byte_bits(raw[u].x) | byte_bits(raw[u].y) << 4 |
                         byte_bits(raw[u].z) << 8 | byte_bits(raw[u].w) << 12;
      bits[u][0] = clip_bits(b, a0 + kGroup * (k0 + u) + kPer * g.lane(0), e0, e1);
    }
#else
    for (int u = 0; u < kGateBatch; ++u)
      for (int q = 0; q < G::kLanes; ++q)
        bits[u][q] = edge_bits(src, a0 + kGroup * (k0 + u) + kPer * g.lane(q), e0, e1);
#endif
    NTW_UNROLL
    for (int u = 0; u < kGateBatch; ++u)
      if (k0 + u < groups) g.template store_lane_bits<kPer>(bits[u], F + kPer * (k0 + u));
  }
}

template <int NW, class G>
NTW_HD uint32_t support_gate(const G& g, int warp, int nwarps, const GateArgs& a,
                             uint32_t* F) {
  constexpr int kL = G::kLanes;
  const int N = a.N;
  const int groups = gate_groups(N);
  uint32_t sum[kL];
  for (int q = 0; q < kL; ++q) sum[q] = 0;
  if (warp >= groups) return 0;
  // The loads first, no value read until the rows' loads are issued too.
  uint8_t lead_raw[NW][kL];
  NTW_UNROLL
  for (int j = 0; j < NW; ++j)
    for (int q = 0; q < kL; ++q) {
      const int n = 32 * j + g.lane(q);
      lead_raw[j][q] = n < N ? a.leader[n] : 0;
    }
  uint32_t lead[NW] = {};
  for (int i = warp; i < groups; i += nwarps) {
    const int m0 = 32 * i;
    const int rows = N - m0 < 32 ? N - m0 : 32;
    uint8_t ex[kL];
    uint32_t st[kL];
    for (int q = 0; q < kL; ++q) {
      const int m = m0 + (g.lane(q) < rows ? g.lane(q) : 0);
      ex[q] = a.exists[(int64_t)a.slot * N + m];
      st[q] = (uint32_t)a.stake[m];
    }
    const int64_t e0 = ((int64_t)a.slot * N + m0) * N;
    const int64_t a0 = e0 - (int64_t)(reinterpret_cast<uintptr_t>(a.parent + e0) % 16);
    pack_gate_rows(g, a.parent, a0, e0, e0 + (int64_t)rows * N, F);
    if (i == warp) {
      NTW_UNROLL
      for (int j = 0; j < NW; ++j) {
        bool p[kL];
        for (int q = 0; q < kL; ++q) p[q] = lead_raw[j][q] != 0;
        lead[j] = g.ballot(p);
      }
    }
    g.sync_warp();
    for (int q = 0; q < kL; ++q) {
      const int pos = (int)(e0 - a0) + g.lane(q) * N;
      const uint32_t* p = F + (pos >> 5);
      const int r = pos & 31;
      uint32_t hit = 0;
      NTW_UNROLL
      for (int j = 0; j < NW; ++j) hit |= funnel_r(p[j], p[j + 1], r) & lead[j];
      if (g.lane(q) < rows && ex[q] != 0 && hit != 0) sum[q] += st[q];
    }
    g.sync_warp();  // before the next group's pack overwrites F
  }
  return g.add_all(sum);
}

}  // namespace ntw

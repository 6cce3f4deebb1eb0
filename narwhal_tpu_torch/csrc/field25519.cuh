// GF(2^255 - 19) and edwards25519 point arithmetic for the batched
// verifier: the field for one CUDA thread, the point formulas for a group
// of four threads that work one signature together.
//
// A field element is 10 uint32 limbs of 26 and 25 bits in turn (radix
// 2^25.5), so every limb product is one 32x32->64-bit multiply-add
// (IMAD.WIDE.U32), the card's native integer product.  (The JAX reference
// uses 32 limbs of 8 bits because the TPU has no 64-bit multiply.  5 limbs
// of 51 bits would need 64x64->128 products, which the card builds from
// several 32-bit ones.)
//
// Bounds.  "Weak" means even limbs < 2^27 and odd limbs < 2^26; every
// function below takes weak inputs and returns weak outputs.  fe_mul and
// fe_sq: 2*a_i < 2^27 and 19*b_j < 2^31.3 fit 32 bits, a product is
// < 2^58.3, a column of ten < 2^61.7 < 2^64; fe_reduce leaves limbs inside
// their widths except limbs 1 and 5 (< 2^25 + 2^16).  fe_add and fe_sub
// (a + 4p - b, 4p's limbs above any weak b's) stay under 2^29 and carry
// once.  fe_canon fully reduces into [0, p) and must precede every
// equality and parity test.
//
// Everything is __host__ __device__ so the same source also compiles with
// a host C++ compiler: tests/test_torch_ed25519_lanes.py builds
// tests/ed25519_lanes_host.cpp with g++ and steps the four lanes of the
// point formulas in lockstep on the CPU.

#pragma once

#include <cstdint>

#ifdef __CUDACC__
#define NT_HD __host__ __device__ inline
#define NT_UNROLL _Pragma("unroll")
#else
#define NT_HD inline
#define NT_UNROLL
#endif

namespace nt {

// Limb i holds bits [OFF_i, OFF_i + 26) for even i and 25 bits for odd
// i (radix 2^25.5; limb 9 ends at bit 255).
struct fe {
  uint32_t v[10];
};

NT_HD constexpr int limb_bits(int i) { return 26 - (i & 1); }
NT_HD constexpr uint32_t limb_mask(int i) { return (1u << limb_bits(i)) - 1; }

// An extended twisted-Edwards point (X:Y:Z:T), x = X/Z, y = Y/Z, T = XY/Z.
struct ge {
  fe X, Y, Z, T;
};

// Curve constants and the base table j*B (j = 0..15) in cached form, entry
// j's coordinate for lane q at base[j][q] (see the four-lane section),
// filled by the host once per process (ops/ed25519.py::cuda_consts).
struct Ed25519Consts {
  fe d;
  fe d2;
  fe sqrt_m1;
  fe base[16][4];
};

#ifdef NT_COUNT_FE_MULS
// Host builds only: every fe_mul adds one to fe_mul_count and every
// fe_sq one to fe_sq_count, so a test counts the multiplies one verify
// runs instead of trusting a hand count.
extern long fe_mul_count;
extern long fe_sq_count;
#endif

NT_HD fe fe_zero() { return fe{{0, 0, 0, 0, 0, 0, 0, 0, 0, 0}}; }
NT_HD fe fe_one() { return fe{{1, 0, 0, 0, 0, 0, 0, 0, 0, 0}}; }

// One carry sweep from limb 0 up; the carry out of limb 9 wraps to limb 0
// times 19.  Takes limbs < 2^29; leaves limbs 1..9 inside their widths and
// limb 0 < 2^26 + 2^9.
NT_HD fe fe_carry(fe a) {
NT_UNROLL
  for (int i = 0; i < 9; ++i) {
    a.v[i + 1] += a.v[i] >> limb_bits(i);
    a.v[i] &= limb_mask(i);
  }
  const uint32_t c = a.v[9] >> 25;
  a.v[9] &= limb_mask(9);
  a.v[0] += 19 * c;
  return a;
}

NT_HD fe fe_add(const fe& a, const fe& b) {
  fe r;
NT_UNROLL
  for (int i = 0; i < 10; ++i) r.v[i] = a.v[i] + b.v[i];
  return fe_carry(r);
}

// a - b as a + 4p - b: 4p's limbs are 2^28 - 76, then 2^27 - 4 (odd) and
// 2^28 - 4 (even), each above any weak limb of b.
NT_HD fe fe_sub(const fe& a, const fe& b) {
  fe r;
NT_UNROLL
  for (int i = 0; i < 10; ++i)
    r.v[i] = a.v[i] + (i == 0 ? (1u << 28) - 76 : (4u << limb_bits(i)) - 4) - b.v[i];
  return fe_carry(r);
}

NT_HD fe fe_neg(const fe& a) { return fe_sub(fe_zero(), a); }

// The column sums h[k] (< 2^62) back to weak limbs: two interleaved carry
// chains, then the wrap of limb 9's carry times 19 and one more carry out
// of limb 0.  Limbs end inside their widths except limbs 1 and 5, which
// stay < 2^25 + 2^16.
NT_HD void carry_column(uint64_t* h, int i) {
  h[i + 1] += h[i] >> limb_bits(i);
  h[i] &= limb_mask(i);
}

NT_HD fe fe_reduce(uint64_t* h) {
  carry_column(h, 0); carry_column(h, 4);
  carry_column(h, 1); carry_column(h, 5);
  carry_column(h, 2); carry_column(h, 6);
  carry_column(h, 3); carry_column(h, 7);
  carry_column(h, 4); carry_column(h, 8);
  h[0] += 19 * (h[9] >> 25);
  h[9] &= limb_mask(9);
  carry_column(h, 0);
  fe r;
NT_UNROLL
  for (int i = 0; i < 10; ++i) r.v[i] = (uint32_t)h[i];
  return r;
}

// Schoolbook 10 x 10 with 2^255 = 19: limb products whose bit offsets
// overshoot by one (both limbs odd) are doubled, and products that wrap
// past limb 9 take 19 * b_j.  Every product is a 32 x 32 -> 64-bit
// multiply-add (one IMAD.WIDE.U32 on the card): 2*a_i < 2^27, 19*b_j <
// 2^31.3, so a product is < 2^58.3 and a column of ten < 2^61.7.
NT_HD fe fe_mul(const fe& a, const fe& b) {
#ifdef NT_COUNT_FE_MULS
  ++fe_mul_count;
#endif
  uint32_t b19[10];
NT_UNROLL
  for (int j = 0; j < 10; ++j) b19[j] = 19 * b.v[j];
  uint64_t h[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
NT_UNROLL
  for (int i = 0; i < 10; ++i) {
NT_UNROLL
    for (int j = 0; j < 10; ++j) {
      const uint32_t left = (i & j & 1) ? 2 * a.v[i] : a.v[i];
      const uint32_t right = i + j >= 10 ? b19[j] : b.v[j];
      h[(i + j) % 10] += (uint64_t)left * right;
    }
  }
  return fe_reduce(h);
}

// a^2 with each cross product taken once and doubled: 55 products.  The
// doublings go on the left factor (2*2*a_i < 2^28), the 19 on the right.
NT_HD fe fe_sq(const fe& a) {
#ifdef NT_COUNT_FE_MULS
  ++fe_sq_count;
#endif
  uint32_t a19[10];
NT_UNROLL
  for (int j = 0; j < 10; ++j) a19[j] = 19 * a.v[j];
  uint64_t h[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
NT_UNROLL
  for (int i = 0; i < 10; ++i) {
NT_UNROLL
    for (int j = i; j < 10; ++j) {
      const uint32_t twice = (i != j ? 2 : 1) * ((i & j & 1) ? 2 : 1);
      const uint32_t right = i + j >= 10 ? a19[j] : a.v[j];
      h[(i + j) % 10] += (uint64_t)(twice * a.v[i]) * right;
    }
  }
  return fe_reduce(h);
}

NT_HD fe fe_pow2k(fe a, int k) {
  for (int i = 0; i < k; ++i) a = fe_sq(a);
  return a;
}

// a^(2^250 - 1), shared by invert and pow_p58 (the standard addition chain).
NT_HD fe fe_pow_2_250_1(const fe& a) {
  const fe x2 = fe_mul(fe_sq(a), a);               // 2^2 - 1
  const fe x4 = fe_mul(fe_pow2k(x2, 2), x2);       // 2^4 - 1
  const fe x5 = fe_mul(fe_sq(x4), a);              // 2^5 - 1
  const fe x10 = fe_mul(fe_pow2k(x5, 5), x5);      // 2^10 - 1
  const fe x20 = fe_mul(fe_pow2k(x10, 10), x10);   // 2^20 - 1
  const fe x40 = fe_mul(fe_pow2k(x20, 20), x20);   // 2^40 - 1
  const fe x50 = fe_mul(fe_pow2k(x40, 10), x10);   // 2^50 - 1
  const fe x100 = fe_mul(fe_pow2k(x50, 50), x50);  // 2^100 - 1
  const fe x200 = fe_mul(fe_pow2k(x100, 100), x100);
  return fe_mul(fe_pow2k(x200, 50), x50);          // 2^250 - 1
}

// a^((p-5)/8) = a^(2^252 - 3) = (a^(2^250 - 1))^4 * a.
NT_HD fe fe_pow_p58(const fe& a) { return fe_mul(fe_pow2k(fe_pow_2_250_1(a), 2), a); }

// Full reduction into [0, p), every limb inside its width.
NT_HD fe fe_canon(fe a) {
  a = fe_carry(fe_carry(a));  // limbs in width but limb 0 < 2^26 + 19: < 2p
  // q = 1 iff a >= p, i.e. iff a + 19 carries out of bit 255.
  uint32_t q = (a.v[0] + 19) >> 26;
NT_UNROLL
  for (int i = 1; i < 10; ++i) q = (a.v[i] + q) >> limb_bits(i);
  a.v[0] += 19 * q;
NT_UNROLL
  for (int i = 0; i < 9; ++i) {
    a.v[i + 1] += a.v[i] >> limb_bits(i);
    a.v[i] &= limb_mask(i);
  }
  a.v[9] &= limb_mask(9);  // drops the 2^255 that q accounted for
  return a;
}

NT_HD bool fe_is_zero(const fe& a) {
  const fe c = fe_canon(a);
  uint32_t any = 0;
NT_UNROLL
  for (int i = 0; i < 10; ++i) any |= c.v[i];
  return any == 0;
}

NT_HD bool fe_eq(const fe& a, const fe& b) { return fe_is_zero(fe_sub(a, b)); }

NT_HD fe fe_select(bool c, const fe& a, const fe& b) { return c ? a : b; }

// 32 little-endian bytes held one per int32 (the host prep's 8-bit limbs;
// bit 255 already cleared) -> 10 limbs.  The value may be >= p.
NT_HD fe fe_from_limbs8(const int32_t* b) {
  uint64_t w[4];
  for (int k = 0; k < 4; ++k) {
    uint64_t x = 0;
    for (int j = 7; j >= 0; --j) x = (x << 8) | (uint64_t)(b[8 * k + j] & 0xff);
    w[k] = x;
  }
  fe r;
  int off = 0;
NT_UNROLL
  for (int i = 0; i < 10; ++i) {
    const int word = off / 64, shift = off % 64;
    uint64_t bits = w[word] >> shift;
    if (shift + limb_bits(i) > 64) bits |= w[word + 1] << (64 - shift);
    r.v[i] = (uint32_t)bits & limb_mask(i);
    off += limb_bits(i);
  }
  return r;
}

// ------------------------------------------------------ one-lane decompress

// Compressed y (+ sign bit) -> extended point; *valid is false for a
// non-canonical y (decided by the host), a y with no x on the curve, and
// the x = 0 / sign = 1 encoding (RFC 8032 section 5.1.3).  The formulas of
// the JAX reference (narwhal_tpu/ops/ed25519.py); 275 multiplies, 262 of
// them in the square-root chain, which no lane split can shorten.
NT_HD ge ge_decompress(const fe& y, int sign, bool y_canonical, const fe& d,
                       const fe& sqrt_m1, bool* valid) {
  const fe yy = fe_sq(y);
  const fe u = fe_sub(yy, fe_one());
  const fe v = fe_add(fe_mul(yy, d), fe_one());
  const fe v3 = fe_mul(fe_sq(v), v);
  const fe v7 = fe_mul(fe_sq(v3), v);
  fe x = fe_mul(fe_mul(u, v3), fe_pow_p58(fe_mul(u, v7)));
  const fe vxx = fe_mul(v, fe_sq(x));
  const bool ok_direct = fe_eq(vxx, u);
  const bool ok_twist = fe_eq(vxx, fe_neg(u));
  x = fe_select(ok_direct, x, fe_mul(x, sqrt_m1));
  const fe xc = fe_canon(x);
  const bool x_is_zero = fe_is_zero(xc);
  const bool sign_ok = !(x_is_zero && sign == 1);
  const bool flip = (int)(xc.v[0] & 1) != sign;
  x = fe_select(flip, fe_neg(xc), xc);
  *valid = (ok_direct || ok_twist) && sign_ok && y_canonical;
  return ge{x, y, fe_one(), fe_mul(x, y)};
}

// ------------------------------------------------------------ four lanes
//
// One signature is worked by a group of four lanes.  Lane q holds
// coordinate q of every point: X, Y, Z, T of an extended point, or
// Y-X, Y+X, 2d*T, 2Z of a point in cached form, the addend of an add,
// ordered so that the cached coordinate lane q holds is the one it
// multiplies by in the add's first round.  Each point operation is two
// rounds of four independent multiplies, one per lane (Hisil, Wong,
// Carter and Dawson, "Twisted Edwards Curves Revisited", ASIACRYPT 2008,
// the four-processor schedules for a = -1), so the ladder's serial chain
// is a quarter of one thread's.
//
// The formulas are written once, over a lane group G:
//   G::F, G::B             a field element, a bool, per lane
//   g.all(c)               c in every lane
//   g.sel(a0, a1, a2, a3)  a_q in lane q
//   g.shfl(v, s0..s3)      lane q gets lane s_q's v
//   g.lane(b, s)           lane s's b, in every lane
//   g.get(tab, e, s0..s3)  lane q reads lane s_q's slot of table entry e
//   g.put(tab, e, v)       each lane writes its slot of entry e
//   g.sync()               orders the group's table writes before reads
// WarpLanes (the card) keeps this thread's lane and exchanges with
// __shfl_sync inside its group of four; HostLanes keeps all four lanes
// and steps them in lockstep, for a CPU check of the same formulas.
// Every lane evaluates every candidate of a g.sel, so the group never
// diverges, and no exchange sits behind a branch that the groups of one
// warp may take apart.

#ifdef __CUDACC__
struct WarpLanes {
  using F = fe;
  using B = bool;
  int q;  // this thread's lane in its group, 0..3

  NT_HD int pick(int s0, int s1, int s2, int s3) const {
    return q == 0 ? s0 : q == 1 ? s1 : q == 2 ? s2 : s3;
  }
  NT_HD fe all(const fe& c) const { return c; }
  NT_HD fe sel(const fe& a0, const fe& a1, const fe& a2, const fe& a3) const {
    fe r;
    for (int i = 0; i < 10; ++i)
      r.v[i] = q == 0 ? a0.v[i] : q == 1 ? a1.v[i] : q == 2 ? a2.v[i] : a3.v[i];
    return r;
  }
  NT_HD fe shfl(const fe& v, int s0, int s1, int s2, int s3) const {
#ifdef __CUDA_ARCH__
    const int s = pick(s0, s1, s2, s3);
    fe r;
    for (int i = 0; i < 10; ++i) r.v[i] = __shfl_sync(0xffffffffu, v.v[i], s, 4);
    return r;
#else
    return v;  // never run on the host: HostLanes stands in there
#endif
  }
  NT_HD bool lane(bool b, int s) const {
#ifdef __CUDA_ARCH__
    return __shfl_sync(0xffffffffu, (int)b, s, 4) != 0;
#else
    return b;
#endif
  }
  template <class Tab>
  NT_HD fe get(const Tab& t, int e, int s0, int s1, int s2, int s3) const {
    return t.get(e, pick(s0, s1, s2, s3));
  }
  template <class Tab>
  NT_HD void put(const Tab& t, int e, const fe& v) const { t.put(e, q, v); }
  NT_HD void sync() const {
#ifdef __CUDA_ARCH__
    __syncwarp();
#endif
  }
};
#endif  // __CUDACC__

// Four lanes' values side by side, for HostLanes; the field ops act lane
// by lane.
struct fe4 {
  fe l[4];
};
struct b4 {
  bool l[4];
};

NT_HD fe4 fe_add(const fe4& a, const fe4& b) {
  fe4 r;
  for (int k = 0; k < 4; ++k) r.l[k] = fe_add(a.l[k], b.l[k]);
  return r;
}
NT_HD fe4 fe_sub(const fe4& a, const fe4& b) {
  fe4 r;
  for (int k = 0; k < 4; ++k) r.l[k] = fe_sub(a.l[k], b.l[k]);
  return r;
}
NT_HD fe4 fe_mul(const fe4& a, const fe4& b) {
  fe4 r;
  for (int k = 0; k < 4; ++k) r.l[k] = fe_mul(a.l[k], b.l[k]);
  return r;
}
NT_HD fe4 fe_sq(const fe4& a) {
  fe4 r;
  for (int k = 0; k < 4; ++k) r.l[k] = fe_sq(a.l[k]);
  return r;
}
NT_HD fe4 fe_neg(const fe4& a) {
  fe4 r;
  for (int k = 0; k < 4; ++k) r.l[k] = fe_neg(a.l[k]);
  return r;
}
NT_HD b4 fe_eq(const fe4& a, const fe4& b) {
  b4 r;
  for (int k = 0; k < 4; ++k) r.l[k] = fe_eq(a.l[k], b.l[k]);
  return r;
}
NT_HD b4 fe_is_zero(const fe4& a) {
  b4 r;
  for (int k = 0; k < 4; ++k) r.l[k] = fe_is_zero(a.l[k]);
  return r;
}

struct HostLanes {
  using F = fe4;
  using B = b4;

  fe4 all(const fe& c) const { return fe4{{c, c, c, c}}; }
  fe4 sel(const fe4& a0, const fe4& a1, const fe4& a2, const fe4& a3) const {
    return fe4{{a0.l[0], a1.l[1], a2.l[2], a3.l[3]}};
  }
  fe4 shfl(const fe4& v, int s0, int s1, int s2, int s3) const {
    return fe4{{v.l[s0], v.l[s1], v.l[s2], v.l[s3]}};
  }
  bool lane(const b4& b, int s) const { return b.l[s]; }
  template <class Tab>
  fe4 get(const Tab& t, int e, int s0, int s1, int s2, int s3) const {
    return fe4{{t.get(e, s0), t.get(e, s1), t.get(e, s2), t.get(e, s3)}};
  }
  template <class Tab>
  void put(const Tab& t, int e, const fe4& v) const {
    for (int k = 0; k < 4; ++k) t.put(e, k, v.l[k]);
  }
  void sync() const {}
};

// The base table j*B, cached, one fe per (entry, lane).
struct BaseTable {
  const fe (*b)[4];
  NT_HD fe get(int e, int lane) const { return b[e][lane]; }
};

// Extended -> cached: Y-X, Y+X, 2d*T, 2Z (one multiply, lane 2's).
template <class G>
NT_HD typename G::F lanes_cached(const G& g, const typename G::F& p,
                                 const fe& d2) {
  using F = typename G::F;
  const F v = g.shfl(p, 1, 0, 3, 2);  // Y, X, T, Z
  return g.sel(fe_sub(v, p), fe_add(p, v), fe_mul(v, g.all(d2)), fe_add(v, v));
}

// P + Q, P extended and Q cached (add-2008-hwcd-3, a = -1):
// A = (Y1-X1)(Y2-X2), B = (Y1+X1)(Y2+X2), C = T1*2d*T2, D = Z1*2Z2, one
// per lane; then E = B-A, F = D-C, G = D+C, H = B+A and
// X3 = EF, Y3 = GH, Z3 = FG, T3 = EH.
template <class G>
NT_HD typename G::F lanes_add(const G& g, const typename G::F& p,
                              const typename G::F& qc) {
  using F = typename G::F;
  const F v = g.shfl(p, 1, 0, 3, 2);                                // Y, X, T, Z
  const F m = fe_mul(g.sel(fe_sub(v, p), fe_add(p, v), v, v), qc);  // A, B, C, D
  const F w = g.shfl(m, 1, 0, 3, 2);                                // B, A, D, C
  const F dif = fe_sub(w, m), sum = fe_add(m, w);
  const F n = g.sel(dif, sum, dif, sum);                            // E, H, F, G
  return fe_mul(g.shfl(n, 0, 1, 2, 1), g.shfl(n, 2, 3, 3, 0));
}

// 2P (dbl-2008-hwcd, a = -1): four squarings (X+Y)^2, Y^2, Z^2, X^2, then
// with A = X^2, B = Y^2, H = A+B, G = A-B, E = H-(X+Y)^2, F = 2Z^2+G:
// X3 = EF, Y3 = GH, Z3 = FG, T3 = EH.  T is not read.
template <class G>
NT_HD typename G::F lanes_double(const G& g, const typename G::F& p) {
  using F = typename G::F;
  const F s = g.shfl(p, 1, 1, 2, 0);                         // Y, Y, Z, X
  const F m = fe_sq(g.sel(fe_add(p, s), p, p, s));           // S, B, Z^2, A
  const F a = g.shfl(m, 3, 3, 3, 3);
  const F b = g.shfl(m, 1, 1, 1, 1);
  const F w = g.shfl(m, 2, 0, 2, 0);                         // Z^2, S, Z^2, S
  const F h = fe_add(a, b), gg = fe_sub(a, b);
  const F e = fe_sub(h, g.sel(m, m, m, w));
  const F f = fe_add(fe_add(w, w), gg);
  return fe_mul(g.sel(e, gg, f, e), g.sel(f, h, gg, h));
}

// [8]P == identity (the 8-torsion subgroup): X == 0 and Y == Z.
template <class G>
NT_HD bool lanes_is_small_order(const G& g, const typename G::F& p) {
  using F = typename G::F;
  const F p8 = lanes_double(g, lanes_double(g, lanes_double(g, p)));
  const F z = g.shfl(p8, 2, 2, 2, 2);
  const bool x_zero = g.lane(fe_is_zero(p8), 0);
  const bool y_is_z = g.lane(fe_eq(p8, z), 1);
  return x_zero && y_is_z;
}

// Entries 0..8 of j*P in cached form, for signed digits.
static constexpr int LANE_TABLE_ENTRIES = 9;

template <class G, class Tab>
NT_HD void lanes_build_table(const G& g, const Tab& tab,
                             const typename G::F& p, const fe& d2) {
  using F = typename G::F;
  const fe two = {{2, 0, 0, 0, 0}};
  g.put(tab, 0, g.sel(g.all(fe_one()), g.all(fe_one()), g.all(fe_zero()),
                      g.all(two)));  // the identity
  const F c1 = lanes_cached(g, p, d2);
  g.put(tab, 1, c1);
  F pj = p;
  for (int j = 2; j < LANE_TABLE_ENTRIES; ++j) {
    pj = lanes_add(g, pj, c1);
    g.put(tab, j, lanes_cached(g, pj, d2));
  }
  g.sync();
}

// The cached entry for a signed digit in [-8, 8]: -P in cached form swaps
// Y-X with Y+X (lanes 0 and 1 read each other's slot) and negates 2d*T.
template <class G, class Tab>
NT_HD typename G::F lanes_lookup(const G& g, const Tab& tab, int digit) {
  using F = typename G::F;
  const bool neg = digit < 0;
  const F v = g.get(tab, neg ? -digit : digit, neg, !neg, 2, 3);
  const F nv = fe_neg(v);
  return neg ? g.sel(v, v, nv, v) : v;
}

// One signature, every check of the JAX _verify_kernel, given each lane's
// decompression (lanes 0-1 decompressed A, lanes 2-3 R: x, y, T = xy and
// the encoding's validity): reject small-order A or R, build j*(-A), run
// the 64-window MSB-first Straus ladder [S]B + [k](-A), compare with R
// projectively.  The k windows are recoded into signed digits in [-8, 7],
// so the -A table holds 9 entries; this needs k's top window plus its
// carry below 8, which holds for k < L, as the host prep makes every k.
template <class G, class Tab>
NT_HD bool lanes_verify(const G& g, const Tab& tab, const BaseTable& base,
                        const fe& d2, const typename G::F& x,
                        const typename G::F& y, const typename G::F& t,
                        const typename G::B& valid, bool s_ok,
                        const int32_t* s_windows, const int32_t* k_windows) {
  using F = typename G::F;
  const F zero = g.all(fe_zero()), one = g.all(fe_one());
  const F a = g.sel(x, y, one, g.shfl(t, 0, 0, 0, 0));
  const F r = g.sel(g.shfl(x, 2, 2, 2, 2), g.shfl(y, 2, 2, 2, 2), one, t);
  const bool a_valid = g.lane(valid, 0), r_valid = g.lane(valid, 2);
  const bool a_small = lanes_is_small_order(g, a);
  const bool r_small = lanes_is_small_order(g, r);

  lanes_build_table(g, tab, g.sel(fe_neg(a), a, a, fe_neg(a)), d2);

  // Bit i: the carry into window i of the signed recoding (LSB window 63).
  uint64_t carry = 0;
  int c = 0;
  for (int i = 63; i >= 0; --i) {
    if (c) carry |= uint64_t(1) << i;
    c = (k_windows[i] & 15) + c >= 8;
  }

  F acc = g.sel(zero, one, one, zero);
  for (int step = 0; step < 64; ++step) {
    acc = lanes_double(g, lanes_double(g, lanes_double(g, lanes_double(g, acc))));
    acc = lanes_add(g, acc, g.get(base, s_windows[step] & 15, 0, 1, 2, 3));
    int digit = (k_windows[step] & 15) + (int)((carry >> step) & 1);
    if (digit >= 8) digit -= 16;
    acc = lanes_add(g, acc, lanes_lookup(g, tab, digit));
  }
  // R has Z = 1: X == x_R * Z (lane 0) and Y == y_R * Z (lane 1).
  const typename G::B e = fe_eq(fe_mul(r, g.shfl(acc, 2, 2, 2, 2)), acc);
  const bool eq_x = g.lane(e, 0), eq_y = g.lane(e, 1);
  return a_valid && r_valid && !a_small && !r_small && s_ok && eq_x && eq_y;
}

}  // namespace nt

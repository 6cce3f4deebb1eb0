// GF(2^255 - 19) and edwards25519 point arithmetic for one CUDA thread.
//
// The card has a native 32x32->64 integer multiply (and __umul64hi), so a
// field element is 5 unsigned limbs of 51 bits in uint64 (radix 2^51), and
// a limb product is a 64x64->128 product.  (The JAX reference uses 32 limbs
// of 8 bits only because the TPU has no 64-bit multiply.)
//
// Bounds.  "Weak" means every limb < 2^52; every function below takes weak
// inputs and returns weak outputs.  fe_mul: 19*b_i < 2^56.3, a_i*19*b_i <
// 2^108.3, a sum of five < 2^110.7 < 2^128; the top carry (< 2^59.7) times
// 19 is < 2^64; after the final carry every limb is < 2^51 + 2^13.  fe_add
// and fe_sub (a + 4p - b, with 4p's limbs >= 2^53 - 76 > any weak b) carry
// once, leaving limbs < 2^51 + 2^8.  fe_canon fully reduces into [0, p)
// with limbs < 2^51 and must precede every equality and parity test.
//
// Everything is __host__ __device__ so the same source also compiles with
// a host C++ compiler for a CPU check.

#pragma once

#include <cstdint>

#ifdef __CUDACC__
#define NT_HD __host__ __device__ inline
#else
#define NT_HD inline
#endif

namespace nt {

static constexpr uint64_t MASK51 = (uint64_t(1) << 51) - 1;

struct fe {
  uint64_t v[5];
};

// An extended twisted-Edwards point (X:Y:Z:T), x = X/Z, y = Y/Z, T = XY/Z.
struct ge {
  fe X, Y, Z, T;
};

// Curve constants and the base table j*B (j = 0..15, extended coordinates),
// filled by the host once per process.
struct Ed25519Consts {
  fe d;
  fe d2;
  fe sqrt_m1;
  ge base[16];
};

NT_HD void mul64(uint64_t a, uint64_t b, uint64_t& lo, uint64_t& hi) {
#ifdef __CUDA_ARCH__
  lo = a * b;
  hi = __umul64hi(a, b);
#else
  const unsigned __int128 p = (unsigned __int128)a * b;
  lo = (uint64_t)p;
  hi = (uint64_t)(p >> 64);
#endif
}

// A 128-bit accumulator (lo, hi).
struct acc128 {
  uint64_t lo, hi;
};

NT_HD void mac(acc128& r, uint64_t a, uint64_t b) {
  uint64_t lo, hi;
  mul64(a, b, lo, hi);
  r.lo += lo;
  r.hi += hi + (r.lo < lo);
}

NT_HD uint64_t shr51(const acc128& r) { return (r.hi << 13) | (r.lo >> 51); }

NT_HD fe fe_zero() { return fe{{0, 0, 0, 0, 0}}; }
NT_HD fe fe_one() { return fe{{1, 0, 0, 0, 0}}; }

// One carry sweep; the carry out of the top limb wraps to limb 0 times 19.
NT_HD fe fe_carry(fe a) {
  uint64_t c;
  c = a.v[0] >> 51; a.v[0] &= MASK51; a.v[1] += c;
  c = a.v[1] >> 51; a.v[1] &= MASK51; a.v[2] += c;
  c = a.v[2] >> 51; a.v[2] &= MASK51; a.v[3] += c;
  c = a.v[3] >> 51; a.v[3] &= MASK51; a.v[4] += c;
  c = a.v[4] >> 51; a.v[4] &= MASK51; a.v[0] += 19 * c;
  return a;
}

NT_HD fe fe_add(const fe& a, const fe& b) {
  fe r;
  for (int i = 0; i < 5; ++i) r.v[i] = a.v[i] + b.v[i];
  return fe_carry(r);
}

// a - b as a + 4p - b: 4p = (2^53 - 76, 2^53 - 4, ..., 2^53 - 4).
NT_HD fe fe_sub(const fe& a, const fe& b) {
  fe r;
  r.v[0] = a.v[0] + ((uint64_t(1) << 53) - 76) - b.v[0];
  for (int i = 1; i < 5; ++i) r.v[i] = a.v[i] + ((uint64_t(1) << 53) - 4) - b.v[i];
  return fe_carry(r);
}

NT_HD fe fe_neg(const fe& a) { return fe_sub(fe_zero(), a); }

NT_HD fe fe_mul(const fe& a, const fe& b) {
  const uint64_t b1 = 19 * b.v[1], b2 = 19 * b.v[2], b3 = 19 * b.v[3],
                 b4 = 19 * b.v[4];
  acc128 t0 = {0, 0}, t1 = {0, 0}, t2 = {0, 0}, t3 = {0, 0}, t4 = {0, 0};
  mac(t0, a.v[0], b.v[0]); mac(t0, a.v[1], b4); mac(t0, a.v[2], b3);
  mac(t0, a.v[3], b2); mac(t0, a.v[4], b1);
  mac(t1, a.v[0], b.v[1]); mac(t1, a.v[1], b.v[0]); mac(t1, a.v[2], b4);
  mac(t1, a.v[3], b3); mac(t1, a.v[4], b2);
  mac(t2, a.v[0], b.v[2]); mac(t2, a.v[1], b.v[1]); mac(t2, a.v[2], b.v[0]);
  mac(t2, a.v[3], b4); mac(t2, a.v[4], b3);
  mac(t3, a.v[0], b.v[3]); mac(t3, a.v[1], b.v[2]); mac(t3, a.v[2], b.v[1]);
  mac(t3, a.v[3], b.v[0]); mac(t3, a.v[4], b4);
  mac(t4, a.v[0], b.v[4]); mac(t4, a.v[1], b.v[3]); mac(t4, a.v[2], b.v[2]);
  mac(t4, a.v[3], b.v[1]); mac(t4, a.v[4], b.v[0]);
  fe r;
  uint64_t c;
  r.v[0] = t0.lo & MASK51; c = shr51(t0);
  t1.lo += c; t1.hi += (t1.lo < c);
  r.v[1] = t1.lo & MASK51; c = shr51(t1);
  t2.lo += c; t2.hi += (t2.lo < c);
  r.v[2] = t2.lo & MASK51; c = shr51(t2);
  t3.lo += c; t3.hi += (t3.lo < c);
  r.v[3] = t3.lo & MASK51; c = shr51(t3);
  t4.lo += c; t4.hi += (t4.lo < c);
  r.v[4] = t4.lo & MASK51; c = shr51(t4);
  r.v[0] += 19 * c;
  c = r.v[0] >> 51; r.v[0] &= MASK51; r.v[1] += c;
  return r;
}

NT_HD fe fe_sq(const fe& a) { return fe_mul(a, a); }

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

// Full reduction into [0, p), limbs < 2^51.
NT_HD fe fe_canon(fe a) {
  a = fe_carry(fe_carry(a));  // value < 2^255 + 2^19 < 2p
  // q = 1 iff a >= p, i.e. iff a + 19 carries out of bit 255.
  uint64_t q = (a.v[0] + 19) >> 51;
  q = (a.v[1] + q) >> 51;
  q = (a.v[2] + q) >> 51;
  q = (a.v[3] + q) >> 51;
  q = (a.v[4] + q) >> 51;
  a.v[0] += 19 * q;
  uint64_t c;
  c = a.v[0] >> 51; a.v[0] &= MASK51; a.v[1] += c;
  c = a.v[1] >> 51; a.v[1] &= MASK51; a.v[2] += c;
  c = a.v[2] >> 51; a.v[2] &= MASK51; a.v[3] += c;
  c = a.v[3] >> 51; a.v[3] &= MASK51; a.v[4] += c;
  a.v[4] &= MASK51;  // drops the 2^255 that q accounted for
  return a;
}

NT_HD bool fe_is_zero(const fe& a) {
  const fe c = fe_canon(a);
  return (c.v[0] | c.v[1] | c.v[2] | c.v[3] | c.v[4]) == 0;
}

NT_HD bool fe_eq(const fe& a, const fe& b) {
  const fe x = fe_canon(a), y = fe_canon(b);
  return ((x.v[0] ^ y.v[0]) | (x.v[1] ^ y.v[1]) | (x.v[2] ^ y.v[2]) |
          (x.v[3] ^ y.v[3]) | (x.v[4] ^ y.v[4])) == 0;
}

NT_HD fe fe_select(bool c, const fe& a, const fe& b) { return c ? a : b; }

// 32 little-endian bytes held one per int32 (the host prep's 8-bit limbs;
// bit 255 already cleared) -> 5 limbs of 51 bits.  The value may be >= p.
NT_HD fe fe_from_limbs8(const int32_t* b) {
  uint64_t w[4];
  for (int k = 0; k < 4; ++k) {
    uint64_t x = 0;
    for (int j = 7; j >= 0; --j) x = (x << 8) | (uint64_t)(b[8 * k + j] & 0xff);
    w[k] = x;
  }
  fe r;
  r.v[0] = w[0] & MASK51;
  r.v[1] = ((w[0] >> 51) | (w[1] << 13)) & MASK51;
  r.v[2] = ((w[1] >> 38) | (w[2] << 26)) & MASK51;
  r.v[3] = ((w[2] >> 25) | (w[3] << 39)) & MASK51;
  r.v[4] = (w[3] >> 12) & MASK51;
  return r;
}

// ------------------------------------------------------------- point ops
// The same formulas as the JAX reference (narwhal_tpu/ops/ed25519.py).

NT_HD ge ge_identity() { return ge{fe_zero(), fe_one(), fe_one(), fe_zero()}; }

// Unified add (add-2008-hwcd-3, a = -1); d2 = 2d.
NT_HD ge ge_add(const ge& p, const ge& q, const fe& d2) {
  const fe a = fe_mul(fe_sub(p.Y, p.X), fe_sub(q.Y, q.X));
  const fe b = fe_mul(fe_add(p.Y, p.X), fe_add(q.Y, q.X));
  const fe c = fe_mul(fe_mul(p.T, d2), q.T);
  const fe d = fe_mul(fe_add(p.Z, p.Z), q.Z);
  const fe e = fe_sub(b, a), f = fe_sub(d, c), g = fe_add(d, c), h = fe_add(b, a);
  return ge{fe_mul(e, f), fe_mul(g, h), fe_mul(f, g), fe_mul(e, h)};
}

// dbl-2008-hwcd for a = -1.
NT_HD ge ge_double(const ge& p) {
  const fe a = fe_sq(p.X), b = fe_sq(p.Y), zz = fe_sq(p.Z);
  const fe c = fe_add(zz, zz);
  const fe h = fe_add(a, b);
  const fe e = fe_sub(h, fe_sq(fe_add(p.X, p.Y)));
  const fe g = fe_sub(a, b);
  const fe f = fe_add(c, g);
  return ge{fe_mul(e, f), fe_mul(g, h), fe_mul(f, g), fe_mul(e, h)};
}

NT_HD ge ge_neg(const ge& p) { return ge{fe_neg(p.X), p.Y, p.Z, fe_neg(p.T)}; }

// Projective equality: X1*Z2 == X2*Z1 and Y1*Z2 == Y2*Z1.
NT_HD bool ge_eq(const ge& p, const ge& q) {
  return fe_eq(fe_mul(p.X, q.Z), fe_mul(q.X, p.Z)) &&
         fe_eq(fe_mul(p.Y, q.Z), fe_mul(q.Y, p.Z));
}

NT_HD bool ge_is_identity(const ge& p) { return fe_is_zero(p.X) && fe_eq(p.Y, p.Z); }

// [8]P == identity (the 8-torsion subgroup).
NT_HD bool ge_is_small_order(const ge& p) {
  return ge_is_identity(ge_double(ge_double(ge_double(p))));
}

// Compressed y (+ sign bit) -> extended point; *valid is false for a
// non-canonical y (decided by the host), a y with no x on the curve, and
// the x = 0 / sign = 1 encoding (RFC 8032 section 5.1.3).
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
  const bool x_is_zero = (xc.v[0] | xc.v[1] | xc.v[2] | xc.v[3] | xc.v[4]) == 0;
  const bool sign_ok = !(x_is_zero && sign == 1);
  const bool flip = (int)(xc.v[0] & 1) != sign;
  x = fe_select(flip, fe_neg(xc), xc);
  *valid = (ok_direct || ok_twist) && sign_ok && y_canonical;
  return ge{x, y, fe_one(), fe_mul(x, y)};
}

// One signature, every check of the JAX _verify_kernel: decompress A and R,
// reject small-order A or R, build j*(-A), run the 64-window MSB-first
// Straus ladder [S]B + [k](-A), compare with R projectively.
NT_HD bool verify_one(const Ed25519Consts& k, const int32_t* a_y, int a_sign,
                      bool a_canon, const int32_t* r_y, int r_sign,
                      bool r_canon, const int32_t* s_windows, bool s_ok,
                      const int32_t* k_windows) {
  bool a_valid, r_valid;
  const ge A = ge_decompress(fe_from_limbs8(a_y), a_sign, a_canon, k.d,
                             k.sqrt_m1, &a_valid);
  const ge R = ge_decompress(fe_from_limbs8(r_y), r_sign, r_canon, k.d,
                             k.sqrt_m1, &r_valid);
  const bool small = ge_is_small_order(A) || ge_is_small_order(R);

  const ge neg_a = ge_neg(A);
  ge table[16];  // j * (-A), in local memory
  table[0] = ge_identity();
  for (int j = 1; j < 16; ++j) table[j] = ge_add(table[j - 1], neg_a, k.d2);

  ge acc = ge_identity();
  for (int step = 0; step < 64; ++step) {
    acc = ge_double(ge_double(ge_double(ge_double(acc))));
    acc = ge_add(acc, k.base[s_windows[step] & 15], k.d2);
    acc = ge_add(acc, table[k_windows[step] & 15], k.d2);
  }
  return a_valid && r_valid && !small && s_ok && ge_eq(acc, R);
}

}  // namespace nt

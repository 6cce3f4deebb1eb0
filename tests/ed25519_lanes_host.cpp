// Host harness for the verifier's four-lane arithmetic
// (narwhal_tpu_torch/csrc/field25519.cuh): the same point formulas the
// CUDA kernel runs, with the four lanes of a group stepped in lockstep by
// nt::HostLanes.  Built with g++ into a shared library by
// tests/test_torch_ed25519_lanes.py and called through ctypes.
//
// A field element crosses the interface as its 10 uint32 limbs, a point
// as 40 words: X, Y, Z, T (extended) or the four cached coordinates.

#include <cstdint>
#include <cstring>

#include "field25519.cuh"

long nt::fe_mul_count = 0;
long nt::fe_sq_count = 0;

namespace {

nt::Ed25519Consts g_consts;

nt::fe4 load(const uint32_t* w) {
  nt::fe4 r;
  std::memcpy(&r, w, sizeof(r));
  return r;
}

void store(const nt::fe4& p, uint32_t* w) { std::memcpy(w, &p, sizeof(p)); }

// A lane's j*P table entries on the host: [entry][lane].
struct HostTable {
  nt::fe (*e)[4];
  nt::fe get(int j, int lane) const { return e[j][lane]; }
  void put(int j, int lane, const nt::fe& v) const { e[j][lane] = v; }
};

const nt::HostLanes g;

}  // namespace

extern "C" {

void h_set_consts(const uint32_t* words) {
  std::memcpy(&g_consts, words, sizeof(g_consts));
}

long h_fe_mul_count() { return nt::fe_mul_count; }

long h_fe_sq_count() { return nt::fe_sq_count; }

// One field op on weak inputs: 0 mul, 1 square, 2 add, 3 sub, 4 canon,
// 5 pow_p58, 6 equality (out[0] = 1 or 0), 7 the limbs of 32 bytes held
// one per int32 in a's words.
void h_field(int op, const uint32_t* a, const uint32_t* b, uint32_t* out) {
  nt::fe x, y, r = nt::fe_zero();
  std::memcpy(&x, a, sizeof(x));
  std::memcpy(&y, b, sizeof(y));
  switch (op) {
    case 0: r = nt::fe_mul(x, y); break;
    case 1: r = nt::fe_sq(x); break;
    case 2: r = nt::fe_add(x, y); break;
    case 3: r = nt::fe_sub(x, y); break;
    case 4: r = nt::fe_canon(x); break;
    case 5: r = nt::fe_pow_p58(x); break;
    case 6: r.v[0] = nt::fe_eq(x, y); break;
    case 7: r = nt::fe_from_limbs8(reinterpret_cast<const int32_t*>(a)); break;
  }
  std::memcpy(out, &r, sizeof(r));
}

void h_cached(const uint32_t* p, uint32_t* out) {
  store(nt::lanes_cached(g, load(p), g_consts.d2), out);
}

// p + q for two extended points (q is first put in cached form).
void h_add(const uint32_t* p, const uint32_t* q, uint32_t* out) {
  const nt::fe4 qc = nt::lanes_cached(g, load(q), g_consts.d2);
  store(nt::lanes_add(g, load(p), qc), out);
}

void h_double(const uint32_t* p, uint32_t* out) {
  store(nt::lanes_double(g, load(p)), out);
}

int h_is_small_order(const uint32_t* p) {
  return nt::lanes_is_small_order(g, load(p));
}

// j*p for j = 0..8 in cached form, then the entry each signed digit in
// [-8, 8] looks up: out holds 9 + 17 points.
void h_table(const uint32_t* p, uint32_t* out) {
  nt::fe e[nt::LANE_TABLE_ENTRIES][4];
  const HostTable tab{e};
  nt::lanes_build_table(g, tab, load(p), g_consts.d2);
  std::memcpy(out, e, sizeof(e));
  for (int d = -8; d <= 8; ++d)
    store(nt::lanes_lookup(g, tab, d), out + 40 * (nt::LANE_TABLE_ENTRIES + d + 8));
}

// The whole verify over B rows of the host prep's nine arrays, as the
// kernel runs it: lanes 0-1 decompress A, lanes 2-3 R.
void h_verify(const int32_t* a_y, const int32_t* a_sign, const uint8_t* a_canon,
              const int32_t* r_y, const int32_t* r_sign, const uint8_t* r_canon,
              const int32_t* s_windows, const uint8_t* s_ok,
              const int32_t* k_windows, uint8_t* out, int B) {
  for (int64_t i = 0; i < B; ++i) {
    nt::fe4 x, y, t;
    nt::b4 valid;
    for (int q = 0; q < 4; ++q) {
      const bool is_r = q >= 2;
      bool v;
      const nt::ge p = nt::ge_decompress(
          nt::fe_from_limbs8((is_r ? r_y : a_y) + i * 32),
          (is_r ? r_sign : a_sign)[i], (is_r ? r_canon : a_canon)[i] != 0,
          g_consts.d, g_consts.sqrt_m1, &v);
      x.l[q] = p.X;
      y.l[q] = p.Y;
      t.l[q] = p.T;
      valid.l[q] = v;
    }
    nt::fe e[nt::LANE_TABLE_ENTRIES][4];
    out[i] = nt::lanes_verify(g, HostTable{e}, nt::BaseTable{g_consts.base},
                              g_consts.d2, x, y, t, valid, s_ok[i] != 0,
                              s_windows + i * 64, k_windows + i * 64);
  }
}

}  // extern "C"

"""The CUDA verifier's four-lane arithmetic (csrc/field25519.cuh) on the
CPU: a host build of the same point formulas, the four lanes of a group
stepped in lockstep (tests/ed25519_lanes_host.cpp, built with g++ once per
module), held against Python big ints, the plain PyTorch verifier and the
pure-Python verifier.

Every comparison is exact (tolerance 0): coordinates are compared as
canonical field elements, masks as bools."""

import ctypes
import os
import random
import shutil
import subprocess

import numpy as np
import pytest

from narwhal_tpu_torch.crypto import _ed25519_py as py
from narwhal_tpu_torch.ops import ed25519 as TE

from test_torch_ed25519 import EXPECTED, hostile_vectors

P = TE.P
D = TE.D_INT
HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(HERE), "narwhal_tpu_torch", "csrc")
_VP = ctypes.c_void_p


@pytest.fixture(scope="module")
def lanes(tmp_path_factory):
    """The host harness as a ctypes library, its constants loaded from
    ``cuda_consts()`` (the words the card gets)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host harness cannot be built")
    so = str(tmp_path_factory.mktemp("lanes") / "lanes.so")
    subprocess.run(
        [gxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-DNT_COUNT_FE_MULS",
         "-I", CSRC, os.path.join(HERE, "ed25519_lanes_host.cpp"), "-o", so],
        check=True, capture_output=True, timeout=300,
    )
    lib = ctypes.CDLL(so)
    lib.h_fe_mul_count.restype = ctypes.c_long
    lib.h_fe_sq_count.restype = ctypes.c_long
    lib.h_is_small_order.restype = ctypes.c_int
    lib.h_verify.argtypes = [_VP] * 10 + [ctypes.c_int]
    consts = TE.cuda_consts()
    lib.h_set_consts(consts.ctypes.data_as(_VP))
    return lib


# ------------------------------------------------------------- points


_OFFSETS = np.cumsum((0,) + TE.KERNEL_LIMB_BITS[:-1]).tolist()


def _words(coords) -> np.ndarray:
    return np.array([w for c in coords for w in TE.kernel_limbs(c % P)], np.uint32)


def _value(limbs) -> int:
    """The integer a (possibly unreduced) limb vector holds."""
    return sum(int(v) << off for v, off in zip(limbs, _OFFSETS))


def _ints(words: np.ndarray):
    return tuple(_value(words[10 * k: 10 * k + 10]) % P
                 for k in range(len(words) // 10))


def _call(fn, *points, n_out=1):
    out = np.zeros(40 * n_out, np.uint32)
    args = [_words(p) for p in points]
    fn(*[a.ctypes.data_as(_VP) for a in args], out.ctypes.data_as(_VP))
    return _ints(out)


def _affine(p):
    x, y, z, _ = p
    zi = pow(z, P - 2, P)
    return (x * zi % P, y * zi % P)


def _random_points(seed: int, n: int):
    """n extended points k·B with random projective scale Z."""
    rng = random.Random(seed)
    pts = []
    for _ in range(n):
        x, y = TE._ref_scalarmult(rng.randrange(1, TE.L_ORDER))
        z = rng.randrange(1, P)
        pts.append((x * z % P, y * z % P, z, x * y * z % P))
    return pts


def _double_ints(p):
    """dbl-2008-hwcd (a = -1), the formula the lanes run."""
    x, y, z, _ = p
    a, b = x * x % P, y * y % P
    h, g = (a + b) % P, (a - b) % P
    e = (h - (x + y) ** 2) % P
    f = (2 * z * z + g) % P
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def _cached_ints(p):
    x, y, z, t = p
    return ((y - x) % P, (y + x) % P, 2 * D * t % P, 2 * z % P)


def _cached_affine(c):
    """A cached (Y-X, Y+X, 2dT, 2Z) → affine (x, y), checking that 2dT
    agrees with d·x·y."""
    ymx, ypx, t2d, z2 = c
    zi = pow(z2, P - 2, P)  # 1 / 2Z
    x, y = (ypx - ymx) * zi % P, (ypx + ymx) * zi % P
    assert t2d * zi % P == D * x * y % P
    return (x, y)


_IDENTITY = (0, 1, 1, 0)


# ------------------------------------------------------------- the field

# Weak limbs, the most any field op may be given: even limbs < 2^27, odd
# limbs < 2^26 (csrc/field25519.cuh).
_WEAK_MAX = [(1 << (w + 1)) - 1 for w in TE.KERNEL_LIMB_BITS]


def _field_inputs(seed: int):
    """Limb vectors: edge values (0, 1, p - 1, p, p + 1, 2^255 - 1), every
    limb at its weak maximum, and random weak limbs and values."""
    rng = np.random.default_rng(seed)
    vals = [TE.kernel_limbs(x) for x in (0, 1, P - 1, P, P + 1, (1 << 255) - 1, 19)]
    vals.append(_WEAK_MAX)
    vals += [[int(rng.integers(0, m + 1)) for m in _WEAK_MAX] for _ in range(12)]
    vals += [TE.kernel_limbs(int.from_bytes(rng.bytes(32), "little") >> 1)
             for _ in range(12)]
    return [np.array(v, np.uint32) for v in vals]


def _field(lanes, op, a, b=None):
    out = np.zeros(10, np.uint32)
    b = a if b is None else b
    lanes.h_field(op, a.ctypes.data_as(_VP), b.ctypes.data_as(_VP),
                  out.ctypes.data_as(_VP))
    return out


@pytest.mark.parametrize("op", ["mul", "square", "add", "sub"])
def test_field_ops_on_weak_limbs(lanes, op):
    """Every product, square, sum and difference of weak inputs is right
    mod p and comes back weak, so it may feed any op."""
    code = {"mul": 0, "square": 1, "add": 2, "sub": 3}[op]
    want = {"mul": lambda x, y: x * y, "square": lambda x, y: x * x,
            "add": lambda x, y: x + y, "sub": lambda x, y: x - y}[op]
    xs = _field_inputs(13)
    for a, b in zip(xs, xs[::-1] + xs[:1]):
        got = _field(lanes, code, a, b)
        assert all(int(v) <= m for v, m in zip(got, _WEAK_MAX)), got
        assert _value(got) % P == want(_value(a), _value(b)) % P


def test_field_canon_eq_pow_and_bytes(lanes):
    xs = _field_inputs(14)
    for a in xs:
        x = _value(a) % P
        got = _field(lanes, 4, a)
        assert _value(got) == x and got.tolist() == TE.kernel_limbs(x)
        assert _value(_field(lanes, 5, a)) % P == pow(x, (P - 5) // 8, P)
        assert _field(lanes, 6, a, np.array(TE.kernel_limbs(x), np.uint32))[0] == 1
        assert _field(lanes, 6, a, np.array(TE.kernel_limbs((x + 1) % P), np.uint32))[0] == 0
    rng = np.random.default_rng(15)
    for _ in range(8):
        raw = rng.integers(0, 256, 32).astype(np.int32)
        raw[31] &= 0x7F
        limbs = np.zeros(40, np.uint32)
        limbs[:32] = raw
        got = _field(lanes, 7, limbs)
        assert got.tolist() == TE.kernel_limbs(int.from_bytes(bytes(raw.astype(np.uint8)), "little"))


@pytest.mark.parametrize("case", ["random", "same", "inverse", "identity"])
def test_four_lane_add_equals_the_formula_on_big_ints(lanes, case):
    ps = _random_points(1, 6)
    qs = _random_points(2, 6)
    if case == "same":
        qs = ps
    elif case == "inverse":
        qs = [((-x) % P, y, z, (-t) % P) for x, y, z, t in ps]
    elif case == "identity":
        qs = [_IDENTITY] * len(ps)
    for p, q in zip(ps, qs):
        # add-2008-hwcd-3, as the pure-Python signer computes it.
        assert _call(lanes.h_add, p, q) == tuple(c % P for c in py._point_add(p, q))


def test_four_lane_double_equals_the_formula_on_big_ints(lanes):
    for p in _random_points(3, 8) + [_IDENTITY]:
        got = _call(lanes.h_double, p)
        assert got == _double_ints(p)
        assert _affine(got) == _affine(py._point_add(p, p))


def test_cached_form(lanes):
    for p in _random_points(4, 8) + [_IDENTITY]:
        assert _call(lanes.h_cached, p) == _cached_ints(p)
    # The base table the card gets: entry j, lane q at words [j][q].
    base = _ints(TE.cuda_consts()[30:])
    for j in range(16):
        assert _cached_affine(base[4 * j: 4 * j + 4]) == TE._ref_scalarmult(j)


def test_table_and_signed_lookup(lanes):
    """j·P for j = 0..8 in cached form, and the entry for every signed
    digit in [-8, 8] (a negative digit reads -|d|·P)."""
    for p in _random_points(6, 3) + [_IDENTITY]:
        out = _call(lanes.h_table, p, n_out=9 + 17)
        base = _affine(p)
        ext = (base[0], base[1], 1, base[0] * base[1] % P)
        for j in range(9):
            want = _affine(py._point_mul(j, ext)) if j else (0, 1)
            assert _cached_affine(out[4 * j: 4 * j + 4]) == want, j
        for i, d in enumerate(range(-8, 9)):
            got = _cached_affine(out[4 * (9 + i): 4 * (9 + i) + 4])
            x, y = _affine(py._point_mul(abs(d), ext)) if d else (0, 1)
            assert got == ((-x) % P if d < 0 else x, y), d


def _is_small_order(lanes, p) -> bool:
    return lanes.h_is_small_order(_words(p).ctypes.data_as(_VP)) == 1


def test_small_order_check(lanes):
    """[8]P == identity for the 8-torsion (the cofactor-cleared [L]Q of
    curve points Q off the prime subgroup), not for points of order L."""
    rng = random.Random(8)
    torsion = {(0, 1)}
    while len(torsion) < 8:
        y = rng.randrange(P)
        q = py._point_decompress((y | (rng.getrandbits(1) << 255)).to_bytes(32, "little"))
        if q is None:
            continue
        t = py._point_mul(TE.L_ORDER, q)
        torsion.add(_affine(t))
        z = rng.randrange(1, P)
        assert _is_small_order(lanes, tuple(c * z for c in t))
    for x, y in torsion:
        assert _is_small_order(lanes, (x, y, 1, x * y))
    for p in _random_points(9, 8):
        assert not _is_small_order(lanes, p)


def _honest_and_corrupted(seed: int, n: int):
    """n honest signatures from a seed, then one bit-flip corruption of
    each (in the message, the key or the signature)."""
    rng = random.Random(seed)
    honest, corrupted = [], []
    for _ in range(n):
        sk = rng.randbytes(32)
        m = rng.randbytes(rng.randrange(1, 80))
        honest.append((m, py.secret_to_public(sk), py.sign(sk, m)))
    for m, k, s in honest:
        part = rng.randrange(3)
        b = bytearray((m, k, s)[part])
        bit = rng.randrange(8 * len(b))
        b[bit // 8] ^= 1 << (bit % 8)
        row = [m, k, s]
        row[part] = bytes(b)
        corrupted.append(tuple(row))
    return honest, corrupted


def _verify_lanes(lanes, rows, pad):
    arrays = TE.prepare_batch(*zip(*rows), pad)
    arrays = [np.ascontiguousarray(a.astype(np.uint8) if a.dtype == bool else a)
              for a in arrays]
    out = np.zeros(pad, np.uint8)
    lanes.h_verify(*[a.ctypes.data_as(_VP) for a in arrays],
                   out.ctypes.data_as(_VP), pad)
    return out.astype(bool)


def _verify_plain(rows, pad):
    arrays = TE.to_device(TE.prepare_batch(*zip(*rows), pad), "cpu")
    return TE.verify_plain(*arrays).numpy()


def test_verify_on_hostile_vectors(lanes):
    """S ≥ L, non-canonical y, small-order points, corrupted key,
    signature or message: the expected verdicts, as the plain verifier
    gives them, padding rows included."""
    rows = hostile_vectors()
    got = _verify_lanes(lanes, rows, 32)
    assert got.tolist() == _verify_plain(rows, 32).tolist()
    assert got[:16].tolist() == EXPECTED
    assert not got[16:].any()


@pytest.mark.parametrize("seed", [11, 12])
def test_verify_on_honest_and_corrupted_signatures(lanes, seed):
    honest, corrupted = _honest_and_corrupted(seed, 12)
    rows = honest + corrupted
    got = _verify_lanes(lanes, rows, len(rows))
    assert got.tolist() == _verify_plain(rows, len(rows)).tolist()
    assert got.tolist() == [py.verify(k, m, s) for m, k, s in rows]
    assert got[:12].all() and not got[12:].any()


def test_kernel_multiply_count_is_what_the_lanes_run(lanes):
    """The kernel's multiplies, counted, not guessed: every lane's
    multiplies and squares in one verify, decompressions included.
    4,312 = 4 lanes × 1,078 rounds (PERF.md); 2,068 of them squares."""
    rows = hostile_vectors()[:4]
    muls, sqs = lanes.h_fe_mul_count(), lanes.h_fe_sq_count()
    _verify_lanes(lanes, rows, 4)
    muls = (lanes.h_fe_mul_count() - muls) / 4
    sqs = (lanes.h_fe_sq_count() - sqs) / 4
    # A round is one multiply in each of four lanes: a decompression in
    # every lane, two small-order checks (3 doublings of 2 rounds), the
    # cached -A table (a conversion, then 7 adds of 2 rounds and a
    # conversion each), the ladder (64 × (4 doublings + 2 adds) of 2
    # rounds) and the final compare.
    rounds = 275 + 2 * 3 * 2 + (1 + 7 * 3) + 64 * (4 + 2) * 2 + 1
    assert muls + sqs == 4 * rounds == 4312
    # Squares: 255 a decompression, one a lane in a doubling's first round.
    assert sqs == 4 * 255 + 4 * (2 * 3 + 64 * 4) == 2068


def test_prepare_batch_keeps_k_below_the_group_order():
    """The kernel's signed recoding needs k < L (its top window at most
    1): the host prep reduces every k, honest, corrupted, hostile or
    random bytes."""
    honest, corrupted = _honest_and_corrupted(13, 8)
    rng = np.random.default_rng(13)
    noise = [(rng.bytes(40), rng.bytes(32), rng.bytes(64)) for _ in range(32)]
    rows = honest + corrupted + hostile_vectors() + noise
    k_windows = TE.prepare_batch(*zip(*rows), len(rows))[8]
    assert k_windows.shape == (len(rows), 64)
    assert (k_windows[:, 0] <= 1).all()
    for w in k_windows:
        k = sum(int(v) << (4 * (63 - i)) for i, v in enumerate(w))
        assert k < TE.L_ORDER

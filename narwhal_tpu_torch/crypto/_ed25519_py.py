"""Pure-Python ed25519 (RFC 8032) — the dependency-free fallback signer.

`crypto/keys.py` rides OpenSSL via the `cryptography` package when it is
installed; hosts without it (minimal installs) fall back here so the
protocol stack, tests, and benches still run.  This is the textbook
RFC 8032 construction over Python ints: correct and compact, not fast
(~1 ms per scalar multiplication).  Production verification throughput
comes from the batched CUDA kernel (`narwhal_tpu_torch.ops.ed25519`) either way;
this module only has to keep single-signature sign/verify available.

Semantics match `cpu_verify`'s OpenSSL behavior for well-formed inputs:
cofactorless verification, s < L enforced (RFC 8032 §5.1.7), invalid
point encodings rejected.
"""

from __future__ import annotations

import hashlib

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
D = -121665 * pow(121666, P - 2, P) % P
_SQRT_M1 = pow(2, (P - 1) // 4, P)


def _sha512(s: bytes) -> bytes:
    return hashlib.sha512(s).digest()


def _sha512_mod_l(s: bytes) -> int:
    return int.from_bytes(_sha512(s), "little") % L


# Points are extended homogeneous coordinates (X, Y, Z, T), x = X/Z,
# y = Y/Z, x*y = T/Z.
def _point_add(p, q):
    px, py, pz, pt = p
    qx, qy, qz, qt = q
    a = (py - px) * (qy - qx) % P
    b = (py + px) * (qy + qx) % P
    c = 2 * pt * qt * D % P
    d = 2 * pz * qz % P
    e = b - a
    f = d - c
    g = d + c
    h = b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


_NEUTRAL = (0, 1, 1, 0)


def _point_mul(s: int, p):
    """Arbitrary-point scalar multiply, 4-bit fixed window: 14 precompute
    adds + 4 doublings/digit + ~1 add/digit ≈ 330 point ops vs ~384 for
    double-and-add."""
    if s <= 0:
        return _NEUTRAL
    row = [None] * 16
    row[1] = p
    for j in range(2, 16):
        row[j] = _point_add(row[j - 1], p)
    digits = []
    while s > 0:
        digits.append(s & 15)
        s >>= 4
    q = _NEUTRAL
    for d in reversed(digits):
        q = _point_add(q, q)
        q = _point_add(q, q)
        q = _point_add(q, q)
        q = _point_add(q, q)
        if d:
            q = _point_add(q, row[d])
    return q


# Fixed-base comb for the generator: _G_TABLE[i][j] = (j·16^i)·G, so a
# base multiplication is ≤ 64 additions and no doublings.  Built lazily —
# importers that never sign/verify don't pay the ~1000 point adds.
_G_TABLE = None


def _base_table():
    global _G_TABLE
    if _G_TABLE is None:
        tbl = []
        base = _G
        for _ in range(64):
            row = [None] * 16
            p = base
            for j in range(1, 16):
                row[j] = p
                p = _point_add(p, base)
            tbl.append(row)
            base = p  # 16·previous base
        _G_TABLE = tbl
    return _G_TABLE


def _point_mul_base(s: int):
    """s·G via the comb table."""
    tbl = _base_table()
    q = _NEUTRAL
    i = 0
    while s > 0:
        d = s & 15
        if d:
            q = _point_add(q, tbl[i][d])
        s >>= 4
        i += 1
    return q


def multi_scalar_mul(pairs):
    """Σ sᵢ·Pᵢ via Straus interleaved 4-bit windows: one shared doubling
    chain (≤ 256 doublings total) plus 14 precompute adds and ≤ 64
    digit adds PER POINT — ~74·n + 256 point ops for n terms, vs the
    ~400·n of independent `_point_mul` calls.  This is what makes the
    half-aggregated certificate check (one equation over 2·q+1 points)
    cheaper than q serial verifies even on the pure-Python fallback.

    ``pairs`` is a sequence of ``(scalar, point)`` with points in
    extended coordinates; scalars are taken mod nothing (callers reduce
    mod L), non-positive scalars contribute the neutral element."""
    live = [(s, p) for s, p in pairs if s > 0]
    if not live:
        return _NEUTRAL
    tables = []
    max_bits = 0
    for s, p in live:
        row = [None] * 16
        row[1] = p
        for j in range(2, 16):
            row[j] = _point_add(row[j - 1], p)
        tables.append(row)
        if s.bit_length() > max_bits:
            max_bits = s.bit_length()
    q = _NEUTRAL
    for i in range((max_bits + 3) // 4 - 1, -1, -1):
        q = _point_add(q, q)
        q = _point_add(q, q)
        q = _point_add(q, q)
        q = _point_add(q, q)
        shift = 4 * i
        for (s, _), row in zip(live, tables):
            d = (s >> shift) & 15
            if d:
                q = _point_add(q, row[d])
    return q


def _point_equal(p, q) -> bool:
    # x1/z1 == x2/z2  and  y1/z1 == y2/z2, avoiding inversions.
    return (
        (p[0] * q[2] - q[0] * p[2]) % P == 0
        and (p[1] * q[2] - q[1] * p[2]) % P == 0
    )


def _recover_x(y: int, sign: int):
    if y >= P:
        return None
    x2 = (y * y - 1) * pow(D * y * y + 1, P - 2, P) % P
    if x2 == 0:
        return None if sign else 0
    x = pow(x2, (P + 3) // 8, P)
    if (x * x - x2) % P != 0:
        x = x * _SQRT_M1 % P
    if (x * x - x2) % P != 0:
        return None
    if (x & 1) != sign:
        x = P - x
    return x


_G_Y = 4 * pow(5, P - 2, P) % P
_G_X = _recover_x(_G_Y, 0)
_G = (_G_X, _G_Y, 1, _G_X * _G_Y % P)


def _point_compress(p) -> bytes:
    zinv = pow(p[2], P - 2, P)
    x = p[0] * zinv % P
    y = p[1] * zinv % P
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def _point_decompress(s: bytes):
    if len(s) != 32:
        return None
    y = int.from_bytes(s, "little")
    sign = y >> 255
    y &= (1 << 255) - 1
    x = _recover_x(y, sign)
    if x is None:
        return None
    return (x, y, 1, x * y % P)


def _secret_expand(secret: bytes):
    h = _sha512(secret)
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a, h[32:]


def secret_to_public(secret: bytes) -> bytes:
    a, _ = _secret_expand(secret)
    return _point_compress(_point_mul_base(a))


def sign(secret: bytes, msg: bytes) -> bytes:
    a, prefix = _secret_expand(secret)
    pub = _point_compress(_point_mul_base(a))
    return sign_expanded(a, prefix, pub, msg)


def sign_expanded(a: int, prefix: bytes, pub: bytes, msg: bytes) -> bytes:
    """Sign with a pre-expanded secret (`KeyPair` caches the expansion so
    repeated signing pays one base multiplication, not two)."""
    r = _sha512_mod_l(prefix + msg)
    r_enc = _point_compress(_point_mul_base(r))
    h = _sha512_mod_l(r_enc + pub + msg)
    s = (r + h * a) % L
    return r_enc + s.to_bytes(32, "little")


def verify(public: bytes, msg: bytes, signature: bytes) -> bool:
    if len(public) != 32 or len(signature) != 64:
        return False
    a = _point_decompress(public)
    if a is None:
        return False
    r_enc = signature[:32]
    r = _point_decompress(r_enc)
    if r is None:
        return False
    s = int.from_bytes(signature[32:], "little")
    if s >= L:
        return False
    h = _sha512_mod_l(r_enc + bytes(public) + msg)
    return _point_equal(_point_mul_base(s), _point_add(r, _point_mul(h, a)))

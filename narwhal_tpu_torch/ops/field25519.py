"""GF(2^255 - 19) in plain PyTorch: the plain twin's field arithmetic.

The algorithm of the JAX reference (``narwhal_tpu/ops/field25519.py``,
int32 lane mode) step for step: a field element is ``[..., 32]`` int32
limbs of 8 bits (limb i holds bits [8i, 8i+8)), batch-first, with the same
magnitude bounds — weak limbs < 2^9, pairwise products < 2^18, a 32-term
convolution row < 2^23, every intermediate inside int32.  Outputs of
mul/add/sub are *weakly reduced* (limbs < 2^9, value possibly ≥ p);
``canon`` fully reduces into [0, p) with limbs < 2^8.

This module is the plain version only.  The CUDA verifier
(csrc/field25519.cuh) uses 5 limbs of 51 bits, the layout natural to a
card with a 64-bit multiply; both are held to the same canonical values
by the tests.  Every op runs on whatever device its inputs live on.
"""

from __future__ import annotations

import numpy as np
import torch

BITS = 8
LIMBS = 32
MASK = (1 << BITS) - 1
P = (1 << 255) - 19

# 2^(BITS·LIMBS) = 2^256 ≡ 38 (mod p): folding multiplier for limbs ≥ LIMBS.
FOLD = 38
DTYPE = torch.int32
NP_DTYPE = np.int32


def to_limbs(x: int) -> np.ndarray:
    """Python int → limb vector (host-side prep)."""
    return np.array([(x >> (BITS * i)) & MASK for i in range(LIMBS)],
                    dtype=NP_DTYPE)


def from_limbs(limbs) -> int:
    """Limb vector → Python int (host-side check); accepts unreduced."""
    arr = np.asarray(limbs, dtype=np.int64)
    return sum(int(v) << (BITS * i) for i, v in enumerate(arr))


# Constant limb vectors, made once per device (one host→device copy each).
_const_cache: dict = {}


def _cached(key, make, device) -> torch.Tensor:
    t = _const_cache.get((key, device))
    if t is None:
        t = _const_cache[(key, device)] = torch.from_numpy(make()).to(device)
    return t


def const(x: int, like: torch.Tensor) -> torch.Tensor:
    """The constant ``x`` as a limb vector on ``like``'s device."""
    return _cached(x, lambda: to_limbs(x), like.device)


def _carry_once(c: torch.Tensor) -> torch.Tensor:
    """One carry sweep; the carry out of the top limb wraps to limb 0
    multiplied by 38 (2^256 ≡ 38 mod p)."""
    hi = c >> BITS
    lo = c & MASK
    return lo + torch.cat([hi[..., -1:] * FOLD, hi[..., :-1]], dim=-1)


def carry(c: torch.Tensor, sweeps: int = 4) -> torch.Tensor:
    """Propagate carries until every limb is weakly reduced (< 2^9); with
    4 sweeps input limbs may be up to 2^31 (the reference's bound proof)."""
    for _ in range(sweeps):
        c = _carry_once(c)
    return c


# conv[k] = Σ_{i+j=k} a_i·b_j as one index_add over the 32×32 outer product.
_CONV_INDEX = (np.arange(LIMBS)[:, None] + np.arange(LIMBS)[None, :]).reshape(-1)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Field multiply, weakly reduced output.  Weak limbs < 2^9 give
    pairwise products < 2^18 and convolution rows < 2^23; the ×38 fold of
    the high half stays < 2^29 — all inside int32."""
    a, b = torch.broadcast_tensors(a, b)
    outer = (a[..., :, None] * b[..., None, :]).reshape(*a.shape[:-1], LIMBS * LIMBS)
    conv = torch.zeros(*a.shape[:-1], 2 * LIMBS - 1, dtype=DTYPE, device=a.device)
    conv.index_add_(-1, _cached("conv", lambda: _CONV_INDEX, a.device), outer)
    lo = conv[..., :LIMBS]
    hi = conv[..., LIMBS:]  # 31 limbs: 2^(8(32+j)) ≡ 38·2^(8j)
    folded = lo + torch.nn.functional.pad(hi * FOLD, (0, 1))
    return carry(folded)


def square(a: torch.Tensor) -> torch.Tensor:
    return mul(a, a)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b (mod p), weakly reduced; one sweep suffices (sum < 2^10)."""
    return carry(a + b, sweeps=1)


# Borrow-free subtraction offset: a limb vector ≡ 0 (mod p) with every
# limb ≥ 2^9 (the reference's construction and bound checks).
_base = sum(2 * MASK << (BITS * i) for i in range(LIMBS))
_comp = (-_base) % P
_zp_limbs = [2 * MASK + ((_comp >> (BITS * i)) & MASK) for i in range(LIMBS)]
assert sum(v << (BITS * i) for i, v in enumerate(_zp_limbs)) % P == 0
assert all((1 << 9) <= v < (1 << 15) for v in _zp_limbs), _zp_limbs
_ZP = np.array(_zp_limbs, dtype=NP_DTYPE)


def _zp(like: torch.Tensor) -> torch.Tensor:
    return _cached("zp", lambda: _ZP, like.device)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b (mod p) via the ZP offset; two sweeps (the reference's bound)."""
    return carry(a + _zp(a) - b, sweeps=2)


def neg(a: torch.Tensor) -> torch.Tensor:
    return carry(_zp(a) - a, sweeps=2)


def pow2k(a: torch.Tensor, k: int) -> torch.Tensor:
    for _ in range(k):
        a = square(a)
    return a


def _pow_2_250_1(a: torch.Tensor) -> torch.Tensor:
    x2 = mul(square(a), a)            # 2^2 - 1
    x4 = mul(pow2k(x2, 2), x2)        # 2^4 - 1
    x5 = mul(square(x4), a)           # 2^5 - 1
    x10 = mul(pow2k(x5, 5), x5)       # 2^10 - 1
    x20 = mul(pow2k(x10, 10), x10)    # 2^20 - 1
    x40 = mul(pow2k(x20, 20), x20)    # 2^40 - 1
    x50 = mul(pow2k(x40, 10), x10)    # 2^50 - 1
    x100 = mul(pow2k(x50, 50), x50)   # 2^100 - 1
    x200 = mul(pow2k(x100, 100), x100)  # 2^200 - 1
    return mul(pow2k(x200, 50), x50)  # 2^250 - 1


def invert(a: torch.Tensor) -> torch.Tensor:
    """a^(p-2): p - 2 = (2^250-1)·2^5 + 11."""
    t = pow2k(_pow_2_250_1(a), 5)
    return mul(t, mul(mul(square(square(square(a))), square(a)), a))


def pow_p58(a: torch.Tensor) -> torch.Tensor:
    """a^((p-5)/8) = (a^(2^250-1))^4 · a."""
    return mul(pow2k(_pow_2_250_1(a), 2), a)


def _sub_p(c: torch.Tensor):
    """(c - p) with full borrow propagation → (limbs, underflow)."""
    d = c - const(P, c)
    borrow = torch.zeros(c.shape[:-1], dtype=DTYPE, device=c.device)
    out = []
    for i in range(LIMBS):
        v = d[..., i] - borrow
        neg_ = v < 0
        out.append(torch.where(neg_, v + (1 << BITS), v))
        borrow = neg_.to(DTYPE)
    return torch.stack(out, dim=-1), borrow > 0


def canon(a: torch.Tensor) -> torch.Tensor:
    """Fully reduce into [0, p) with strictly canonical limbs (< 2^8)."""
    c = carry(a)
    for _ in range(LIMBS + 2):
        c = _carry_once(c)
    for _ in range(3):
        d, under = _sub_p(c)
        c = torch.where(under[..., None], c, d)
    return c


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return (canon(a) == 0).all(dim=-1)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (canon(a) == canon(b)).all(dim=-1)


def select(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """cond ? a : b, with cond shaped [...] and a/b [..., LIMBS]."""
    return torch.where(cond[..., None], a, b)

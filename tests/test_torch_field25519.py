"""The port's plain field arithmetic (ops/field25519.py, torch on the CPU)
against the JAX field ops and against Python big ints.

Both sides run eagerly on the same seeded values; every comparison is on
canonical values and exact (tolerance 0)."""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from narwhal_tpu.ops import field25519 as JF
from narwhal_tpu_torch.ops import field25519 as TF

P = TF.P
BOUNDARY = [0, 1, P - 1, P, (1 << 255) - 1, 2, 19, P + 1, (1 << 252)]


def _values(seed, n):
    rng = random.Random(seed)
    vals = BOUNDARY + [rng.randrange(1 << 255) for _ in range(n - len(BOUNDARY))]
    return vals[:n]


def _limbs(vals):
    return np.stack([TF.to_limbs(v) for v in vals])


def _canon_ints(limbs):
    return [TF.from_limbs(row) for row in np.asarray(limbs)]


def test_limb_layout_matches_jax():
    vals = _values(0, 16)
    assert np.array_equal(_limbs(vals), np.stack([JF.to_limbs(v) for v in vals]))
    assert np.array_equal(TF._ZP, np.asarray(JF._ZP))


@pytest.mark.parametrize(
    "op,ref",
    [
        ("mul", lambda a, b: a * b % P),
        ("add", lambda a, b: (a + b) % P),
        ("sub", lambda a, b: (a - b) % P),
        ("square", lambda a, b: a * a % P),
        ("neg", lambda a, b: -a % P),
        ("canon", lambda a, b: a % P),
    ],
)
def test_binary_ops_match_jax_and_big_ints(op, ref):
    a_vals = _values(1, 32)
    b_vals = list(reversed(_values(2, 32)))
    a, b = _limbs(a_vals), _limbs(b_vals)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    if op in ("mul", "add", "sub"):
        got_t = getattr(TF, op)(ta, tb)
        got_j = getattr(JF, op)(ja, jb)
    else:
        got_t = getattr(TF, op)(ta)
        got_j = getattr(JF, op)(ja)
    t_canon = TF.canon(got_t).numpy()
    j_canon = np.asarray(JF.canon(got_j))
    assert np.array_equal(t_canon, j_canon)
    assert (t_canon < 256).all() and (t_canon >= 0).all()
    want = [ref(x, y) for x, y in zip(a_vals, b_vals)]
    assert _canon_ints(t_canon) == want
    if op != "canon":
        # Weak reduction, as the reference bounds it: limbs < 2^9.
        assert int(got_t.max()) < (1 << 9) and int(got_t.min()) >= 0


@pytest.mark.parametrize("op", ["invert", "pow_p58"])
def test_exponentiations_match_jax_and_big_ints(op):
    vals = _values(3, 8)
    a = _limbs(vals)
    got_t = TF.canon(getattr(TF, op)(torch.from_numpy(a))).numpy()
    got_j = np.asarray(JF.canon(getattr(JF, op)(jnp.asarray(a))))
    assert np.array_equal(got_t, got_j)
    e = P - 2 if op == "invert" else (P - 5) // 8
    assert _canon_ints(got_t) == [pow(v, e, P) for v in vals]


def test_mul_chain_stays_weakly_reduced():
    """64 chained squarings of worst-case weak limbs (all 2^9 - 1) stay
    inside the int32 bounds and agree with big ints."""
    x = torch.full((2, TF.LIMBS), (1 << 9) - 1, dtype=torch.int32)
    v = TF.from_limbs(x[0].numpy()) % P
    for _ in range(64):
        x = TF.square(x)
        v = v * v % P
        assert int(x.max()) < (1 << 9)
    assert _canon_ints(TF.canon(x).numpy()) == [v, v]

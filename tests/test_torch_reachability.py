"""The port's window kernels (plain PyTorch twins, on the CPU) against the
JAX programs they replace, on random causal windows.

Every comparison here is exact (tolerance 0): all values are int32
counts or bools.  The CUDA kernels themselves run only on the GPU, where
chip_smoke.py holds each against these twins."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from narwhal_tpu.ops import reachability as JR
from narwhal_tpu_torch.ops import reachability as TR

W, N = 16, 7


def _window(rng, window: int, n: int):
    """A random-but-causal DAG window as presence counts: every cert
    references a quorum of the previous round's certificates."""
    exists = rng.random((window, n)) < 0.9
    exists[0] = True  # genesis row
    parent = np.zeros((window, n, n), dtype=np.int32)
    quorum = 2 * ((n - 1) // 3) + 1
    for w in range(1, window):
        for i in range(n):
            if exists[w, i]:
                prev = np.flatnonzero(exists[w - 1])
                take = prev[rng.permutation(len(prev))[:quorum]]
                parent[w, i, take] = 1
    return exists.astype(np.int32), parent


def _leaders(rng, exists, anchor_slot):
    window, n = exists.shape
    leader_onehot = np.zeros((window, n), dtype=bool)
    is_leader_slot = np.zeros(window, dtype=bool)
    for w in range(2, window - 1, 2):
        who = int(rng.integers(n))
        leader_onehot[w, who] = exists[w, who] > 0
        is_leader_slot[w] = exists[w, who] > 0
    anchor_onehot = np.zeros(n, dtype=bool)
    anchor_onehot[int(rng.integers(n))] = True
    return leader_onehot, is_leader_slot, anchor_onehot


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("seed,negative", [
    *(pytest.param(seed, False, id=str(seed)) for seed in range(4)),
    *(pytest.param(seed, True, id=f"negative-{seed}") for seed in range(4, 10)),
])
def test_window_apply_matches_jax(seed, negative):
    """With ``negative``, slots drawn from [-W-1, W] and authorities from
    [-N-1, N]: JAX counts an index in [-W, 0) or [-N, 0) from the end and
    drops what is still out of range."""
    rng = np.random.default_rng(seed)
    exists, parent = _window(rng, W, N)
    C = 64
    lo_w, lo_n, hi_n = (-W - 1, -N - 1, N + 1) if negative else (0, 0, N)
    ins_w = rng.integers(lo_w, W + 1, C).astype(np.int32)  # W = padding, dropped
    ins_i = rng.integers(lo_n, hi_n, C).astype(np.int32)
    row_w = rng.integers(lo_w, W + 1, C).astype(np.int32)
    row_c = rng.integers(lo_n, hi_n, C).astype(np.int32)
    row_v = (rng.random((C, N)) < 0.4).astype(np.int32)
    # Two rows hitting the same cell: the scatter must add, not overwrite.
    row_w[1], row_c[1] = row_w[0] % W, row_c[0]
    row_w[0] = row_w[1]

    je, jp = JR.window_apply(
        jnp.asarray(exists), jnp.asarray(parent), ins_w, ins_i, row_w, row_c,
        row_v,
    )
    te, tp = _t(exists.copy()), _t(parent.copy())
    out = TR.window_apply(te, tp, _t(ins_w), _t(ins_i), _t(row_w), _t(row_c),
                          _t(row_v))
    assert out[0] is te and out[1] is tp  # in place
    assert np.array_equal(te.numpy(), np.asarray(je))
    assert np.array_equal(tp.numpy(), np.asarray(jp))
    if negative:
        assert (ins_w < 0).any() and (row_c < 0).any()


def test_window_apply_wraps_negative_indices_like_jax():
    """The fixed case: slot -1 is slot W-1, authority -1 is N-1 and -2 is
    N-2; slot W is dropped."""
    window, n = 8, 4
    ins_w, ins_i = np.array([-1, 2, 8], np.int32), np.array([1, -1, 0], np.int32)
    row_w, row_c = np.array([-1, 3, 8], np.int32), np.array([0, -2, 1], np.int32)
    row_v = np.ones((3, n), np.int32)
    je, jp = JR.window_apply(jnp.zeros((window, n), jnp.int32),
                             jnp.zeros((window, n, n), jnp.int32),
                             ins_w, ins_i, row_w, row_c, row_v)
    te = torch.zeros((window, n), dtype=torch.int32)
    tp = torch.zeros((window, n, n), dtype=torch.int32)
    TR.window_apply(te, tp, _t(ins_w), _t(ins_i), _t(row_w), _t(row_c), _t(row_v))
    assert np.argwhere(te.numpy()).tolist() == [[2, 3], [7, 1]]
    assert np.argwhere(tp.numpy().any(-1)).tolist() == [[3, 2], [7, 0]]
    assert np.array_equal(te.numpy(), np.asarray(je))
    assert np.array_equal(tp.numpy(), np.asarray(jp))


def ring_at(exists, parent, origin):
    """A CPU :class:`WindowRing` holding the logical window (``exists``,
    ``parent``) with its origin at physical slot ``origin``, in both
    mirror copies."""
    window, n = exists.shape
    ring = TR.WindowRing(window, n, "cpu")
    ring.origin = origin
    slots = (torch.arange(window) + origin) % window
    for copy in (0, window):
        ring.exists2[slots + copy] = _t(exists)
        ring.parent2[slots + copy] = _t(parent)
    return ring


def assert_mirrored(ring):
    W = ring.window
    assert torch.equal(ring.exists2[:W], ring.exists2[W:])
    assert torch.equal(ring.parent2[:W], ring.parent2[W:])


@pytest.mark.parametrize("d", [1, 2, 5, W - 1, W, W + 3])
def test_window_shift_matches_jax(d):
    """The ring's shift (origin moved, retired slots zeroed on the next
    read) against JAX's window_shift_op, from an origin whose view wraps."""
    rng = np.random.default_rng(100 + d)
    exists, parent = _window(rng, W, N)
    je, jp = JR.window_shift_op(
        jnp.asarray(exists), jnp.asarray(parent), jnp.int32(d), W
    )
    ring = ring_at(exists, parent, origin=(3 * d + 5) % W)
    ring.shift(d)
    assert ring.pending == (d < W)  # no launch yet, unless it zeroed all
    assert np.array_equal(ring.exists.numpy(), np.asarray(je))
    assert not ring.pending
    assert np.array_equal(ring.parent.numpy(), np.asarray(jp))
    assert_mirrored(ring)


@pytest.mark.parametrize("seed", range(6))
def test_leader_commit_scan_matches_jax(seed):
    rng = np.random.default_rng(200 + seed)
    window = 16 if seed % 2 else 8
    exists, parent = _window(rng, window, N)
    anchor_slot = window - 1 - int(rng.integers(0, 3))
    leader_onehot, is_leader_slot, anchor_onehot = _leaders(
        rng, exists, anchor_slot
    )
    want = np.asarray(JR.leader_commit_scan_counts(
        jnp.asarray(parent), jnp.asarray(exists), leader_onehot,
        is_leader_slot, jnp.int32(anchor_slot), anchor_onehot, window,
    ))
    got = TR.leader_commit_scan(
        _t(parent), _t(exists), _t(leader_onehot), _t(is_leader_slot),
        anchor_slot, _t(anchor_onehot),
    ).numpy()
    assert np.array_equal(got, want)


def test_leader_commit_scan_full_chain_commits():
    """A window where every even slot's leader cites the previous one:
    the scan must mark the whole chain, as the JAX program does."""
    window, n = 12, 4
    exists = np.ones((window, n), dtype=np.int32)
    parent = np.zeros((window, n, n), dtype=np.int32)
    parent[1:] = 1
    leader_onehot = np.zeros((window, n), dtype=bool)
    is_leader_slot = np.zeros(window, dtype=bool)
    for w in range(2, 10, 2):
        leader_onehot[w, w % n] = True
        is_leader_slot[w] = True
    anchor_onehot = np.zeros(n, dtype=bool)
    anchor_onehot[2] = True
    want = np.asarray(JR.leader_commit_scan_counts(
        jnp.asarray(parent), jnp.asarray(exists), leader_onehot,
        is_leader_slot, jnp.int32(10), anchor_onehot, window,
    ))
    got = TR.leader_commit_scan(
        _t(parent), _t(exists), _t(leader_onehot), _t(is_leader_slot), 10,
        _t(anchor_onehot),
    ).numpy()
    assert np.array_equal(got, want)
    assert got[2:10:2].all() and got.sum() == 4



# ---------------------------------------------------------------- KernelTusk
#
# The port's KernelTusk(device="cpu") against the JAX KernelTusk and the
# JAX Tusk, certificate for certificate, on the scenarios of
# tests/test_reachability.py.  Certificates are built with the JAX
# package's fixtures and carried across as serialized bytes; both
# packages run with the same wire committee installed.

import random  # noqa: E402

import narwhal_tpu.messages as jmessages  # noqa: E402
import narwhal_tpu_torch.messages as tmessages  # noqa: E402
from narwhal_tpu.consensus import Tusk as JaxTusk  # noqa: E402
from narwhal_tpu_torch.config import Committee as TorchCommittee  # noqa: E402
from narwhal_tpu_torch.convert import window_from_numpy  # noqa: E402
from narwhal_tpu_torch.primary.messages import (  # noqa: E402
    Certificate as TorchCertificate,
)

from tests.common import committee  # noqa: E402
from tests.test_consensus import (  # noqa: E402
    genesis_digests,
    make_certificates,
    mock_certificate,
    sorted_names,
)
from tests.test_reachability import _random_dag_certs  # noqa: E402


@pytest.fixture
def wire_committee():
    """The same committee installed as both packages' wire key space
    (restored afterwards: the install is process-wide)."""
    jc = committee()
    tc = TorchCommittee.from_json(jc.to_json())
    saved = [(m, m._WIRE_KEYS, m._WIRE_INDEX) for m in (jmessages, tmessages)]
    jmessages.set_wire_committee(jc)
    tmessages.set_wire_committee(tc)
    yield jc, tc
    for m, keys, index in saved:
        m._WIRE_KEYS, m._WIRE_INDEX = keys, index


def _carry(certs):
    return [TorchCertificate.deserialize(c.serialize()) for c in certs]


def _feed(tusk, certs):
    out = []
    for c in certs:
        out.extend(tusk.process_certificate(c))
    return [bytes(c.digest()) for c in out]


def _scenario(name):
    c = committee()
    names = sorted_names()
    g = genesis_digests(c)
    if name == "commit_one":
        certs, parents = make_certificates(1, 4, g, names)
        return certs + [mock_certificate(names[0], 5, parents)[1]], 50
    if name == "dead_node":
        return make_certificates(1, 9, g, names[:3])[0], 50
    if name == "not_enough_support":
        certs, parents = make_certificates(1, 1, g, names[:3])
        leader_2, cert = mock_certificate(names[0], 2, parents)
        certs.append(cert)
        out, parents = make_certificates(2, 2, parents, names[1:])
        certs += out
        nxt = set()
        for who, extra in ((1, set()), (2, set()), (0, {leader_2})):
            d, cert = mock_certificate(names[who], 3, parents | extra)
            certs.append(cert)
            nxt.add(d)
        out, parents = make_certificates(4, 6, nxt, names[:3])
        return certs + out + [mock_certificate(names[0], 7, parents)[1]], 50
    if name == "missing_leader":
        certs, parents = make_certificates(1, 4, g, names[1:])
        out, parents = make_certificates(5, 7, parents, names)
        return certs + out + [mock_certificate(names[0], 8, parents)[1]], 50
    if name == "fuzz":
        rng = random.Random(0xDA6)
        certs = _random_dag_certs(rng, rounds=18)
        return sorted(certs, key=lambda x: (x.round, rng.random())), 50
    if name == "out_of_order":
        rng = random.Random(0xBEEF)
        certs = _random_dag_certs(rng, rounds=14)
        return sorted(certs, key=lambda x: x.round + rng.uniform(-2.2, 0.0)), 50
    if name == "gc_wrap":
        return make_certificates(1, 30, g, names)[0], 6
    if name == "stall_fallback":
        certs1, parents = make_certificates(1, 17, g, names[1:])
        certs2, parents = make_certificates(18, 19, parents, names)
        _, trigger = mock_certificate(names[0], 20, parents)
        certs3, parents = make_certificates(20, 23, parents, names)
        _, trigger2 = mock_certificate(names[1], 24, parents)
        return certs1 + certs2 + [trigger] + certs3 + [trigger2], 6
    if name == "multi_round_burst":
        certs, parents = make_certificates(1, 16, g, names)
        order = sorted(certs, key=lambda x: (x.round % 2 == 0, x.round))
        return order + [mock_certificate(names[0], 17, parents)[1]], 50
    raise ValueError(name)


SCENARIOS = [
    "commit_one", "dead_node", "not_enough_support", "missing_leader",
    "fuzz", "out_of_order", "gc_wrap", "stall_fallback", "multi_round_burst",
]


@pytest.mark.parametrize("name", SCENARIOS)
def test_kernel_tusk_commits_like_jax(name, wire_committee):
    jc, tc = wire_committee
    certs, gc_depth = _scenario(name)
    golden = _feed(JaxTusk(jc, gc_depth=gc_depth, fixed_coin=True), certs)
    jk = JR.KernelTusk(jc, gc_depth=gc_depth, fixed_coin=True)
    jax_kernel = _feed(jk, certs)
    tk = TR.KernelTusk(tc, gc_depth=gc_depth, fixed_coin=True, device="cpu")
    ported = _feed(tk, _carry(certs))
    assert ported == jax_kernel == golden
    if name != "missing_leader":  # (the reference scenario commits nothing)
        assert golden, "scenario committed nothing"
    assert tk.python_fallbacks == jk.python_fallbacks
    assert tk._win_base == jk._win_base == tk.state.last_committed_round
    if name == "stall_fallback":
        assert tk.python_fallbacks >= 1
    else:
        assert tk.python_fallbacks == 0
    # The device windows agree cell for cell after a final flush.
    jk._flush_pending()
    tk._flush_pending()
    e, p = window_from_numpy(
        np.asarray(jk._dev_exists), np.asarray(jk._dev_parent), device="cpu"
    )
    assert torch.equal(e, tk._dev_exists) and torch.equal(p, tk._dev_parent)


@pytest.mark.parametrize("name", ["commit_one", "gc_wrap", "multi_round_burst"])
def test_kernel_tusk_reads_window_with_clear_pending(name, wire_committee):
    """After each commit the port's shift is pending (no launch); reading
    ``_dev_exists`` runs it first and gives JAX's eagerly shifted window."""
    jc, tc = wire_committee
    certs, gc_depth = _scenario(name)
    jk = JR.KernelTusk(jc, gc_depth=gc_depth, fixed_coin=True)
    tk = TR.KernelTusk(tc, gc_depth=gc_depth, fixed_coin=True, device="cpu")
    checked = 0
    for jcert, tcert in zip(certs, _carry(certs)):
        jk.process_certificate(jcert)
        if tk.process_certificate(tcert) and tk._ring.pending:
            e, p = window_from_numpy(
                np.asarray(jk._dev_exists), np.asarray(jk._dev_parent),
                device="cpu",
            )
            assert torch.equal(tk._dev_exists, e)  # runs the pending clear
            assert not tk._ring.pending
            assert torch.equal(tk._dev_parent, p)
            assert_mirrored(tk._ring)
            checked += 1
    assert checked > 0


def test_window_from_numpy_validates_shapes():
    with pytest.raises(ValueError):
        window_from_numpy(np.zeros((4, 3), np.int32), np.zeros((4, 3, 2), np.int32), "cpu")
    with pytest.raises(ValueError):
        window_from_numpy(np.zeros((4, 3)), np.zeros((4, 3, 3)), "cpu")

"""The committee-sharded commit step as the JAX scan steps it
(``narwhal_tpu_torch.ops.reachability.commit_step_sharded`` and its slot,
``commit_step_block``), on the CPU, its ranks processes of their own over
gloo, against the JAX package.

- (a) Over k = 1, 2, 3, 4 and 8 ranks every rank returns what ``jax.jit``
  of ``__graft_entry__.make_commit_step`` returns at every anchor in
  [-2, W + 2], bit for bit (tolerance 0): sharded over a k-device
  ``committee`` mesh of this process's 8-device CPU mesh where k divides
  N, unsharded where it does not.  Windows of one and two slots too.
- (b) ``commit_step_block_plain``, slot by slot and rank by rank, writes
  the slices of the JAX scan (g, g & leader where the slot may lead) and
  the JAX gate's pieces (each rank's votes, each rank's stake of voters,
  summing to the JAX support) into its record.
- (c) A step makes W slot calls and W gathers whatever the anchor (two of
  each for W = 1) and no reduction collective; a CUDA graph needs NCCL.
- (d) The record's bit packing round-trips, in a ballot's bit order.
"""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from __graft_entry__ import commit_fixture as jcommit_fixture  # noqa: E402
from __graft_entry__ import make_commit_step as jmake_commit_step  # noqa: E402
from __graft_entry__ import shard_commit_args as jshard_commit_args  # noqa: E402
from narwhal_tpu.ops.reachability import leader_chain_scan as jleader_chain_scan  # noqa: E402
from narwhal_tpu_torch import commit_step as CS  # noqa: E402
from narwhal_tpu_torch.ops import reachability as R  # noqa: E402


def bits(a) -> str:
    return np.packbits(np.asarray(a).reshape(-1)).tobytes().hex()


@functools.lru_cache(maxsize=None)
def jitted_step(window):
    return jax.jit(jmake_commit_step(window))


def jax_step(window, fixture, anchor, mesh=None):
    """(support, committed, reach) of ``jax.jit(make_commit_step)`` at
    ``anchor``, sharded over ``mesh`` when given."""
    step = jitted_step(window)
    fixture = list(fixture)
    fixture[5] = anchor
    if mesh is None:
        out = step(*(jnp.asarray(a) for a in fixture[:5]), jnp.int32(anchor),
                   jnp.asarray(fixture[6]))
    else:
        with mesh:
            out = step(*jshard_commit_args(mesh, fixture))
    return tuple(np.asarray(a) for a in out)


def assert_ranks_equal(records, want, where):
    support, committed, reach = want
    for rank, rec in enumerate(records):
        got = (rec["support"], rec["committed_bits"], rec["reach_bits"])
        assert got == (int(support), bits(committed), bits(reach)), (where, rank)
        assert rec["launches"] == {} and rec["graph"] is False, rec


@pytest.mark.parametrize("k", (1, 2, 3, 4, 8))
def test_step_equals_jax_at_every_anchor(k):
    window = 16
    anchors = range(-2, window + 3)
    sizes = (4 * k, 4 * k + 1)
    cases = [(1, window, n, a) for n in sizes for a in anchors]
    records = CS.dryrun_multichip(k, device="cpu", backend="gloo", cases=cases)
    assert len(records) == k
    leads = 0
    for n in sizes:
        fixture = jcommit_fixture(1, window, n)
        mesh = Mesh(np.array(jax.devices()[:k]), ("committee",)) if n % k == 0 else None
        for a in anchors:
            i = cases.index((1, window, n, a))
            want = jax_step(window, fixture, a, mesh)
            assert_ranks_equal([r[i] for r in records], want, (n, a))
            assert records[0][i]["parent_block"] == [window, n, -(-n // k)]
            leads += int(want[1].sum())
    assert leads > 0  # some anchors commit a chain


@pytest.mark.parametrize("window", (1, 2))
def test_short_windows_equal_jax(window):
    # W = 1 has no slot below the top one for the gate: its step adds the
    # gate's own launch and gather.
    n, k = 7, 3
    anchors = range(-2, window + 3)
    cases = [(4, window, n, a) for a in anchors]
    records = CS.dryrun_multichip(k, device="cpu", backend="gloo", cases=cases)
    fixture = jcommit_fixture(4, window, n)
    for i, a in enumerate(anchors):
        assert_ranks_equal([r[i] for r in records], jax_step(window, fixture, a), a)


def _padded(a, k, nb):
    out = np.zeros(a.shape[:-1] + (k * nb,), dtype=a.dtype)
    out[..., : a.shape[-1]] = a
    return out


@pytest.mark.parametrize("k,anchor", [(1, None), (3, None), (4, None), (3, 0), (4, 15),
                                      (3, 16), (4, -1)])
def test_slot_records_equal_slices_of_the_jax_scan_and_gate(k, anchor):
    window, n = 16, 10
    fixture = list(jcommit_fixture(5, window, n))
    if anchor is not None:
        fixture[5] = anchor
    parent, exists, leader, is_lead, stake, a, onehot = fixture
    _, jreach = (np.asarray(x) for x in jleader_chain_scan(
        jnp.asarray(parent), jnp.asarray(exists), jnp.asarray(leader),
        jnp.asarray(is_lead), jnp.int32(a), jnp.asarray(onehot), window=window))
    jsupport = int(jax_step(window, fixture, a)[0])
    nb = -(-n // k)
    bw = -(-nb // 32)
    blocks = [CS.shard_commit_args(r, k, fixture, "cpu") for r in range(k)]
    anchor_t = torch.tensor(a, dtype=torch.int32)
    # The JAX gate's pieces: its child slot and leader row as traced
    # indices, each rank's votes on its columns, and its voters' stake.
    s, row = R._support_slot(a - 2, window), R._leader_row(a, window)
    jchild, jrow = jnp.asarray(parent[s]), jnp.asarray(leader[row])
    jvotes = np.asarray(jnp.any(jchild & jrow[None, :], axis=1))
    prev, partials = None, []
    for w in range(window - 1, -1, -1):
        recs = [R.commit_step_block_plain(w, *blk[:5], anchor_t, blk[6], prev, rank=r, k=k)
                for r, blk in enumerate(blocks)]
        may_lead = bool(is_lead[w]) and w < a
        want_g = _padded(jreach[w], k, nb).reshape(k, nb)
        want_gl = _padded(jreach[w] & leader[w] & may_lead, k, nb).reshape(k, nb)
        for r, rec in enumerate(recs):
            assert rec.shape == (R.record_words(n, nb),)
            np.testing.assert_array_equal(R.unpack_bits(rec[:bw], nb).numpy(), want_g[r])
            np.testing.assert_array_equal(R.unpack_bits(rec[bw:2 * bw], nb).numpy(),
                                          want_gl[r])
            votes = R.unpack_bits(rec[2 * bw:-1], n).numpy()
            if w == window - 1:
                cols = slice(r * nb, min((r + 1) * nb, n))
                want = np.asarray(jnp.any(jchild[:, cols] & jrow[None, cols], axis=1))
                np.testing.assert_array_equal(votes, want)
            else:
                assert not votes.any()
            if w == window - 2:
                own = slice(r * nb, min((r + 1) * nb, n))
                want = int(stake[own][(jvotes & exists[s])[own]].sum())
                assert int(rec[-1]) == want
                partials.append(want)
            else:
                assert int(rec[-1]) == 0
        prev = torch.stack(recs)
    assert sum(partials) == jsupport


def test_step_makes_w_slot_calls_and_gathers_whatever_the_anchor(tmp_path, monkeypatch):
    import torch.distributed as dist

    calls = {"slot": 0, "gather": 0, "reduce": 0}
    slot = R.commit_step_block

    def counted_slot(*args, **kw):
        calls["slot"] += 1
        return slot(*args, **kw)

    gather = dist.all_gather

    def counted_gather(*args, **kw):
        calls["gather"] += 1
        return gather(*args, **kw)

    def refused(*args, **kw):
        calls["reduce"] += 1
        raise AssertionError("the sharded step makes no reduction collective")

    monkeypatch.setattr(R, "commit_step_block", counted_slot)
    monkeypatch.setattr(dist, "all_gather", counted_gather)
    monkeypatch.setattr(dist, "all_reduce", refused)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        for window in (1, 2, 8, 16):
            fixture = list(CS.commit_fixture(2, window, 6))
            for a in range(-2, window + 3):
                fixture[5] = a
                args = CS.shard_commit_args(0, 1, fixture, "cpu")
                calls.update(slot=0, gather=0)
                got = R.commit_step_sharded(None, *args, n=6)
                want = R.commit_step_plain(*(x if isinstance(x, int) else torch.from_numpy(x)
                                             for x in fixture))
                assert all(torch.equal(x, y) for x, y in zip(got, want)), (window, a)
                launches = window if window > 1 else 2
                assert calls == {"slot": launches, "gather": launches, "reduce": 0}
        with pytest.raises(ValueError, match="CUDA graph needs the nccl backend"):
            R.commit_step_sharded(None, *args, n=6, graph=True)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("n", (1, 31, 32, 33, 1024))
def test_record_bit_packing_round_trips(n):
    rng = np.random.default_rng(n)
    a = rng.random((3, n)) < 0.5
    a[0] = True
    words = R.pack_bits(torch.from_numpy(a))
    assert words.dtype == torch.int32 and words.shape == (3, -(-n // 32))
    np.testing.assert_array_equal(R.unpack_bits(words, n).numpy(), a)
    # A ballot's order: bit j of the row in word j // 32 at position j % 32.
    padded = np.zeros((3, 32 * words.shape[1]), dtype=bool)
    padded[:, :n] = a
    want = np.packbits(padded, axis=1, bitorder="little").view("<u4").astype(np.int64)
    np.testing.assert_array_equal(words.numpy().astype(np.int64) & 0xFFFFFFFF, want)
    assert R.record_words(n, n) == 3 * (-(-n // 32)) + 1


def test_graph_launches_are_the_capture_tally_added_at_each_replay(monkeypatch):
    # A card's capture, simulated: the launches the capture takes are
    # tallied, not counted; each replay adds the tally, and counts itself.
    import contextlib
    import types

    from narwhal_tpu_torch import ops

    capturing = {"on": False}

    @contextlib.contextmanager
    def graph(g, **kw):
        capturing["on"] = True
        try:
            yield
        finally:
            capturing["on"] = False

    def step(group, args, rec, send, packed, **kw):
        for _ in range(5):  # not W: the tally is what the capture launched
            ops.check_launch("commit_step_block", 0)
        return "out"

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing["on"])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(torch.cuda, "CUDAGraph",
                        lambda: types.SimpleNamespace(replay=lambda: None))
    monkeypatch.setattr(R, "_sharded_step", step)
    ops.reset_launches()
    capturing["on"] = True
    with pytest.raises(RuntimeError, match="captured outside ops.capturing"):
        ops.check_launch("commit_step_block", 0)
    capturing["on"] = False
    args = CS.shard_commit_args(0, 1, CS.commit_fixture(2, 8, 6), "cpu")
    args = (*args[:5], torch.tensor(args[5], dtype=torch.int32), args[6])
    g = R._StepGraph(None, args, rank=0, k=1, n=6)
    assert g.launches == {"commit_step_block": 5} and g.replays == 0
    assert ops.LAUNCHES["commit_step_block"] == 5  # the eager warm-up
    monkeypatch.setitem(R._GRAPHS, "test", g)
    before = R.graph_replays()
    new = [a.clone() for a in args]
    new[0][0, 0, 0] = not bool(args[0][0, 0, 0])
    assert g(new) == "out"
    assert ops.LAUNCHES["commit_step_block"] == 10 and g.replays == 1
    assert R.graph_replays() == before + 1
    assert all(torch.equal(a, b) for a, b in zip(g.static, new))
    ops.reset_launches()

"""The port's committee-sharded commit step
(``narwhal_tpu_torch.ops.reachability.commit_step_sharded``, driven by
``narwhal_tpu_torch.commit_step.dryrun_multichip``) on the CPU, its ranks
processes of their own over gloo.

- Over k = 2, 4 and 8 ranks at the reference's shape (W = 16, N = 4k)
  every rank returns what ``jax.jit`` of ``__graft_entry__.make_commit_step``
  returns sharded over a k-device ``committee`` mesh of this process's
  8-device CPU mesh, bit for bit (tolerance 0).
- On the flagship fixture (seed 0, W = 64, N = 50, which 4 ranks split
  unevenly, 13 columns a block) every rank returns ``commit_step_plain``'s
  values on the whole window at the fixture's anchor and at -W, -1, W-2
  and W+2.
- The block steps' plain twins equal the matching slices of the JAX
  chain scan and of the JAX gate's votes, slot by slot and rank by rank.
- A rank that fails fails the call and the others are stopped; NCCL with
  fewer cards than ranks raises."""

import time

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


def assert_ranks_return(records, support, committed, reach, launched=()):
    for rank, rec in enumerate(records):
        assert rec["rank"] == rank and rec["backend"] == "gloo"
        assert rec["support"] == int(support), rec
        assert rec["committed_bits"] == bits(committed), rec
        assert rec["reach_bits"] == bits(reach), rec
        # Plain twins on the CPU: no kernel launched.
        assert rec["launches"] == {}, rec


@pytest.mark.parametrize("k", (2, 4, 8))
def test_sharded_step_equals_the_jax_sharded_program(k):
    window, n = 16, 4 * k
    records = CS.dryrun_multichip(k, device="cpu", backend="gloo")
    assert len(records) == k and all(len(r) == 1 for r in records)
    mesh = Mesh(np.array(jax.devices()[:k]), ("committee",))
    with mesh:
        want = jax.jit(jmake_commit_step(window))(
            *jshard_commit_args(mesh, jcommit_fixture(1, window, n)))
    support, committed, reach = (np.asarray(a) for a in want)
    assert reach.any() and committed.any()
    assert_ranks_return([r[0] for r in records], support, committed, reach)
    assert all(r[0]["parent_block"] == [window, n, 4] for r in records)


def test_flagship_uneven_committee_over_four_ranks():
    window, n = 64, 50
    anchors = (None, -window, -1, window - 2, window + 2)
    cases = [(0, window, n, a) for a in anchors]
    records = CS.dryrun_multichip(4, device="cpu", backend="gloo", cases=cases, steps=1)
    fixture = CS.commit_fixture(0, window, n)
    for i, anchor in enumerate(anchors):
        args = [a if isinstance(a, int) else torch.from_numpy(a) for a in fixture]
        if anchor is not None:
            args[5] = anchor
        support, committed, reach = R.commit_step_plain(*args)
        assert_ranks_return([r[i] for r in records], support, committed, reach)
        assert all(r[i]["parent_block"] == [window, n, 13] for r in records)
    first = records[0][0]
    assert (first["support"], first["committed"], first["reach_cells"]) == (28, 26, 2477)
    # Each rank timed a step; no device time on the CPU.
    assert all(c["steps_timed"] == 1 and c["step_wall_ms"] > 0
               and c["block_step_ms"] is None for r in records for c in r)
    # Outside the window (W+2) the chain is empty; inside, it is not.
    assert records[0][4]["reach_cells"] == 0 and records[0][3]["reach_cells"] > 0


def _padded(a, k, nb):
    out = np.zeros(a.shape[:-1] + (k * nb,), dtype=a.dtype)
    out[..., : a.shape[-1]] = a
    return out


@pytest.mark.parametrize("k", (1, 3, 4))
def test_block_twins_equal_slices_of_the_jax_scan(k):
    window, n = 16, 10
    fixture = jcommit_fixture(5, window, n)
    parent, exists, leader, is_lead, stake, anchor, onehot = fixture
    jcommitted, jreach = (np.asarray(a) for a in jleader_chain_scan(
        jnp.asarray(parent), jnp.asarray(exists), jnp.asarray(leader),
        jnp.asarray(is_lead), jnp.int32(anchor), jnp.asarray(onehot), window=window))
    assert jcommitted.any()
    nb = -(-n // k)
    blocks = [CS.shard_commit_args(r, k, fixture, "cpu") for r in range(k)]
    steps = 0
    for w in range(anchor - 1, -1, -1):
        # Slot w+1's record as the ranks gather it: its g, and its
        # g & leader, which the anchor's slot does not reset to.
        g_up = _padded(jreach[w + 1], k, nb)
        gl_up = _padded(jreach[w + 1] & leader[w + 1], k, nb)
        if w + 1 == anchor:
            gl_up[:] = False
        prev = torch.from_numpy(np.stack([g_up.reshape(k, nb), gl_up.reshape(k, nb)], 1))
        lead = torch.tensor(bool(is_lead[w + 1]))
        want_g = _padded(jreach[w], k, nb).reshape(k, nb)
        want_gl = _padded(jreach[w] & leader[w], k, nb).reshape(k, nb)
        for r, blk in enumerate(blocks):
            got = R.chain_step_block_plain(blk[0][w + 1], blk[1][w], blk[2][w], prev, lead)
            np.testing.assert_array_equal(got.numpy(), np.stack([want_g[r], want_gl[r]]))
            steps += 1
    assert steps == anchor * k
    # The gate: each block's votes are the JAX gate's expression on its
    # columns; they OR to the JAX votes, and their voters' stake sums to
    # the JAX support.
    s, row = anchor - 1, anchor - 2
    jchild, jrow = jnp.asarray(parent[s]), jnp.asarray(leader[row])
    ored = np.zeros(n, dtype=bool)
    for r, blk in enumerate(blocks):
        cols = slice(r * nb, min((r + 1) * nb, n))
        want = np.asarray(jnp.any(jchild[:, cols] & jrow[None, cols], axis=1))
        got = R.support_votes_block_plain(blk[0][s], blk[2][row]).numpy()
        np.testing.assert_array_equal(got, want)
        ored |= got
    jvotes = np.asarray(jnp.any(jchild & jrow[None, :], axis=1))
    np.testing.assert_array_equal(ored, jvotes)
    support = int(np.asarray(jmake_commit_step(window)(
        *(jnp.asarray(a) for a in fixture[:5]), jnp.int32(anchor),
        jnp.asarray(onehot))[0]))
    assert int(stake[ored & exists[s]].sum()) == support


@pytest.mark.parametrize("k", (1, 3, 4, 7, 8))
def test_parent_blocks_are_the_ranks_columns(k):
    window, n = 8, 50
    fixture = CS.commit_fixture(3, window, n)
    nb = -(-n // k)
    blocks = [CS.shard_commit_args(r, k, fixture, "cpu") for r in range(k)]
    for blk in blocks:
        assert tuple(blk[0].shape) == (window, n, nb)
        assert tuple(blk[1].shape) == tuple(blk[2].shape) == (window, nb)
        assert tuple(blk[4].shape) == (nb,) and blk[5] == fixture[5]
    # Laid side by side the blocks are the window, and the padding is empty.
    for i in (0, 1, 2, 4):
        whole = torch.cat([blk[i] for blk in blocks], dim=-1).numpy()
        np.testing.assert_array_equal(whole[..., :n], fixture[i])
        assert not whole[..., n:].any()


def test_a_failing_rank_fails_the_call_and_stops_the_others(tmp_path):
    codes = ["import time; time.sleep(120)",
             "raise SystemExit('rank 1 gives up')",
             "import time; time.sleep(120)"]
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 exited with 1") as err:
        CS._run_ranks(codes, str(tmp_path), timeout=60)
    assert time.monotonic() - t0 < 30
    assert "rank 1 gives up" in str(err.value)
    with pytest.raises(RuntimeError, match="still running after 1 s"):
        CS._run_ranks(codes[:1] * 2, str(tmp_path), timeout=1)


def test_a_rank_that_raises_fails_dryrun_multichip():
    # No authority: every rank fails to draw the fixture's leaders.
    with pytest.raises(RuntimeError, match="(?s)exited with 1.*ZeroDivisionError"):
        CS.dryrun_multichip(2, device="cpu", backend="gloo", cases=((0, 8, 0, None),))


def test_nccl_takes_a_card_a_rank(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(ValueError, match="backend='gloo'"):
        CS.dryrun_multichip(4)
    with pytest.raises(ValueError, match="backend='gloo'"):
        CS.dryrun_multichip(2, device="cpu")
    with pytest.raises(ValueError, match="unsupported backend"):
        CS.dryrun_multichip(2, device="cpu", backend="mpi")

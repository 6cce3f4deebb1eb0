"""The window scans' bit-packed form (csrc/window_bits.cuh) on the CPU: a
host build of the same pack and step the CUDA kernels run, the 32 lanes of
the scanning warp stepped in lockstep (tests/window_bits_host.cpp, built
with g++ once per module), held against the port's plain twins and the
JAX ``leader_commit_scan_counts``, ``leader_chain_scan`` and
``causal_mask_scan``.

Every comparison is exact (tolerance 0): the outputs are bools.  Chunks
are forced small so that the frontier crosses chunk boundaries, and the
shared memory starts with junk in it, as on the card."""

import ctypes
import os
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from narwhal_tpu.ops import reachability as JR
from narwhal_tpu_torch.ops import reachability as TR

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(HERE), "narwhal_tpu_torch", "csrc")
H100_SMEM_BYTES = 232448  # the dynamic shared memory a block may opt in to

SHAPES = [(W, N) for W in (8, 64) for N in (1, 31, 32, 50, 63, 64, 65, 130)]


@pytest.fixture(scope="module")
def bits(tmp_path_factory):
    """The host harness as a ctypes library."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host harness cannot be built")
    so = str(tmp_path_factory.mktemp("window_bits") / "window_bits.so")
    subprocess.run(
        [gxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-I", CSRC,
         os.path.join(HERE, "window_bits_host.cpp"), "-o", so],
        check=True, capture_output=True, timeout=300,
    )
    lib = ctypes.CDLL(so)
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.h_leader_commit_scan.argtypes = [vp] * 5 + [i, vp, i, i, i, i]
    lib.h_leader_chain_scan.argtypes = [vp] * 5 + [i, vp, vp, i, i, i, i]
    lib.h_causal_mask_scan.argtypes = [vp, vp, i, vp, vp, i, i, i, i]
    lib.h_chunk_slots.argtypes = [i, i, ctypes.c_longlong]
    lib.h_smem_bytes.argtypes = [i, i]
    lib.h_smem_bytes.restype = ctypes.c_longlong
    lib.h_byte_bits.argtypes = [ctypes.c_uint]
    lib.h_byte_bits.restype = ctypes.c_uint
    return lib


def _p(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _window(rng, window: int, n: int):
    """A random causal window of presence counts (1..3 where present), plus
    a sprinkle of counts on absent certificates' rows and of negative
    counts, which the scans must read as absent."""
    exists = (rng.random((window, n)) < 0.9).astype(np.int32)
    exists[0] = 1
    exists *= rng.integers(1, 4, (window, n), dtype=np.int32)
    parent = np.zeros((window, n, n), dtype=np.int32)
    quorum = 2 * ((n - 1) // 3) + 1
    for w in range(1, window):
        prev = np.flatnonzero(exists[w - 1])
        for i in range(n):
            take = prev[rng.permutation(len(prev))[:quorum]]
            parent[w, i, take] = rng.integers(1, 4, len(take))
    parent[rng.random(parent.shape) < 0.01] = -1
    exists[rng.random(exists.shape) < 0.02] = -2
    return exists, parent


def _leaders(rng, exists):
    """Leaders on the even slots 2..W-2, where the drawn authority exists."""
    window, n = exists.shape
    leader = np.zeros((window, n), dtype=bool)
    is_lead = np.zeros(window, dtype=bool)
    for w in range(2, window - 1, 2):
        who = int(rng.integers(n))
        leader[w, who] = is_lead[w] = exists[w, who] > 0
    return leader, is_lead


def _anchor_slots(window: int):
    """Inside the window, at its edges, and outside [0, W)."""
    return sorted({window - 2, window // 2, 1, 0, window - 1, window, -1,
                   window + 5} - {-2})


def _chunks(window: int):
    """(slots per chunk, warps sharing the pack): chunks forced small, and
    the card's choice; one warp, an odd count, and a cluster's 256."""
    return ((1, 256), (3, 7), (0, 1), (0, 256)) if window > 8 else \
        ((1, 1), (3, 256), (5, 7), (0, 256))


def _onehot(rng, exists, slot):
    n = exists.shape[1]
    out = np.zeros(n, dtype=bool)
    if 0 <= slot < exists.shape[0] and (exists[slot] > 0).any():
        out[int(rng.choice(np.flatnonzero(exists[slot] > 0)))] = True
    else:
        out[int(rng.integers(n))] = True
    return out


def _host_commit(bits, parent, exists, leader, is_lead, anchor_slot, anchor, chunk):
    W, N = exists.shape
    committed = np.zeros(W, dtype=np.uint8)
    S = bits.h_leader_commit_scan(_p(parent), _p(exists), _p(leader), _p(is_lead),
                                  _p(anchor), anchor_slot, _p(committed), W, N,
                                  *chunk)
    assert S >= 1
    return committed.astype(bool)


def _host_chain(bits, parent, exists, leader, is_lead, anchor_slot, anchor, chunk):
    W, N = exists.shape
    committed = np.zeros(W, dtype=np.uint8)
    reach = np.full((W, N), 7, dtype=np.uint8)  # every cell must be written
    S = bits.h_leader_chain_scan(_p(parent), _p(exists), _p(leader), _p(is_lead),
                                 _p(anchor), anchor_slot, _p(committed), _p(reach),
                                 W, N, *chunk)
    assert S >= 1
    assert set(np.unique(reach)) <= {0, 1}
    return committed.astype(bool), reach.astype(bool)


def _host_cone(bits, parent, exists, start_slot, start, chunk):
    W, N = exists.shape
    mask = np.full((W, N), 7, dtype=np.uint8)
    S = bits.h_causal_mask_scan(_p(parent), _p(exists), start_slot, _p(start),
                                _p(mask), W, N, *chunk)
    assert S >= 1
    assert set(np.unique(mask)) <= {0, 1}
    return mask.astype(bool)


@pytest.mark.parametrize("W,N", SHAPES)
def test_chain_scans_match_plain_and_jax(bits, W, N):
    """leader_commit_scan (int32 counts) and leader_chain_scan (bools, with
    the reach masks): the host form at every chunk size against the plain
    twins and the JAX programs, for anchors inside, at the edges of and
    outside the window, with and without linked leaders."""
    rng = np.random.default_rng(1000 * W + N)
    exists, parent = _window(rng, W, N)
    parent_b, exists_b = parent > 0, exists > 0
    pb8, eb8 = parent_b.view(np.uint8), exists_b.view(np.uint8)
    leader, is_lead = _leaders(rng, exists)
    schedules = (("leaders", leader, is_lead),
                 ("no linked leader", np.zeros_like(leader), np.zeros_like(is_lead)))
    committed_any = False
    for anchor_slot in _anchor_slots(W):
        anchor = _onehot(rng, exists, anchor_slot)
        for label, lo, isl in schedules:
            args = (lo, isl, anchor_slot, anchor)
            want_c = np.asarray(JR.leader_commit_scan_counts(
                jnp.asarray(parent), jnp.asarray(exists), lo, isl,
                jnp.int32(anchor_slot), anchor, W))
            jc, jr = JR.leader_chain_scan(
                jnp.asarray(parent_b), jnp.asarray(exists_b), lo, isl,
                jnp.int32(anchor_slot), anchor, W)
            want_r = np.asarray(jr)
            assert np.array_equal(np.asarray(jc), want_c)
            plain_c = TR.leader_commit_scan_plain(
                _t(parent), _t(exists), _t(lo), _t(isl), anchor_slot, _t(anchor)).numpy()
            pc, pr = TR.leader_chain_scan_plain(
                _t(parent_b), _t(exists_b), _t(lo), _t(isl), anchor_slot, _t(anchor))
            assert np.array_equal(plain_c, want_c)
            assert np.array_equal(pr.numpy(), want_r)
            for chunk in _chunks(W):
                case = (label, anchor_slot, chunk)
                got = _host_commit(bits, parent, exists, lo.view(np.uint8),
                                   isl.view(np.uint8), anchor_slot,
                                   anchor.view(np.uint8), chunk)
                assert np.array_equal(got, want_c), case
                gc, gr = _host_chain(bits, pb8, eb8, lo.view(np.uint8),
                                     isl.view(np.uint8), anchor_slot,
                                     anchor.view(np.uint8), chunk)
                assert np.array_equal(gc, want_c), case
                assert np.array_equal(gr, want_r), case
            committed_any |= bool(want_c.any())
            if not isl.any():
                assert not want_c.any()
    if N > 1:
        assert committed_any, "no case committed a leader"


@pytest.mark.parametrize("W,N", SHAPES)
def test_cone_scan_matches_plain_and_jax(bits, W, N):
    """causal_mask_scan: the host form at every chunk size against the
    plain twin and the JAX program, from starts inside, at the edges of and
    outside the window (outside gives an empty mask)."""
    rng = np.random.default_rng(2000 * W + N)
    exists, parent = _window(rng, W, N)
    parent_b, exists_b = parent > 0, exists > 0
    pb8, eb8 = parent_b.view(np.uint8), exists_b.view(np.uint8)
    for start_slot in _anchor_slots(W):
        start = _onehot(rng, exists, start_slot)
        want = np.asarray(JR.causal_mask_scan(
            jnp.asarray(parent_b), jnp.asarray(exists_b), jnp.int32(start_slot),
            start, W))
        plain = TR.causal_mask_scan_plain(_t(parent_b), _t(exists_b), start_slot,
                                          _t(start)).numpy()
        assert np.array_equal(plain, want)
        for chunk in _chunks(W):
            got = _host_cone(bits, pb8, eb8, start_slot, start.view(np.uint8), chunk)
            assert np.array_equal(got, want), (start_slot, chunk)
        if not 0 <= start_slot < W:
            assert not want.any()
        elif start_slot >= 1 and N > 1:
            assert want[:start_slot].any(), "the cone reached no lower slot"


@pytest.mark.parametrize("offset", range(4))
def test_unaligned_windows(bits, offset):
    """Windows that start off a 16-byte boundary (the kernel then moves the
    chunk's first vector load back to one): the same results."""
    rng = np.random.default_rng(77 + offset)
    for W, N in ((8, 31), (8, 65), (64, 50)):
        exists, parent = _window(rng, W, N)
        leader, is_lead = _leaders(rng, exists)
        anchor_slot = W - 2
        anchor = _onehot(rng, exists, anchor_slot)
        counts = np.zeros(parent.size + 4, np.int32)[offset:offset + parent.size]
        counts[:] = parent.ravel()
        boolbuf = np.zeros(parent.size + 16, np.uint8)[3 * offset + 1:][:parent.size]
        boolbuf[:] = (parent > 0).ravel()
        counts, boolbuf = counts.reshape(parent.shape), boolbuf.reshape(parent.shape)
        assert counts.ctypes.data % 16 == (4 * offset) % 16
        eb8 = (exists > 0).view(np.uint8)
        args = (leader.view(np.uint8), is_lead.view(np.uint8), anchor_slot,
                anchor.view(np.uint8))
        pc, pr = TR.leader_chain_scan_plain(_t(parent > 0), _t(exists > 0),
                                            _t(leader), _t(is_lead), anchor_slot,
                                            _t(anchor))
        start = anchor
        plain_mask = TR.causal_mask_scan_plain(_t(parent > 0), _t(exists > 0),
                                               anchor_slot, _t(start)).numpy()
        for chunk in ((1, 7), (2, 256), (0, 1)):
            got = _host_commit(bits, counts, exists, *args, chunk)
            assert np.array_equal(got, pc.numpy()), (W, N, chunk)
            gc, gr = _host_chain(bits, boolbuf, eb8, *args, chunk)
            assert np.array_equal(gc, pc.numpy()) and np.array_equal(gr, pr.numpy())
            mask = _host_cone(bits, boolbuf, eb8, anchor_slot,
                              start.view(np.uint8), chunk)
            assert np.array_equal(mask, plain_mask), (W, N, chunk)


@pytest.mark.parametrize("N", [1, 32, 50, 64, 65, 200, 512, 700, 1000, 1024])
def test_chunk_fits_in_shared_memory(bits, N):
    """Under an H100 block's shared memory every N <= 1024 gets a chunk of
    at least one slot that fits, and the largest that does; the main
    path's W = 64, N = 50 window fits whole, under the 48 KB a launch gets
    without opting in; N = 1024 at W = 8 is scanned one slot a chunk."""
    planner = bits
    for W in (1, 8, 64, 256):
        S = planner.h_chunk_slots(W, N, H100_SMEM_BYTES)
        assert 1 <= S <= W
        assert planner.h_smem_bytes(S, N) <= H100_SMEM_BYTES
        if S < W:
            assert planner.h_smem_bytes(S + 1, N) > H100_SMEM_BYTES
    if N == 50:
        assert planner.h_chunk_slots(64, 50, H100_SMEM_BYTES) == 64
        assert planner.h_smem_bytes(64, 50) < 48 * 1024
    if N == 1024:
        assert planner.h_chunk_slots(8, 1024, H100_SMEM_BYTES) == 1


def test_byte_bits_reads_any_nonzero_byte(bits):
    """The card packs 16 bools a lane by gathering each 32-bit word's four
    nonzero bytes into four bits; a byte counts as present whatever its
    nonzero value, as the plain twins' bool cast reads it."""
    rng = np.random.default_rng(5)
    words = [0, 0xFFFFFFFF, 0x01010101, 0x80000000, 0x00800000, 0x00008000,
             0x00000080, 0x01000000, 0x00000100, 0x10204080]
    words += [int(x) for x in rng.integers(0, 1 << 32, 2000, dtype=np.uint64)]
    sparse = rng.integers(0, 256, (2000, 4)) * (rng.random((2000, 4)) < 0.5)
    words += [int.from_bytes(bytes(int(b) for b in row), "little") for row in sparse]
    for x in words:
        want = sum(1 << c for c in range(4) if (x >> (8 * c)) & 0xFF)
        assert bits.h_byte_bits(x) == want, hex(x)

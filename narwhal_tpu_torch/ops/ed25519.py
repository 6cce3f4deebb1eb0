"""Batched strict ed25519 verification: host prep, the plain PyTorch
verifier, the CUDA kernel's wrapper, and the ``cuda`` crypto backend.

The port of ``narwhal_tpu/ops/ed25519.py``.  The reference's per-round
crypto hot loop is `Signature::verify_batch` (crypto/src/lib.rs:206-219):
2f+1 ed25519 verifications per certificate × N certificates per round.
Here one batch is one launch of a hand-written CUDA kernel
(csrc/ed25519_verify.cu: four threads per signature, field elements as
10 limbs of 26 and 25 bits) that replaces the JAX program
``_verify_kernel``; beside it, :func:`verify_plain` is the JAX algorithm
in plain PyTorch (32 limbs of 8 bits, ops/field25519.py), which the
wrapper runs only for tensors on the CPU.

Verification semantics (strict, a superset of RFC 8032 rejections):
reject S ≥ L, non-canonical y (y ≥ p), encodings with no valid x or with
x = 0 and sign = 1, and small-order A or R ([8]P = identity, dalek
``verify_strict``); accept iff [S]B = R + [k]A with k = SHA-512(R ‖ A ‖ M)
mod L, checked as projective point equality.

SHA-512(R‖A‖M) and the scalar window decomposition run on the host during
batch prep (:func:`prepare_batch`, numpy); every field and curve
operation runs on the device.  A batch reaches the card through the
staged launcher (:func:`verify_sharded`): the prep copied into one pinned
buffer, one copy in, the launch and one copy of the mask out on a stream
of the shard's own.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import math
import threading
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .. import metrics
from ..utils.env import env_flag
from . import (
    check_launch,
    kernel_fn,
    ptr,
    require,
    resolve_device,
    stream_handle,
    warming,
)
from . import field25519 as F

P = F.P
L_ORDER = (1 << 252) + 27742317777372353535851937790883648493

D_INT = (-121665 * pow(121666, P - 2, P)) % P
SQRT_M1_INT = pow(2, (P - 1) // 4, P)

# Field multiplies (mul or square) one signature costs in the JAX
# algorithm, counted from the plain version's code; the verifier's bound
# in PERF.md counts these: two decompressions (275 each: 262 in pow_p58),
# two small-order checks (3 doublings of 8), the -A table (15 adds of 9),
# the ladder (64 × (4 doublings + 2 adds)) and the final projective
# compare.
FIELD_MULS_PER_VERIFY = 2 * 275 + 2 * 3 * 8 + 15 * 9 + 64 * (4 * 8 + 2 * 9) + 4
# Of those, the squares, which cost fewer limb products than a general
# multiply: 255 in each decompression (251 in pow_p58), 4 in each
# doubling of the small-order checks and of the ladder.
FIELD_SQS_PER_VERIFY = 2 * 255 + 2 * 3 * 4 + 64 * 4 * 4

# --------------------------------------------------------------- point ops
# A point is a tuple (X, Y, Z, T) of int32[..., 32] limbs with x = X/Z,
# y = Y/Z, T = XY/Z (extended homogeneous coordinates).

Point = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def identity_like(x: torch.Tensor) -> Point:
    zero = torch.zeros_like(x)
    one = F.const(1, x).expand_as(x)
    return (zero, one, one, zero)


def point_add(p: Point, q: Point) -> Point:
    """Unified add (add-2008-hwcd-3, a = -1)."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = F.mul(F.sub(y1, x1), F.sub(y2, x2))
    b = F.mul(F.add(y1, x1), F.add(y2, x2))
    c = F.mul(F.mul(t1, F.const((2 * D_INT) % P, t1)), t2)
    d = F.mul(F.add(z1, z1), z2)
    e = F.sub(b, a)
    f = F.sub(d, c)
    g = F.add(d, c)
    h = F.add(b, a)
    return (F.mul(e, f), F.mul(g, h), F.mul(f, g), F.mul(e, h))


def point_double(p: Point) -> Point:
    """dbl-2008-hwcd for a = -1."""
    x1, y1, z1, _ = p
    a = F.square(x1)
    b = F.square(y1)
    zz = F.square(z1)
    c = F.add(zz, zz)
    h = F.add(a, b)
    e = F.sub(h, F.square(F.add(x1, y1)))
    g = F.sub(a, b)
    f = F.add(c, g)
    return (F.mul(e, f), F.mul(g, h), F.mul(f, g), F.mul(e, h))


def point_neg(p: Point) -> Point:
    x, y, z, t = p
    return (F.neg(x), y, z, F.neg(t))


def point_eq(p: Point, q: Point) -> torch.Tensor:
    """Projective equality: X1·Z2 == X2·Z1 and Y1·Z2 == Y2·Z1."""
    x1, y1, z1, _ = p
    x2, y2, z2, _ = q
    return F.eq(F.mul(x1, z2), F.mul(x2, z1)) & F.eq(
        F.mul(y1, z2), F.mul(y2, z1)
    )


def is_identity(p: Point) -> torch.Tensor:
    x, y, z, _ = p
    return F.is_zero(x) & F.eq(y, z)


def is_small_order(p: Point) -> torch.Tensor:
    """[8]P == identity (the 8-torsion subgroup)."""
    return is_identity(point_double(point_double(point_double(p))))


def decompress(y: torch.Tensor, sign: torch.Tensor,
               y_canonical: torch.Tensor) -> Tuple[Point, torch.Tensor]:
    """Compressed Edwards y + sign bit → extended point and validity mask
    (RFC 8032 §5.1.3; non-canonical y is decided by the host prep)."""
    one = F.const(1, y).expand_as(y)
    yy = F.square(y)
    u = F.sub(yy, one)
    v = F.add(F.mul(yy, F.const(D_INT, y)), one)
    v3 = F.mul(F.square(v), v)
    v7 = F.mul(F.square(v3), v)
    x = F.mul(F.mul(u, v3), F.pow_p58(F.mul(u, v7)))
    vxx = F.mul(v, F.square(x))
    ok_direct = F.eq(vxx, u)
    ok_twist = F.eq(vxx, F.neg(u))
    x = F.select(ok_direct, x, F.mul(x, F.const(SQRT_M1_INT, x)))
    on_curve = ok_direct | ok_twist
    xc = F.canon(x)
    x_is_zero = (xc == 0).all(dim=-1)
    sign_ok = ~(x_is_zero & (sign == 1))
    flip = (xc[..., 0] % 2) != sign
    x = F.select(flip, F.neg(xc), xc)
    valid = on_curve & sign_ok & y_canonical
    return (x, y, one, F.mul(x, y)), valid


# ------------------------------------------------------- base point table


def _ref_scalarmult(k: int) -> Tuple[int, int]:
    """Host-side scalar mult with Python ints (table construction only)."""
    bx = 15112221349535400772501151409588531511454012693041857206046113283949847762202
    by = 46316835694926478169428394003475163141307993866256225615783033603165251855960

    def edwards_add(p, q):
        x1, y1 = p
        x2, y2 = q
        den = (D_INT * x1 * x2 * y1 * y2) % P
        x3 = (x1 * y2 + x2 * y1) * pow(1 + den, P - 2, P)
        y3 = (y1 * y2 + x1 * x2) * pow(1 - den, P - 2, P)
        return (x3 % P, y3 % P)

    q = (0, 1)
    b = (bx, by)
    while k > 0:
        if k & 1:
            q = edwards_add(q, b)
        b = edwards_add(b, b)
        k >>= 1
    return q


# j·B for j in 0..15 as (x, y, 1, xy) Python ints.
_B_TABLE_INTS = []
for _j in range(16):
    _x, _y = _ref_scalarmult(_j)
    _B_TABLE_INTS.append((_x, _y, 1, (_x * _y) % P))
_B_TABLE_NP = np.array(
    [[F.to_limbs(c) for c in row] for row in _B_TABLE_INTS], dtype=np.int32
)  # [16, 4, 32]


def _select(table: torch.Tensor, w: torch.Tensor) -> Point:
    """table [16, 4, 32] or [B, 16, 4, 32], w int[B] in [0, 16) → Point."""
    if table.dim() == 3:
        sel = table[w]
    else:
        sel = table[torch.arange(w.shape[0], device=w.device), w]
    return (sel[:, 0], sel[:, 1], sel[:, 2], sel[:, 3])


def verify_plain(a_y, a_sign, a_canon, r_y, r_sign, r_canon, s_windows,
                 s_ok, k_windows) -> torch.Tensor:
    """Plain PyTorch twin of the CUDA verifier: the JAX ``_verify_kernel``
    step for step, on the inputs' device.  Returns bool[B]."""
    a_point, a_valid = decompress(a_y, a_sign, a_canon)
    r_point, r_valid = decompress(r_y, r_sign, r_canon)
    small = is_small_order(a_point) | is_small_order(r_point)

    neg_a = point_neg(a_point)
    rows = [identity_like(a_y)]
    for _ in range(15):
        rows.append(point_add(rows[-1], neg_a))
    a_table = torch.stack([torch.stack(r, dim=-2) for r in rows], dim=-3)
    b_table = torch.from_numpy(_B_TABLE_NP).to(a_y.device)

    acc = identity_like(a_y)
    for i in range(64):
        acc = point_double(point_double(point_double(point_double(acc))))
        acc = point_add(acc, _select(b_table, s_windows[:, i].long()))
        acc = point_add(acc, _select(a_table, k_windows[:, i].long()))
    return a_valid & r_valid & ~small & s_ok & point_eq(acc, r_point)


# ----------------------------------------------------------- CUDA kernel


# The kernel's field element (csrc/field25519.cuh): 10 uint32 limbs of 26
# and 25 bits in turn (radix 2^25.5).
KERNEL_LIMB_BITS = (26, 25) * 5


def kernel_limbs(x: int) -> List[int]:
    """``x`` (< 2^255) as the kernel's 10 limbs, low limb first."""
    out, off = [], 0
    for w in KERNEL_LIMB_BITS:
        out.append((x >> off) & ((1 << w) - 1))
        off += w
    return out


def cuda_consts() -> np.ndarray:
    """``nt::Ed25519Consts`` (csrc/field25519.cuh) as uint32 words: d, 2d,
    sqrt(-1), then the base table j·B for j = 0..15 in the kernel's
    cached form, one coordinate per lane: y − x, y + x, 2d·x·y, 2 (Z = 1)."""
    words = kernel_limbs(D_INT) + kernel_limbs((2 * D_INT) % P) + kernel_limbs(SQRT_M1_INT)
    for x, y, _, t in _B_TABLE_INTS:
        for c in ((y - x) % P, (y + x) % P, 2 * D_INT * t % P, 2):
            words += kernel_limbs(c)
    return np.array(words, dtype=np.uint32)


_consts_loaded: set = set()
_consts_lock = threading.Lock()
_VP, _I = ctypes.c_void_p, ctypes.c_int


def _load_consts(device: torch.device) -> None:
    """Copy the curve constants into the kernel's constant memory, once
    per device."""
    with _consts_lock:
        if device.index in _consts_loaded:
            return
        fn = kernel_fn("nt_ed25519_set_consts", _VP)
        consts = cuda_consts()
        with torch.cuda.device(device):
            rc = fn(consts.ctypes.data_as(ctypes.c_void_p))
        if rc != 0:
            raise RuntimeError(f"nt_ed25519_set_consts failed: cudaError {rc}")
        _consts_loaded.add(device.index)


def verify_kernel(a_y, a_sign, a_canon, r_y, r_sign, r_canon, s_windows,
                  s_ok, k_windows) -> torch.Tensor:
    """The batched verifier on the inputs' device: the CUDA kernel for
    CUDA tensors (one launch), the plain version for CPU tensors.

    The k windows must hold a k < L, as ``prepare_batch`` makes them: the
    kernel recodes them into signed digits, which needs k's top window,
    plus the carry into it, below 8 (a k < L has a top window of at most
    1).  For a larger k the kernel's answer may differ from the plain
    version's."""
    if a_y.device.type == "cpu":
        return verify_plain(a_y, a_sign, a_canon, r_y, r_sign, r_canon,
                            s_windows, s_ok, k_windows)
    dev = a_y.device
    B = a_y.shape[0]
    for name, t, dtype, shape in (
        ("a_y", a_y, torch.int32, (B, 32)),
        ("a_sign", a_sign, torch.int32, (B,)),
        ("a_canon", a_canon, torch.bool, (B,)),
        ("r_y", r_y, torch.int32, (B, 32)),
        ("r_sign", r_sign, torch.int32, (B,)),
        ("r_canon", r_canon, torch.bool, (B,)),
        ("s_windows", s_windows, torch.int32, (B, 64)),
        ("s_ok", s_ok, torch.bool, (B,)),
        ("k_windows", k_windows, torch.int32, (B, 64)),
    ):
        require(t, dtype, shape, dev, f"ed25519_verify {name}")
    _load_consts(dev)
    out = torch.empty(B, dtype=torch.bool, device=dev)
    fn = kernel_fn("nt_ed25519_verify", *([_VP] * 10), _I, _VP)
    # The launch goes to the tensors' card, whichever card is current.
    with torch.cuda.device(dev):
        rc = fn(ptr(a_y), ptr(a_sign), ptr(a_canon), ptr(r_y), ptr(r_sign),
                ptr(r_canon), ptr(s_windows), ptr(s_ok), ptr(k_windows),
                ptr(out), B, ctypes.c_void_p(stream_handle(dev)))
    check_launch("ed25519_verify", rc)
    return out


# ------------------------------------------------------- the batch split
#
# The port of the reference's NARWHAL_VERIFY_MESH path (a shard_map of
# the verifier over a 1-D mesh of every visible device): the verifier is
# elementwise over the batch, so the split is one equal contiguous shard
# per card, each one launch of the verifier kernel on its own card.
#
# Every verify on the card, split or not, goes through the one launcher
# below, verify_sharded (row 8 of PERF.md, redesigned for Hopper); the
# single-card verify is its one-shard case.  A shard of S rows travels as
# the nine prep arrays packed into one uint8 buffer (stage_layout):
# pinned on the host, its twin on the card.  Per (card, shard slot) the
# launcher keeps both buffers, a pinned mask and a stream of its own for
# the process's life.  It enqueues every shard before it waits on any:
# the shard's copy into the pinned buffer, then on its stream one
# asynchronous copy in, the launch and one asynchronous copy of the mask
# out.  So two shards on one card run side by side (at B = 2048 the
# kernel takes one of an SM's six block slots), k cards use their copy
# engines and SMs at once, and a batch costs one copy each way and one
# wait, not nine pageable copies and a blocking fetch.  The copies move
# 779 bytes a row in and one byte out: at B = 2048 ~0.06 ms in on an
# H100 beside the kernel's ~0.48 ms (PERF.md, row 8), so what is left
# above the kernel is the host's fill and enqueue.


def mesh_devices() -> int:
    """How many cards a split verify would span: > 1 only when the
    NARWHAL_VERIFY_MESH flag is on and several CUDA devices are visible."""
    if not env_flag("NARWHAL_VERIFY_MESH") or not torch.cuda.is_available():
        return 1
    return torch.cuda.device_count()


# The nine prep arrays in the kernel's argument order: name, element
# type, shape of one row.
STAGED = (
    ("a_y", torch.int32, (32,)),
    ("a_sign", torch.int32, ()),
    ("a_canon", torch.bool, ()),
    ("r_y", torch.int32, (32,)),
    ("r_sign", torch.int32, ()),
    ("r_canon", torch.bool, ()),
    ("s_windows", torch.int32, (64,)),
    ("s_ok", torch.bool, ()),
    ("k_windows", torch.int32, (64,)),
)
# Each segment starts on a 16-byte boundary: an int32 view of a uint8
# slice needs an offset divisible by 4, and 16 keeps each segment's copy
# in whole sectors.
STAGE_ALIGN = 16


def _segment_bytes(rows: int, dtype, shape) -> int:
    return rows * dtype.itemsize * math.prod(shape)


def stage_layout(rows: int) -> Tuple[List[int], int]:
    """The byte offsets of the nine segments of a shard of ``rows`` rows
    in its staging buffer, in the kernel's argument order, and the
    buffer's size: 779 bytes a row, each segment rounded up to
    ``STAGE_ALIGN``."""
    offsets, end = [], 0
    for _, dtype, shape in STAGED:
        offsets.append(end)
        size = _segment_bytes(rows, dtype, shape)
        end += -(-size // STAGE_ALIGN) * STAGE_ALIGN
    return offsets, end


def stage_views(buf: torch.Tensor, rows: int) -> List[torch.Tensor]:
    """The nine arrays of a shard of ``rows`` rows as views of the uint8
    buffer ``buf`` (host or card), laid out by :func:`stage_layout`."""
    offsets, _ = stage_layout(rows)
    return [
        buf[off : off + _segment_bytes(rows, dtype, shape)]
        .view(dtype).view(rows, *shape)
        for off, (_, dtype, shape) in zip(offsets, STAGED)
    ]


def _copy_into(views, arrays) -> None:
    for dst, src in zip(views, arrays):
        np.copyto(dst, src)


class _Stage:
    """One shard slot's staging on one card, kept for the process's life:
    the pinned host buffer, its twin on the card (allocated under the
    slot's stream, so the caching allocator never hands it to another
    stream), the pinned mask, the stream, and four timing events (before
    the copy in, the launch and the copy out, and after it).  The buffers
    grow by doubling to the largest shard seen and never shrink, so
    ``cudaHostAlloc`` runs only when one grows.  ``lock`` is held from
    the host fill to the wait on the mask."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.lock = threading.Lock()
        self.stream = torch.cuda.Stream(device)
        self.events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        self.rows = 0
        self.host = self.card = self.mask = None
        self._views: Dict[int, tuple] = {}

    def views(self, rows: int) -> tuple:
        """(the host buffer's nine numpy views, the card buffer's nine
        tensor views, the staged range of each buffer) for a shard of
        ``rows`` rows, grown into first; made once per size and buffer
        (making them costs ~0.1 ms)."""
        if rows > self.rows:
            cap = max(1, self.rows)
            while cap < rows:
                cap <<= 1
            size = stage_layout(cap)[1]
            self.host = torch.empty(size, dtype=torch.uint8, pin_memory=True)
            self.mask = torch.empty(cap, dtype=torch.bool, pin_memory=True)
            with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
                self.card = torch.empty(size, dtype=torch.uint8, device=self.device)
            self.rows = cap
            self._views.clear()
        got = self._views.get(rows)
        if got is None:
            size = stage_layout(rows)[1]
            got = self._views[rows] = (
                [v.numpy() for v in stage_views(self.host, rows)],
                stage_views(self.card, rows),
                self.host[:size],
                self.card[:size],
            )
        return got


_stages: Dict[Tuple[int, int], _Stage] = {}
_stages_lock = threading.Lock()


def _stage(device: torch.device, slot: int) -> _Stage:
    with _stages_lock:
        st = _stages.get((device.index, slot))
        if st is None:
            st = _stages[(device.index, slot)] = _Stage(device)
        return st


def stage_shard(st: _Stage, part, rows: int) -> None:
    """One shard's nine arrays ``part`` through slot ``st``: copied into
    the pinned buffer, then, on the slot's stream, one asynchronous copy
    in, the launch and one asynchronous copy of the mask out, each
    between two of the slot's events."""
    host, card, host_range, card_range = st.views(rows)
    _copy_into(host, part)
    e_in, e_launch, e_out, e_done = st.events
    with torch.cuda.device(st.device), torch.cuda.stream(st.stream):
        e_in.record(st.stream)
        card_range.copy_(host_range, non_blocking=True)
        e_launch.record(st.stream)
        # verify_kernel launches on the current stream: this slot's.
        out = verify_kernel(*card)
        e_out.record(st.stream)
        st.mask[:rows].copy_(out, non_blocking=True)
        e_done.record(st.stream)


def verify_sharded(arrays, devices, on_kernel=None, report=None) -> np.ndarray:
    """The nine prep arrays (numpy or tensors, B rows) verified as
    ``len(devices)`` equal contiguous shards, shard k on ``devices[k]``
    (a device may repeat; its k-th use takes its k-th slot).  Every shard
    on a card is enqueued (:func:`stage_shard`) before any is waited on;
    a CPU shard is copied into a plain uint8 buffer laid out the same way
    and runs the plain twin.  ``on_kernel(seconds)`` gets each card
    shard's launch time (its events around the launch); ``report``, a
    list, gets one record per card shard.  Returns the bool[B] mask,
    shards concatenated in order."""
    shards = len(devices)
    B = int(arrays[0].shape[0])
    if shards < 1 or B % shards:
        raise ValueError(
            f"verify_sharded: {B} rows do not split into {shards} equal shards"
        )
    step = B // shards
    devices = [resolve_device(d) for d in devices]
    host = [a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
            for a in arrays]
    parts = [[a[k * step : (k + 1) * step] for a in host] for k in range(shards)]
    slots, used = [], {}
    for dev in devices:
        slots.append(used.get(dev, 0))
        used[dev] = slots[-1] + 1
    staged = [
        (k, _stage(dev, slot)) for k, (dev, slot) in enumerate(zip(devices, slots))
        if dev.type == "cuda"
    ]
    masks: List[np.ndarray] = [None] * shards
    with contextlib.ExitStack() as held:
        # One lock order for every caller: by card, then slot.
        for _, st in sorted(staged, key=lambda ks: (ks[1].device.index, slots[ks[0]])):
            held.enter_context(st.lock)
        for k, st in staged:
            stage_shard(st, parts[k], step)
        for k, dev in enumerate(devices):
            if dev.type == "cpu":
                views = stage_views(
                    torch.empty(stage_layout(step)[1], dtype=torch.uint8), step)
                _copy_into([v.numpy() for v in views], parts[k])
                masks[k] = verify_kernel(*views).numpy()
        for k, st in staged:
            e_in, e_launch, e_out, e_done = st.events
            e_done.synchronize()
            masks[k] = st.mask[:step].numpy().copy()
            if on_kernel is not None:
                on_kernel(e_launch.elapsed_time(e_out) / 1000)
            if report is not None:
                report.append(dict(
                    shard=k, device=str(st.device), slot=slots[k],
                    stream=st.stream.cuda_stream, pinned=st.host.is_pinned(),
                    copy_in_ms=e_in.elapsed_time(e_launch),
                    kernel_ms=e_launch.elapsed_time(e_out),
                    copy_out_ms=e_out.elapsed_time(e_done),
                ))
    return np.concatenate(masks)


# ----------------------------------------------------------- host-side prep
#
# Fully vectorized with numpy: bytes → bit matrix → 8-bit limbs / 4-bit
# windows via one matmul each.  Only SHA-512 (hashlib) and the 512 → mod-L
# reduction touch Python objects per signature.

_NIBBLE_W = np.array([1, 2, 4, 8], dtype=np.int32)
_LIMB_W = (1 << np.arange(F.BITS, dtype=np.int32)).astype(np.int32)
_P_BYTES_BE = np.frombuffer(P.to_bytes(32, "big"), np.uint8)
_L_BYTES_BE = np.frombuffer(L_ORDER.to_bytes(32, "big"), np.uint8)


def _bits_le(raw: np.ndarray) -> np.ndarray:
    """uint8[B, 32] → bit matrix bool[B, 256], bit i = value bit i."""
    return np.unpackbits(raw, axis=1, bitorder="little")


def _field_limbs(bits: np.ndarray) -> np.ndarray:
    """bit matrix [B, 256] (low 255 bits used) → int32[B, 32] limbs."""
    pad = F.LIMBS * F.BITS - 255
    padded = np.concatenate(
        [bits[:, :255], np.zeros((bits.shape[0], pad), bits.dtype)], axis=1
    )
    return padded.reshape(-1, F.LIMBS, F.BITS).astype(np.int32) @ _LIMB_W


def _msb_windows(bits: np.ndarray) -> np.ndarray:
    """bit matrix [B, 256] → int32[B, 64] 4-bit windows, MSB-first."""
    nib = bits.reshape(-1, 64, 4).astype(np.int32) @ _NIBBLE_W
    return nib[:, ::-1]


def _lt_be(raw_le: np.ndarray, bound_be: np.ndarray) -> np.ndarray:
    """value(raw little-endian bytes) < bound, vectorized per row."""
    be = raw_le[:, ::-1]
    diff = be.astype(np.int16) - bound_be.astype(np.int16)
    nz = diff != 0
    first = np.argmax(nz, axis=1)  # first (most significant) differing byte
    any_nz = nz.any(axis=1)
    picked = diff[np.arange(len(diff)), first]
    return np.where(any_nz, picked < 0, False)


def prepare_batch(
    messages: Sequence[bytes],
    keys: Sequence[bytes],
    sigs: Sequence[bytes],
    pad_to: int,
):
    """Host prep: unpack encodings, hash-to-scalar, window-decompose.
    Returns the nine arrays the verifier takes, zero-padded to
    ``pad_to`` rows."""
    n = len(messages)

    def rows(chunks) -> np.ndarray:
        out = np.zeros((pad_to, 32), np.uint8)
        if n:
            out[:n] = np.frombuffer(b"".join(chunks), np.uint8).reshape(n, 32)
        return out

    sig_bytes = [bytes(s) for s in sigs]
    key_bytes = [bytes(k) for k in keys]
    # Fail loud on malformed lengths: the join+reshape below would
    # otherwise silently misalign rows.
    if any(len(k) != 32 for k in key_bytes):
        raise ValueError("prepare_batch: every key must be 32 bytes")
    if any(len(s) != 64 for s in sig_bytes):
        raise ValueError("prepare_batch: every signature must be 64 bytes")
    akeys = rows(key_bytes)
    r_raw = rows(s[:32] for s in sig_bytes)
    s_raw = rows(s[32:64] for s in sig_bytes)
    kb = bytearray()
    for akey, sig, msg in zip(key_bytes, sig_bytes, messages):
        k = int.from_bytes(
            hashlib.sha512(sig[:32] + akey + bytes(msg)).digest(), "little"
        ) % L_ORDER
        kb += k.to_bytes(32, "little")
    k_raw = rows((kb,))

    a_bits = _bits_le(akeys)
    r_bits = _bits_le(r_raw)
    s_bits = _bits_le(s_raw)
    k_bits = _bits_le(k_raw)
    # Mask the sign bit off the y-field before the canonicality compare.
    a_field = akeys.copy()
    a_field[:, 31] &= 0x7F
    r_field = r_raw.copy()
    r_field[:, 31] &= 0x7F
    return (
        _field_limbs(a_bits),
        a_bits[:, 255].astype(np.int32),
        _lt_be(a_field, _P_BYTES_BE),
        _field_limbs(r_bits),
        r_bits[:, 255].astype(np.int32),
        _lt_be(r_field, _P_BYTES_BE),
        _msb_windows(s_bits),
        _lt_be(s_raw, _L_BYTES_BE),
        _msb_windows(k_bits),
    )


def pad_size(n: int, floor: int = 16) -> int:
    """The padded batch: ``floor`` doubled until it holds ``n`` rows, as
    in the reference (a power of two ≥ 16 on one device)."""
    pad = floor
    while pad < n:
        pad <<= 1
    return pad


def to_device(arrays, device) -> List[torch.Tensor]:
    """The nine prep arrays (numpy or tensors) as contiguous tensors on
    ``device``, for callers that want nine tensors; the verify path
    stages them instead (:func:`verify_sharded`)."""
    return [
        (a if torch.is_tensor(a) else torch.from_numpy(np.ascontiguousarray(a)))
        .to(device).contiguous()
        for a in arrays
    ]


def verify_batch_arrays(messages, keys, sigs, device=None,
                        on_kernel=None) -> np.ndarray:
    """Bool mask for a batch of (message, key, signature) triples: host
    prep, then :func:`verify_sharded` with one shard on ``device`` (None
    → the GPU): one staged copy in, one launch, the mask back.  With
    ``device`` None, NARWHAL_VERIFY_MESH on and several cards visible,
    the padded batch (floor raised to 16 × cards) is split into one shard
    a card.  ``on_kernel(seconds)``, when given, receives each launch's
    time on the card (CUDA events around it, so a wait for another
    process's kernels counts)."""
    n = len(messages)
    if n == 0:
        return np.zeros(0, dtype=bool)
    n_dev = mesh_devices() if device is None else 1
    if n_dev > 1:
        devices = [torch.device("cuda", k) for k in range(n_dev)]
    else:
        devices = [resolve_device(device)]
    # The floor of 16 × cards makes every pad a multiple of the card count.
    pad = pad_size(n, floor=16 * n_dev)
    arrays = prepare_batch(messages, keys, sigs, pad)
    return verify_sharded(arrays, devices, on_kernel)[:n]


# The verify launch's own time on the card for each batch the backend
# verifies (on a node, a Core burst), from CUDA events around it: the
# per-process figure beside crypto.verify.device_seconds, which also
# holds host prep and the copies.  Warm-ups are not timed.
_m_kernel_seconds = metrics.histogram("crypto.verify.kernel_seconds")


class CudaBackend:
    """crypto.backend-compatible verification backend (see
    narwhal_tpu_torch/crypto/backend.py) on ``device``.  Construction
    resolves the device and, for the GPU, builds and loads the kernel
    library — so a broken toolchain fails at backend selection.  A
    backend made with ``device`` None verifies as ``verify_batch_arrays``
    does with no device: on the current card, or split over every card
    when NARWHAL_VERIFY_MESH is on and several are visible."""

    name = "cuda"

    def __init__(self, device=None) -> None:
        self._asked = device  # None lets the mesh flag split a batch
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            _load_consts(self.device)
        # One dedicated dispatch thread: keeps device calls ordered, and
        # run_in_executor from the event loop never blocks it for the
        # device round trip (host prep + launch + result copy all happen
        # on this thread; numpy/hashlib/torch release the GIL for the bulk).
        from concurrent.futures import ThreadPoolExecutor

        self._executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="cuda-verify"
        )

    def verify(self, message: bytes, key, sig) -> bool:
        return bool(self.verify_batch_mask([message], [key], [sig])[0])

    def verify_batch_mask(
        self, messages: Sequence[bytes], keys, sigs
    ) -> List[bool]:
        return [
            bool(x)
            for x in verify_batch_arrays(
                messages, keys, sigs, self._asked, _m_kernel_seconds.observe
            )
        ]

    async def averify_batch_mask(
        self, messages: Sequence[bytes], keys, sigs
    ) -> List[bool]:
        mask, _ = await self.averify_batch_mask_timed(messages, keys, sigs)
        return mask

    async def averify_batch_mask_timed(
        self, messages: Sequence[bytes], keys, sigs
    ) -> Tuple[List[bool], float]:
        """(mask, compute_seconds): compute time is measured ON the
        dispatch thread around host prep + device round trip — the wall
        the caller observes additionally includes executor queueing and
        the event-loop wakeup (the `crypto.verify.device_seconds` split)."""
        import asyncio
        import time

        def timed() -> Tuple[List[bool], float]:
            t0 = time.perf_counter()
            mask = self.verify_batch_mask(messages, keys, sigs)
            return mask, time.perf_counter() - t0

        job = asyncio.get_running_loop().run_in_executor(self._executor, timed)
        try:
            return await asyncio.shield(job)
        except asyncio.CancelledError:
            # A burst already handed to the dispatch thread runs to its
            # end there anyway: the caller's cancellation completes only
            # after it, so a snapshot taken once the node has shut down
            # holds its launch's count and its timing together.
            await asyncio.wait([job])
            raise

    def warmup(
        self, shapes: Sequence[int] = None, max_claims: int = None
    ) -> None:
        """Run the verifier once at every padded batch shape a live node
        will hit (up to ``max_claims``, default 64), so the first real
        burst pays no first-launch cost (the library build, the constant
        upload, the staging buffers' growth to the top pad) on the
        critical path.  Explicit ``shapes`` override.  The launches count
        as warm-ups (:func:`warming`)."""
        if shapes is None:
            top = 64 if max_claims is None else max(16, max_claims)
            shapes, pad = [], 16
            while True:
                shapes.append(pad)
                if pad >= top:
                    break
                pad <<= 1
        from ..crypto import KeyPair
        from ..crypto.digest import Digest

        kp = KeyPair.generate()
        msg = bytes(Digest(b"\x05" * 32))
        sig = kp.sign(Digest(msg))
        with warming():
            for n in shapes:
                verify_batch_arrays(
                    [msg] * n, [kp.name] * n, [sig] * n, self._asked
                )

"""ctypes bindings for the native data plane (native/dataplane.c), with a
pure-Python fallback so the protocol stack still runs where no C toolchain
exists.

The native library owns every per-transaction step of the worker hot path
(reference worker/src/batch_maker.rs:71-156): splitting the length-prefixed
tx stream, accumulating the batch body in wire encoding, sample-id scan, and
sealing the WorkerMessage::Batch.  Python code observes batches, never
transactions.

``ensure_built()`` compiles the library on first use (one ``make`` in
native/); the build is cached by mtime.
"""

from __future__ import annotations

import ctypes
import logging
import os
import struct
import subprocess
import threading
from typing import List, Optional, Tuple

log = logging.getLogger("narwhal.native")

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_DIR = os.path.join(_REPO, "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libnarwhal_dp.so")
_SRC_PATH = os.path.join(_NATIVE_DIR, "dataplane.c")

_lib = None
_lib_lock = threading.Lock()
_build_attempted = False


def ensure_built() -> bool:
    """Build the native library if missing/stale. Returns availability.
    A stale library is never used: if the rebuild fails, we fall back to
    the Python twin rather than dlopen an ABI that may no longer match
    the ctypes signatures."""
    global _build_attempted
    if not os.path.exists(_SRC_PATH):
        return False

    def fresh() -> bool:
        return (
            os.path.exists(_LIB_PATH)
            and os.path.getmtime(_LIB_PATH) >= os.path.getmtime(_SRC_PATH)
        )

    if fresh():
        return True
    if _build_attempted:
        return False
    _build_attempted = True
    try:
        # Cross-process lock: the bench harness spawns many nodes at once
        # and they must not run `make` over the same output concurrently
        # (the Makefile also builds via tmp + atomic rename).
        import fcntl

        with open(os.path.join(_NATIVE_DIR, ".build.lock"), "w") as lockf:
            fcntl.flock(lockf, fcntl.LOCK_EX)
            if not fresh():
                subprocess.run(
                    ["make", "-s"], cwd=_NATIVE_DIR, check=True,
                    capture_output=True, timeout=120,
                )
        return fresh()
    except (subprocess.SubprocessError, OSError) as e:
        log.warning("native data plane build failed, using Python fallback: %s", e)
        return False


def _load():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if not ensure_built():
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError as e:
            # Present but unloadable (wrong arch, truncated, ABI drift): the
            # Python twin keeps the stack running, as documented.
            log.warning("cannot load %s (%s); using Python fallback",
                        _LIB_PATH, e)
            return None
        lib.dp_batcher_new.restype = ctypes.c_void_p
        lib.dp_batcher_new.argtypes = [ctypes.c_uint32]
        lib.dp_batcher_free.argtypes = [ctypes.c_void_p]
        lib.dp_batcher_tx_bytes.restype = ctypes.c_uint32
        lib.dp_batcher_tx_bytes.argtypes = [ctypes.c_void_p]
        lib.dp_batcher_tx_count.restype = ctypes.c_uint32
        lib.dp_batcher_tx_count.argtypes = [ctypes.c_void_p]
        lib.dp_batcher_ready.restype = ctypes.c_int
        lib.dp_batcher_ready.argtypes = [ctypes.c_void_p]
        lib.dp_batcher_sealed_size.restype = ctypes.c_uint32
        lib.dp_batcher_sealed_size.argtypes = [ctypes.c_void_p]
        lib.dp_batcher_seal.restype = ctypes.c_int64
        lib.dp_batcher_seal.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p, ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint32),
        ]
        lib.dp_validate_batch.restype = ctypes.c_int64
        lib.dp_validate_batch.argtypes = [ctypes.c_char_p, ctypes.c_uint32]
        lib.dp_framer_new.restype = ctypes.c_void_p
        lib.dp_framer_new.argtypes = []
        lib.dp_framer_free.argtypes = [ctypes.c_void_p]
        lib.dp_framer_feed.restype = ctypes.c_int
        lib.dp_framer_feed.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32,
        ]
        _lib = lib
        return _lib


class SealedBatch:
    """One sealed WorkerMessage::Batch plus its benchmark metadata."""

    __slots__ = ("message", "tx_count", "tx_bytes", "samples")

    def __init__(self, message: bytes, tx_count: int, tx_bytes: int,
                 samples: List[int]) -> None:
        self.message = message
        self.tx_count = tx_count
        self.tx_bytes = tx_bytes
        self.samples = samples


class _NativeBatcher:
    def __init__(self, lib, batch_size: int) -> None:
        self._lib = lib
        self._ptr = lib.dp_batcher_new(batch_size)
        if not self._ptr:
            raise MemoryError("dp_batcher_new failed")

    def __del__(self):
        if getattr(self, "_ptr", None):
            self._lib.dp_batcher_free(self._ptr)
            self._ptr = None

    @property
    def tx_bytes(self) -> int:
        return self._lib.dp_batcher_tx_bytes(self._ptr)

    @property
    def tx_count(self) -> int:
        return self._lib.dp_batcher_tx_count(self._ptr)

    def ready(self) -> bool:
        return bool(self._lib.dp_batcher_ready(self._ptr))

    def seal(self) -> Optional[SealedBatch]:
        lib = self._lib
        cap = lib.dp_batcher_sealed_size(self._ptr)
        n_tx = lib.dp_batcher_tx_count(self._ptr)
        out = ctypes.create_string_buffer(max(cap, 16))
        samples = (ctypes.c_uint64 * max(n_tx, 1))()
        n_samples = ctypes.c_uint32()
        n_txs = ctypes.c_uint32()
        tx_bytes = ctypes.c_uint32()
        n = lib.dp_batcher_seal(
            self._ptr, out, cap, samples, n_tx,
            ctypes.byref(n_samples), ctypes.byref(n_txs),
            ctypes.byref(tx_bytes),
        )
        if n == 0:
            return None
        if n < 0:
            raise RuntimeError("dp_batcher_seal: capacity error")
        return SealedBatch(
            out.raw[: int(n)],
            int(n_txs.value),
            int(tx_bytes.value),
            list(samples[: n_samples.value]),
        )


class _NativeFramer:
    def __init__(self, lib) -> None:
        self._lib = lib
        self._ptr = lib.dp_framer_new()
        if not self._ptr:
            raise MemoryError("dp_framer_new failed")

    def __del__(self):
        if getattr(self, "_ptr", None):
            self._lib.dp_framer_free(self._ptr)
            self._ptr = None

    def feed(self, batcher: _NativeBatcher, data: bytes) -> bool:
        """Feed a chunk; True means the batcher hit its seal threshold and
        bytes may remain — seal, then call ``feed(batcher, b"")`` to drain."""
        rc = self._lib.dp_framer_feed(self._ptr, batcher._ptr, data, len(data))
        if rc < 0:
            raise ValueError("malformed tx stream (oversized frame?)")
        return rc == 1


# ------------------------------------------------------------- Python twin

from .network.framing import MAX_FRAME as _MAX_FRAME  # single source of truth

_U32 = struct.Struct("<I")


class _PyBatcher:
    def __init__(self, batch_size: int) -> None:
        self.batch_size = batch_size
        self._body = bytearray()
        self.tx_count = 0
        self.tx_bytes = 0
        self._samples: List[int] = []

    def _push(self, tx) -> None:
        self._body += _U32.pack(len(tx)) + tx
        self.tx_count += 1
        self.tx_bytes += len(tx)
        if len(tx) >= 9 and tx[0] == 0:
            self._samples.append(int.from_bytes(tx[1:9], "little"))

    def ready(self) -> bool:
        return self.tx_bytes >= self.batch_size

    def seal(self) -> Optional[SealedBatch]:
        if self.tx_count == 0:
            return None
        msg = b"\x00" + _U32.pack(self.tx_count) + bytes(self._body)
        sealed = SealedBatch(msg, self.tx_count, self.tx_bytes, self._samples)
        self._body = bytearray()
        self.tx_count = 0
        self.tx_bytes = 0
        self._samples = []
        return sealed


class _PyFramer:
    def __init__(self) -> None:
        self._pend = b""

    def feed(self, batcher: _PyBatcher, data: bytes) -> bool:
        buf = self._pend + data if self._pend else data
        pos, n = 0, len(buf)
        ready = False
        while n - pos >= 4:
            if batcher.ready():
                ready = True
                break
            (flen,) = _U32.unpack_from(buf, pos)
            if flen > _MAX_FRAME:
                raise ValueError("malformed tx stream (oversized frame)")
            if n - pos - 4 < flen:
                break
            batcher._push(buf[pos + 4 : pos + 4 + flen])
            pos += 4 + flen
        self._pend = buf[pos:]
        return ready or batcher.ready()


def validate_batch(message: bytes) -> int:
    """Structural check of a serialized WorkerMessage::Batch without
    decoding: returns the tx count, or -1 if malformed.  C-backed when the
    native library is available; pure length-prefix walk otherwise."""
    lib = _load()
    if lib is not None:
        return int(lib.dp_validate_batch(message, len(message)))
    if len(message) < 5 or message[0] != 0:
        return -1
    (count,) = _U32.unpack_from(message, 1)
    pos, n = 5, len(message)
    for _ in range(count):
        if n - pos < 4:
            return -1
        (flen,) = _U32.unpack_from(message, pos)
        if flen > _MAX_FRAME or n - pos - 4 < flen:
            return -1
        pos += 4 + flen
    return count if pos == n else -1


# ------------------------------------------------------------- public API


def make_batcher(batch_size: int):
    lib = _load()
    if lib is not None:
        return _NativeBatcher(lib, batch_size)
    return _PyBatcher(batch_size)


def make_framer(for_batcher):
    if isinstance(for_batcher, _NativeBatcher):
        return _NativeFramer(for_batcher._lib)
    return _PyFramer()


def native_available() -> bool:
    return _load() is not None

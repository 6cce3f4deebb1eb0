"""The port's device plane: device resolution, the CUDA kernel library,
and per-kernel launch counts.

Takes the place of the reference's XLA compilation-cache setup
(``narwhal_tpu/ops/__init__.py``).  Every kernel of the port is
hand-written CUDA C++ under ``narwhal_tpu_torch/csrc/``, compiled for
Hopper (``sm_90a``) on first use by ``torch.utils.cpp_extension.load``
into ``build/narwhal_tpu_torch/`` beside the package, and called through
a plain C interface with ``ctypes`` (the sources include no PyTorch
header, which keeps the build to seconds).

Every entry point takes an explicit ``device``: ``None`` means the GPU,
and a missing GPU raises unless the caller asked for ``"cpu"``, where
each wrapper runs its kernel's plain PyTorch twin.  Nothing here falls
back quietly: a build or launch failure raises.

Import is deferred by callers (crypto.backend, consensus) so the pure-CPU
protocol path never pays the torch import cost.
"""

from __future__ import annotations

import contextlib
import ctypes
import glob
import os
import threading
import time
from typing import Dict, Optional

import torch

from .. import metrics

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "narwhal_tpu_torch")
CUDA_FLAGS = ("-O3", "-gencode=arch=compute_90a,code=sm_90a")

# Launch counts, one per kernel: a wrapper adds one where it launches its
# kernel on the card and nowhere else (the plain CPU twin never counts).
LAUNCHES: Dict[str, int] = {
    "ed25519_verify": 0,
    "window_update": 0,
    "leader_commit_scan": 0,
    "leader_chain_scan": 0,
    "causal_mask_scan": 0,
    "support_stake": 0,
    "commit_step": 0,
    "commit_step_block": 0,
}


# The same counts in the metrics registry, so that a node's snapshot
# carries its process's launches: ``kernel.launches.<name>``, and apart
# from them ``kernel.warmup_launches.<name>`` for those made inside
# :func:`warming` (a boot's warm-ups, on the thread that runs them).
_m_launches = {n: metrics.counter(f"kernel.launches.{n}") for n in LAUNCHES}
_m_warmup_launches = {
    n: metrics.counter(f"kernel.warmup_launches.{n}") for n in LAUNCHES
}
_warming = threading.local()
_capture = threading.local()

# Two phases of a node's boot, in its process's registry: the kernel
# library's load (its build too, on a checkout's first run) and the CUDA
# context (:func:`open_context`), each timed where the process first
# needs it.
_m_boot_library = metrics.gauge("node.boot.library_seconds")
_m_boot_context = metrics.gauge("node.boot.cuda_context_seconds")
_contexts: Dict[int, float] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@contextlib.contextmanager
def warming():
    """Count the launches this thread makes inside the block as warm-ups
    in the metrics registry (``LAUNCHES`` counts them as any other)."""
    outer = getattr(_warming, "on", False)
    _warming.on = True
    try:
        yield
    finally:
        _warming.on = outer


@contextlib.contextmanager
def capturing():
    """Tally, by kernel, the launches this thread captures into a CUDA
    graph inside the block: they run, and are counted
    (:func:`count_launches`), only when the graph replays."""
    outer = getattr(_capture, "tally", None)
    _capture.tally = tally = dict.fromkeys(LAUNCHES, 0)
    try:
        yield tally
    finally:
        _capture.tally = outer

def resolve_device(device=None) -> torch.device:
    """``None`` → the GPU.  Raises when the GPU is asked for and absent:
    the CPU path is taken only when the caller names it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "narwhal_tpu_torch: no CUDA device is available; pass "
                "device='cpu' to run the plain PyTorch versions"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"narwhal_tpu_torch: unsupported device {dev}")
    return dev


def open_context(device: torch.device) -> None:
    """Make this process's CUDA context on ``device`` now, where its first
    copy or launch would make it anyway, and time it
    (``node.boot.cuda_context_seconds``); once a card."""
    if device.index in _contexts:
        return
    t = time.perf_counter()
    torch.cuda.synchronize(device)
    _contexts[device.index] = time.perf_counter() - t
    _m_boot_context.set(sum(_contexts.values()))


_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def build_library() -> str:
    """Compile every ``csrc/*.cu`` into one shared library (cached by
    content under BUILD_DIR); returns its path.  Raises on any failure."""
    from torch.utils.cpp_extension import load

    os.makedirs(BUILD_DIR, exist_ok=True)
    return load(
        name="narwhal_tpu_torch_kernels",
        sources=sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu"))),
        extra_include_paths=[CSRC_DIR],
        extra_cuda_cflags=list(CUDA_FLAGS),
        build_directory=BUILD_DIR,
        is_python_module=False,
    )


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            t = time.perf_counter()
            _lib = ctypes.CDLL(build_library())
            _m_boot_library.set(time.perf_counter() - t)
        return _lib


_fns: Dict[str, ctypes._CFuncPtr] = {}


def kernel_fn(symbol: str, *argtypes):
    """A C entry point of the kernel library with its argument types set.
    Every entry point returns the ``cudaError_t`` of its launch."""
    fn = _fns.get(symbol)
    if fn is None:
        fn = getattr(library(), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


def check_launch(name: str, rc: int) -> None:
    """Raise on a failed launch, else count it; a launch captured into a
    CUDA graph goes to the tally of the enclosing :func:`capturing` block
    instead, and one captured outside such a block raises."""
    if rc != 0:
        raise RuntimeError(
            f"narwhal_tpu_torch: launch of {name} failed with cudaError {rc}"
        )
    if not (torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()):
        count_launches(name, 1)
        return
    tally = getattr(_capture, "tally", None)
    if tally is None:
        raise RuntimeError(
            f"narwhal_tpu_torch: launch of {name} captured outside ops.capturing()"
        )
    tally[name] += 1


def count_launches(name: str, n: int) -> None:
    LAUNCHES[name] += n
    warm = getattr(_warming, "on", False)
    (_m_warmup_launches if warm else _m_launches)[name].inc(n)


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def require(t: torch.Tensor, dtype, shape, device, name: str) -> None:
    """Validate what a kernel takes: device, dtype, exact shape, layout."""
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name}: want {dtype} {tuple(shape)} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")

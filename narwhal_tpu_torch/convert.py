"""Carrying state across from the JAX package (``narwhal_tpu``) to the port.

Only data crosses: the port imports nothing of the JAX package.
:func:`window_from_numpy` loads a JAX ``KernelTusk`` device window
(``np.asarray(k._dev_exists)``, ``np.asarray(k._dev_parent)``) as the
port's int32 window tensors on ``device``.  Everything else crosses
through the formats the two packages already share, with no converter:
the committee through its JSON (``Committee.to_json`` →
``Committee.from_json``), certificates through their wire bytes
(``Certificate.serialize`` → ``Certificate.deserialize``, under the same
wire format and wire committee), and consensus checkpoints through
``State.snapshot_bytes`` → ``State.restore``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .ops import resolve_device


def window_from_numpy(exists, parent, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's presence-count window ``exists[W, N]`` and
    ``parent[W, N, N]`` as contiguous int32 tensors on ``device``."""
    exists = np.asarray(exists)
    parent = np.asarray(parent)
    if exists.ndim != 2 or parent.shape != exists.shape + exists.shape[1:]:
        raise ValueError(
            f"window_from_numpy: want exists [W, N] and parent [W, N, N], "
            f"got {exists.shape} and {parent.shape}"
        )
    dev = resolve_device(device)

    def load(a: np.ndarray) -> torch.Tensor:
        if not np.issubdtype(a.dtype, np.integer) and a.dtype != bool:
            raise ValueError(f"window_from_numpy: integer counts expected, got {a.dtype}")
        return torch.from_numpy(np.array(a, dtype=np.int32)).to(dev)  # a copy

    return load(exists), load(parent)


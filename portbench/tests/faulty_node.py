"""The port's node CLI with one fault planted underneath, for the tests
that show the judge finds it (``PORTBENCH_FAULT`` names it):

- ``stale_step``: once the consensus has committed, each later commit
  hands out its previous sequence again (a step that returns its state
  unchanged);
- ``half_batch``: a worker stores each batch with half of its
  transactions left out, under the digest of the whole batch;
- ``altered_sample``: a worker stores each batch with the last byte of
  every sample transaction altered;
- ``stall``: from the window's start on (``loadgen-start.json`` in the
  run's work directory), the consensus hands out no more commits.

    python3 -m portbench.tests.faulty_node <the node CLI's arguments>
"""

from __future__ import annotations

import json
import os
import sys
import time

from portbench.reference import wire


def _stale_step() -> None:
    from narwhal_tpu_torch.ops.reachability import KernelTusk

    real = KernelTusk.process_certificate
    last = []

    def process_certificate(self, certificate):
        out = real(self, certificate)
        if out and last:
            return list(last)
        if out:
            last[:] = out
        return out

    KernelTusk.process_certificate = process_certificate


def _stall() -> None:
    from narwhal_tpu_torch.ops.reachability import KernelTusk

    real = KernelTusk.process_certificate
    store = sys.argv[sys.argv.index("--store") + 1]
    start = os.path.join(os.path.dirname(store), "loadgen-start.json")
    at = []

    def process_certificate(self, certificate):
        out = real(self, certificate)
        if not at and os.path.exists(start):
            with open(start) as f:
                at.append(json.load(f)["window"][0])
        return [] if at and time.time() >= at[0] else out

    KernelTusk.process_certificate = process_certificate


def _batch_fault(alter) -> None:
    from narwhal_tpu_torch.store import Store

    real = Store.write

    def write(self, key, value):
        if len(key) == 32 and value[:1] == b"\x00":
            try:
                value = wire.encode_batch(alter(wire.decode_batch(bytes(value))))
            except ValueError:
                pass
        return real(self, key, value)

    Store.write = write


def _half(txs):
    return txs[: max(1, len(txs) // 2)]


def _altered(txs):
    return [tx[:-1] + bytes([tx[-1] ^ 1]) if wire.sample_id(tx) is not None else tx
            for tx in txs]


FAULTS = {
    "stale_step": _stale_step,
    "half_batch": lambda: _batch_fault(_half),
    "altered_sample": lambda: _batch_fault(_altered),
    "stall": _stall,
}


def main() -> int:
    FAULTS[os.environ["PORTBENCH_FAULT"]]()
    from narwhal_tpu_torch.node.main import main as node_main

    return node_main(sys.argv[1:])


if __name__ == "__main__":
    sys.exit(main())

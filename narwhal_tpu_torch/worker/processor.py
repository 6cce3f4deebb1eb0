"""Processor: hash, persist and report each batch.

Reference worker/src/processor.rs (57 LoC): SHA-512/32B digest of the
serialized batch (line 35 — the per-batch hot loop), write `digest → batch`
to the store, emit OurBatch/OthersBatch(digest, worker_id) toward the
primary.  Spawned twice: once for our sealed batches, once for batches
received from other workers.
"""

from __future__ import annotations

import asyncio
import logging

from .. import metrics
from ..config import WorkerId
from ..crypto import digest32
from ..messages import encode_batch_digest
from ..utils.env import env_flag

log = logging.getLogger("narwhal.worker")
_TRACE = env_flag("NARWHAL_TRACE")


class Processor:
    def __init__(
        self,
        worker_id: WorkerId,
        store,
        in_queue: asyncio.Queue,  # serialized batches
        out_queue: asyncio.Queue,  # → PrimaryConnector: encoded digest message
        own_digests: bool,
    ) -> None:
        self.worker_id = worker_id
        self.store = store
        self.in_queue = in_queue
        self.out_queue = out_queue
        self.own_digests = own_digests
        self._m_duplicates = metrics.counter("worker.duplicate_batches")

    async def run(self) -> None:
        while True:
            item = await self.in_queue.get()
            if isinstance(item, tuple):
                # Own batches arrive with their digest already computed at
                # seal time (batch_maker.py) — no second 500 kB hash.
                digest, serialized = item
            else:
                serialized = item
                digest = digest32(serialized)
            if not self.own_digests and self.store.read(bytes(digest)) is not None:
                # Re-delivered batch (helpful peers re-send during sync
                # storms, and escalated BatchRequests fan out to several
                # holders): the first delivery already persisted it and
                # reported the digest, so a second store append + digest
                # message would only grow the log and the primary's queue.
                # Own sealed batches are exempt — they arrive over no
                # network, and a (rare) byte-identical re-seal still owes
                # the proposer its digest.
                self._m_duplicates.inc()
                continue
            self.store.write(bytes(digest), serialized)
            if _TRACE:
                log.info("TRACE processed %r own=%s", digest, self.own_digests)
            await self.out_queue.put(
                encode_batch_digest(digest, self.worker_id, self.own_digests)
            )

"""PayloadReceiver: record which batches our workers hold for other authors.

Reference primary/src/payload_receiver.rs (29 LoC): write a
(digest ‖ worker_id) → ∅ marker so header validation can check payload
availability (see synchronizer.payload_key for the attack this prevents).
"""

from __future__ import annotations

import asyncio

from ..store import Store
from .synchronizer import payload_key


class PayloadReceiver:
    def __init__(self, store: Store, rx_workers: asyncio.Queue) -> None:
        self.store = store
        self.rx_workers = rx_workers

    async def run(self) -> None:
        while True:
            digest, worker_id = await self.rx_workers.get()
            self.store.write(payload_key(digest, worker_id), b"")

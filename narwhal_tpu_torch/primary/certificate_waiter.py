"""CertificateWaiter: park certificates until all their parents are stored.

Reference primary/src/certificate_waiter.rs (86 LoC): try_join_all of
notify_read over the parents, then loop the certificate back to the Core.
No network side — the HeaderWaiter does the fetching (the embedded header's
processing triggers it).
"""

from __future__ import annotations

import asyncio
import logging
from typing import Dict, Tuple

from .. import metrics
from ..crypto import Digest
from ..messages import Round
from ..store import Store
from .core import AtomicRound
from .messages import Certificate
from ..utils.tasks import spawn

log = logging.getLogger("narwhal.primary")


class CertificateWaiter:
    def __init__(
        self,
        store: Store,
        consensus_round: AtomicRound,
        gc_depth: Round,
        rx_synchronizer: asyncio.Queue,  # parked certificates
        tx_core: asyncio.Queue,
    ) -> None:
        self.store = store
        self.consensus_round = consensus_round
        self.gc_depth = gc_depth
        self.rx_synchronizer = rx_synchronizer
        self.tx_core = tx_core
        self.pending: Dict[Digest, Tuple[Round, asyncio.Task]] = {}
        # Certificates parked until their parents are stored.
        self._m_parked = metrics.counter("primary.certificate_waiter.parked")

    async def run(self) -> None:
        try:
            while True:
                certificate = await self.rx_synchronizer.get()
                digest = certificate.digest()
                if digest not in self.pending:
                    self._m_parked.inc()
                    task = spawn(self._wait(certificate))
                    self.pending[digest] = (certificate.round, task)
                self._gc()
        finally:
            for _, task in self.pending.values():
                task.cancel()
            self.pending.clear()

    async def _wait(self, certificate: Certificate) -> None:
        await asyncio.gather(
            *(
                self.store.notify_read(bytes(d))
                for d in certificate.header.parents
            )
        )
        self.pending.pop(certificate.digest(), None)
        await self.tx_core.put(certificate)

    def _gc(self) -> None:
        round = self.consensus_round.value
        if round <= self.gc_depth:
            return
        gc_round = round - self.gc_depth
        for d in [d for d, (r, _) in self.pending.items() if r <= gc_round]:
            _, task = self.pending.pop(d)
            task.cancel()

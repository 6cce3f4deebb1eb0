"""GarbageCollector: track the consensus round and clean up the workers.

Reference primary/src/garbage_collector.rs (72 LoC): consume committed
certificates from consensus, bump the shared consensus round, and broadcast
Cleanup(round) to our own workers.
"""

from __future__ import annotations

import asyncio
import logging

from ..config import Committee
from ..crypto import PublicKey
from ..messages import encode_cleanup
from ..network import SimpleSender
from .core import AtomicRound

log = logging.getLogger("narwhal.primary")


class GarbageCollector:
    def __init__(
        self,
        name: PublicKey,
        committee: Committee,
        consensus_round: AtomicRound,
        rx_consensus: asyncio.Queue,  # committed certificates
    ) -> None:
        self.consensus_round = consensus_round
        self.rx_consensus = rx_consensus
        self.sender = SimpleSender()
        self.worker_addresses = [
            a.primary_to_worker
            for a in committee.authorities[name].workers.values()
        ]

    async def run(self) -> None:
        last_committed_round = 0
        while True:
            certificate = await self.rx_consensus.get()
            round = certificate.round
            if round > last_committed_round:
                last_committed_round = round
                self.consensus_round.value = round
                for address in self.worker_addresses:
                    self.sender.send(
                        address, encode_cleanup(round), msg_type="cleanup"
                    )

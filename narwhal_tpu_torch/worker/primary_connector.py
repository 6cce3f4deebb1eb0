"""PrimaryConnector: forward batch-digest messages to our primary (LAN hop).

Reference worker/src/primary_connector.rs (39 LoC).
"""

from __future__ import annotations

import asyncio

from ..network import SimpleSender


class PrimaryConnector:
    def __init__(self, primary_address: str, in_queue: asyncio.Queue) -> None:
        self.primary_address = primary_address
        self.in_queue = in_queue
        self.sender = SimpleSender()

    async def run(self) -> None:
        while True:
            message = await self.in_queue.get()
            self.sender.send(
                self.primary_address, message, msg_type="batch_digest"
            )

"""Primary Helper: serve CertificatesRequests from our store.

Reference primary/src/helper.rs (71 LoC).
"""

from __future__ import annotations

import asyncio
import logging

from ..config import Committee
from ..network import SimpleSender
from ..utils.serde import Writer
from .messages import PM_CERTIFICATE

log = logging.getLogger("narwhal.primary")


class Helper:
    def __init__(
        self,
        committee: Committee,
        store,
        rx_primaries: asyncio.Queue,  # (digests, requestor)
    ) -> None:
        self.committee = committee
        self.store = store
        self.rx_primaries = rx_primaries
        self.sender = SimpleSender()

    async def run(self) -> None:
        while True:
            digests, requestor = await self.rx_primaries.get()
            try:
                address = self.committee.primary(requestor).primary_to_primary
            except Exception:
                log.warning("Certificates request from unknown authority")
                continue
            for digest in digests:
                raw = self.store.read(bytes(digest))
                if raw is not None:
                    # Stored bytes are the bare certificate; frame it as a
                    # PrimaryMessage::Certificate for the peer's receiver.
                    w = Writer()
                    w.u8(PM_CERTIFICATE)
                    w.raw(raw)
                    self.sender.send(
                        address, w.finish(), msg_type="certificate"
                    )

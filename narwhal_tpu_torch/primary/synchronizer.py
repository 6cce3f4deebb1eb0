"""Primary Synchronizer: dependency checks with suspend-on-miss.

Reference primary/src/synchronizer.rs (138 LoC): `missing_payload` (keyed
digest‖worker_id — the comment at 58-68 documents the worker-id-binding
attack this prevents), `get_parents`, `deliver_certificate`.  On a miss the
relevant waiter is notified and the caller suspends processing; the waiter
loops the message back to the Core when the dependency lands in the store.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Dict, List, Optional

from ..config import Committee
from ..crypto import Digest, PublicKey
from ..store import Store
from ..utils.env import env_flag
from .messages import Certificate, Header, genesis

log = logging.getLogger("narwhal.primary")
_TRACE = env_flag("NARWHAL_TRACE")


def payload_key(digest: Digest, worker_id: int) -> bytes:
    """Store key binding a batch digest to the worker id that served it."""
    return bytes(digest) + worker_id.to_bytes(4, "little")


class Synchronizer:
    def __init__(
        self,
        name: PublicKey,
        committee: Committee,
        store: Store,
        tx_header_waiter: asyncio.Queue,
        tx_certificate_waiter: asyncio.Queue,
    ) -> None:
        self.name = name
        self.store = store
        self.tx_header_waiter = tx_header_waiter
        self.tx_certificate_waiter = tx_certificate_waiter
        self.genesis = {c.digest(): c for c in genesis(committee)}

    async def missing_payload(self, header: Header) -> bool:
        """True if some payload batch is unavailable; schedules the fetch.
        We never store markers for our own workers' batches, so our own
        headers skip the check (reference synchronizer.rs:50-56)."""
        if header.author == self.name:
            return False
        missing: Dict[Digest, int] = {}
        for digest, worker_id in header.payload.items():
            if self.store.read(payload_key(digest, worker_id)) is None:
                missing[digest] = worker_id
        if not missing:
            return False
        if _TRACE:
            log.info("TRACE suspend header %r: %d payload missing",
                     header.id, len(missing))
        await self.tx_header_waiter.put(("sync_batches", missing, header))
        return True

    async def get_parents(self, header: Header) -> List[Certificate]:
        """All parent certificates, or [] after scheduling the fetch."""
        missing: List[Digest] = []
        parents: List[Certificate] = []
        for digest in header.parents:
            gen = self.genesis.get(digest)
            if gen is not None:
                parents.append(gen)
                continue
            raw = self.store.read(bytes(digest))
            if raw is None:
                missing.append(digest)
            else:
                parents.append(Certificate.deserialize(raw))
        if not missing:
            return parents
        if _TRACE:
            log.info("TRACE suspend header %r: %d parents missing",
                     header.id, len(missing))
        await self.tx_header_waiter.put(("sync_parents", missing, header))
        return []

    async def deliver_certificate(self, certificate: Certificate) -> bool:
        """True if all ancestors are in the store; else park the certificate
        with the CertificateWaiter (reference synchronizer.rs:122-137)."""
        for digest in certificate.header.parents:
            if digest in self.genesis:
                continue
            if self.store.read(bytes(digest)) is None:
                await self.tx_certificate_waiter.put(certificate)
                return False
        return True

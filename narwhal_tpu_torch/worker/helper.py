"""Worker Helper: serve other workers' BatchRequests from our store.

Reference worker/src/helper.rs (71 LoC): read each requested digest and send
the raw serialized batch back to the requestor's same-id worker.  The reply
is a regular WorkerMessage::Batch frame, so the requestor's normal batch path
(Processor → store → OthersBatch digest) resolves the wait.

Beyond the reference: requests are BOUNDED.  A BatchRequest is ~32 B per
digest while each reply is a full batch (~500 kB) — a ~15,000x
amplification lever that a hostile peer can pull with one frame (the
fault suite's ``sync_flood`` behavior).  Digests are deduplicated within
a request and capped at :func:`max_request_digests` per frame; anything
past the cap is dropped, counted into ``worker.helper_rejected_requests``
(the ``helper_abuse`` health rule's input) and logged at a bounded rate.
The honest requesting side (worker/synchronizer.py) chunks its own
requests under the same cap, so a clean committee never trips the
counter.
"""

from __future__ import annotations

import asyncio
import logging
import time

from .. import metrics
from ..config import Committee, WorkerId
from ..crypto import PublicKey
from ..network import SimpleSender
from ..utils.env import positive_int

log = logging.getLogger("narwhal.worker")

_MAX_DIGESTS_DEFAULT = 128
# Rate limit for the truncation warning: a flood is thousands of
# identical frames and the bench log parser reads every line.
_REJECT_WARN_INTERVAL = 5.0


def max_request_digests() -> int:
    """Per-BatchRequest digest ceiling (``NARWHAL_HELPER_MAX_DIGESTS``).
    One definition shared by the serving side (the Helper truncates
    over-limit requests, and the receiver pre-drops absurd frames before
    decode) and the requesting side (the Synchronizer chunks under it)
    so an honest committee never looks abusive."""
    return positive_int("NARWHAL_HELPER_MAX_DIGESTS", _MAX_DIGESTS_DEFAULT)


class Helper:
    def __init__(
        self,
        worker_id: WorkerId,
        committee: Committee,
        store,
        in_queue: asyncio.Queue,  # (digests, requestor)
    ) -> None:
        self.worker_id = worker_id
        self.committee = committee
        self.store = store
        self.in_queue = in_queue
        self.sender = SimpleSender()
        self.max_digests = max_request_digests()
        self._m_served = metrics.counter("worker.helper_served_batches")
        self._m_served_bytes = metrics.counter("worker.helper_served_bytes")
        self._m_rejected = metrics.counter("worker.helper_rejected_requests")
        self._last_reject_warn = 0.0

    async def run(self) -> None:
        while True:
            digests, requestor = await self.in_queue.get()
            try:
                address = self.committee.worker(
                    requestor, self.worker_id
                ).worker_to_worker
            except Exception:
                log.warning("Received batch request from unknown authority")
                continue
            await self._respond(address, self._bound(digests, requestor))

    def _bound(self, digests, requestor: PublicKey):
        """Dedup-then-cap one request's digest list; over-limit remainders
        are dropped and counted, never amplified.  Duplicate trimming is
        free — only a UNIQUE digest count past the cap is abuse (the
        rejected counter feeds a LATCHING health rule, so an under-cap
        request with a stray duplicate must not brand a peer hostile)."""
        unique = list(dict.fromkeys(digests))
        bounded = unique[: self.max_digests]
        dropped = len(unique) - len(bounded)
        if dropped:
            self._m_rejected.inc()
            now = time.monotonic()
            if now - self._last_reject_warn >= _REJECT_WARN_INTERVAL:
                self._last_reject_warn = now
                log.warning(
                    "Truncating batch request from %r: %d digest(s) "
                    "(%d duplicate), serving %d (cap %d)",
                    requestor, len(digests), len(digests) - len(unique),
                    len(bounded), self.max_digests,
                )
        return bounded

    async def _respond(self, address: str, digests) -> None:
        """Serve every bounded digest we hold.  The fault suite's
        ByzantineHelper overrides exactly this seam — the availability
        half of the worker plane — while request intake, bounding and
        accounting stay the honest path."""
        for digest in digests:
            serialized = self.store.read(bytes(digest))
            if serialized is not None:
                self._m_served.inc()
                self._m_served_bytes.inc(len(serialized))
                self.sender.send(address, serialized, msg_type="batch")

"""SignatureService: an actor that owns the secret key and serializes signing.

Reference crypto/src/lib.rs:224-250 — callers send a digest over a channel
and receive the signature via oneshot.  In asyncio terms, a queue-fed task
resolving futures; callers `await service.request_signature(digest)`.
Serializing through one task keeps the secret key in one place and gives the
TPU build a natural batching point for outbound signing.
"""

from __future__ import annotations

import asyncio

from .. import metrics
from ..utils.tasks import spawn
from typing import Optional, Tuple

from .digest import Digest
from .keys import KeyPair, Signature


class SignatureService:
    def __init__(self, keypair: KeyPair) -> None:
        self._keypair = keypair
        self._queue: Optional[asyncio.Queue] = None
        self._task: Optional[asyncio.Task] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None

    def _ensure_started(self) -> None:
        loop = asyncio.get_running_loop()
        # Re-arm if never started, the task died, or we moved to a new loop
        # (e.g. successive asyncio.run calls in tests).
        if self._task is None or self._task.done() or self._loop is not loop:
            # Unbounded (capacity 0: never saturates, reported without a
            # utilization) — its residence histogram is the sign-request
            # queue wait, the number that shows when the single signer
            # actor becomes the backlog.
            self._queue = metrics.InstrumentedQueue(
                channel="crypto.sign_service"
            )
            self._loop = loop
            self._task = spawn(self._run(self._queue), name="signature-service")

    async def _run(self, queue: asyncio.Queue) -> None:
        while True:
            digest, fut, site = await queue.get()
            if fut.cancelled():
                continue
            try:
                # lint: allow-blocking(signing IS this actor's entire job and the protocol signs at most one header+one vote per round — ~0.6 ms on the pure-Python fallback, µs with `cryptography`; an executor hop would cost more in GIL ping-pong than the sign itself on shared-core hosts)
                fut.set_result(self._keypair.sign(digest, site=site))
            except Exception as e:  # propagate instead of wedging the actor
                fut.set_exception(e)

    async def request_signature(
        self, digest: Digest, site: str = "other"
    ) -> Signature:
        """``site`` labels the op in the crypto-cost ledger (the caller
        knows what the digest is — "header" for Header.new, "vote" for
        Vote.new)."""
        self._ensure_started()
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        item: Tuple[Digest, asyncio.Future, str] = (digest, fut, site)
        await self._queue.put(item)
        return await fut

    def sign_now(self, digest: Digest, site: str = "other") -> Signature:
        """Synchronous signing for non-async contexts (tests, tools)."""
        return self._keypair.sign(digest, site=site)

    def close(self) -> None:
        if self._task is not None and not self._task.done():
            self._task.cancel()
        self._task = None
        self._queue = None
        self._loop = None

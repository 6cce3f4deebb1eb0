"""Byzantine worker behaviors: the payload-availability attacks.

The paper's central availability claim is that a certificate is a *proof
of batch availability* — 2f+1 workers ACKed the batch, so consensus never
fetches bodies on the critical path.  These behaviors attack exactly that
claim at the worker plane, each as a thin subclass of the live pipeline
class acting only at the network boundary (the primary-plane pattern of
``faults.byzantine``):

- ``withhold_batches`` — the BatchMaker broadcasts each sealed batch to
  JUST enough peers that, with our own stake, the ACK quorum still
  completes (so the batch certifies and enters headers), and the Helper
  then never answers ``BatchRequest``s for it.  The starved peers must
  recover through the Synchronizer's retry escalation to random holders
  — and their ``worker.unserved_sync_age_seconds`` names the attack
  (the ``batch_withholding`` health rule).
- ``garbage_batches`` — same under-sharing split, but the Helper answers
  sync requests with junk: alternately an OVERSIZED structurally-valid
  batch (rejected by the receiver's ``max_batch_bytes`` gate into
  ``worker.garbage_batches`` — the ``garbage_batches`` rule) and a
  corrupt frame (the existing malformed-drop path).  Honest peers still
  recover via escalation, because f+1 honest ACKers hold the real bytes
  — which is precisely the availability property under test.
- ``sync_flood`` — repeated maximum-size ``BatchRequest``s to every
  peer, exploiting the ~32 B-request → ~500 kB-reply amplification of
  worker/helper.py.  The Helper's per-request digest cap bounds the
  damage and counts the abuse into ``worker.helper_rejected_requests``
  (the ``helper_abuse`` rule).

All randomness (peer splits, junk bytes, flood padding) comes from the
plan's seeded RNG, like the primary-plane behaviors.
"""

from __future__ import annotations

import asyncio
import logging

from .. import metrics
from ..crypto import Digest
from ..crypto.digest import DIGEST_LEN
from ..messages import encode_batch_request
from ..network import SimpleSender
from ..worker.batch_maker import BatchMaker
from ..worker.helper import Helper, max_request_digests
from .byzantine import ByzantinePlan, _require_unit_stake

log = logging.getLogger("narwhal.faults")

# The flood names this many digests per request — far past the Helper's
# cap, so every frame is provably abusive on arrival.
_FLOOD_DIGESTS_MIN = 1_024

_SPLIT_BEHAVIORS = {"withhold_batches", "garbage_batches"}


class ByzantineBatchMaker(BatchMaker):
    """Under-shares every sealed batch: the ACK quorum still completes
    (our own stake + exactly enough peers), but the remaining peers never
    receive the broadcast and must fall back to ``BatchRequest`` — which
    the ByzantineHelper then refuses or poisons."""

    def __init__(self, plan: ByzantinePlan, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.plan = plan
        self._split = bool(_SPLIT_BEHAVIORS & plan.behaviors)
        if self._split:
            # The share is sized by COUNT against the stake-denominated
            # quorum threshold — same restriction (and same loud refusal)
            # as the primary plane's equivocate split.
            _require_unit_stake(
                self.committee,
                behavior=sorted(_SPLIT_BEHAVIORS & plan.behaviors)[0],
            )
        self._m_withheld = metrics.counter(
            "faults.byzantine.batches_withheld"
        )

    def _broadcast_batch(self, digest, message: bytes):
        if not self._split:
            return super()._broadcast_batch(digest, message)
        stake_by_addr = {addr: stake for stake, addr in self._peers}
        keep = self.committee.quorum_threshold() - self.committee.stake(
            self.name
        )
        # The authority-keyed favored split: aligned with the primary
        # plane's real-header share (plan.favored_split docstring), so
        # the under-share can never starve our own header's vote quorum.
        share, starved = self.plan.favored_split(
            {
                peer_name: addrs.worker_to_worker
                for peer_name, addrs in self.committee.others_workers(
                    self.name, self.worker_id
                )
            },
            keep,
        )
        self._m_withheld.inc()
        log.warning(
            "FAULT withholding batch %r from %d peer(s) "
            "(certifying via %d + own ACK)",
            digest, len(starved), len(share),
        )
        return [
            (stake_by_addr[addr], self.sender.send(addr, message, msg_type="batch"))
            for addr in share
        ]


class ByzantineHelper(Helper):
    """Answers (or refuses) sync requests adversarially.  Request intake,
    dedup/cap bounding and the abuse accounting stay the honest path —
    only the serve decision (`_respond`) is overridden."""

    def __init__(self, plan: ByzantinePlan, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.plan = plan
        self._m_ignored = metrics.counter(
            "faults.byzantine.sync_requests_ignored"
        )
        self._m_garbage = metrics.counter("faults.byzantine.garbage_served")
        self._junk_frame = None
        self._served = 0

    def _garbage(self) -> bytes:
        """A structurally VALID batch frame of ``plan.garbage_bytes`` junk
        (one giant transaction) — it passes the length-prefix walk, so
        only the receiver's size gate stands between it and a
        multi-megabyte hash + store append.  Built once, lazily."""
        if self._junk_frame is None:
            body = self.plan.rng.randbytes(self.plan.garbage_bytes)
            self._junk_frame = (
                b"\x00"
                + (1).to_bytes(4, "little")
                + len(body).to_bytes(4, "little")
                + body
            )
        return self._junk_frame

    async def _respond(self, address: str, digests) -> None:
        behaviors = self.plan.behaviors
        if "withhold_batches" in behaviors:
            self._m_ignored.inc()
            log.warning(
                "FAULT ignoring batch request for %d digest(s)", len(digests)
            )
            return
        if "garbage_batches" in behaviors:
            for digest in digests:
                self._served += 1
                if self._served % 2:
                    reply = self._garbage()
                else:
                    # A corrupt normal-size frame: valid batch tag, body
                    # that fails the structural walk (truncated tx).
                    reply = b"\x00" + (3).to_bytes(4, "little") + b"\x77"
                self._m_garbage.inc()
                self.sender.send(address, reply, msg_type="batch")
            if digests:
                log.warning(
                    "FAULT served garbage for %d digest(s)", len(digests)
                )
            return
        await super()._respond(address, digests)


class SyncFlooder:
    """``sync_flood``: a request loop sending max-size ``BatchRequest``s
    to every peer on a fixed cadence.  Digests are drawn from our own
    store (batches the peers genuinely hold — the real amplification
    case) padded with seeded-random junk to the flood width, so the flood
    is at full strength from the first tick."""

    def __init__(
        self, plan: ByzantinePlan, name, worker_id, committee, store
    ) -> None:
        self.plan = plan
        self.name = name
        self.worker_id = worker_id
        self.committee = committee
        self.store = store
        self.sender = SimpleSender()
        self._m_floods = metrics.counter("faults.byzantine.sync_floods")

    def _flood_digests(self):
        width = max(_FLOOD_DIGESTS_MIN, 2 * max_request_digests())
        # The store's key map is an implementation detail we peek at
        # deliberately: a real attacker knows the digests it was sent.
        stored = [
            Digest(k)
            for k in getattr(self.store, "_map", {})
            if len(k) == DIGEST_LEN
        ][: width // 2]
        junk = [
            Digest(self.plan.rng.randbytes(DIGEST_LEN))
            for _ in range(width - len(stored))
        ]
        return stored + junk

    async def run(self) -> None:
        interval = max(0.02, self.plan.flood_interval_ms / 1000.0)
        addresses = [
            addrs.worker_to_worker
            for _, addrs in self.committee.others_workers(
                self.name, self.worker_id
            )
        ]
        while True:
            await asyncio.sleep(interval)
            message = encode_batch_request(self._flood_digests(), self.name)
            for address in addresses:
                self.sender.send(address, message, msg_type="batch_request")
            self._m_floods.inc()

"""Pluggable verification backend: CPU reference vs. CUDA batched kernel.

The reference's `Signature::verify_batch` (crypto/src/lib.rs:206-219) is the
per-round crypto hot spot — 2f+1 ed25519 verifications per certificate × N
certificates per round (SURVEY.md §3.3).  Here that call is a seam: the CPU
backend loops over OpenSSL verifies; the CUDA backend ships the whole batch
to a hand-written verify kernel (ops/ed25519.py, csrc/ed25519_verify.cu) in
one launch.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional, Sequence, Tuple

from .. import metrics
from ..utils.env import env_flag, env_str
from .aggregate import AggregateSignature, verify_halfagg
from .digest import Digest
from .keys import PublicKey, Signature, cpu_verify

log = logging.getLogger("narwhal.crypto")

# -- crypto-cost ledger -------------------------------------------------------
#
# Every module-level verify entry point below is labelled with its CALL
# SITE so the bench's `crypto` section can attribute where verification
# ops (and their wall time) come from:
#
#   header / vote / certificate  inline sanitization (Header.verify,
#                                Vote.verify, Certificate.verify — the
#                                serial path)
#   batch_burst                  Core's accumulate→averify→replay seam
#                                (the batched path the ROADMAP item-1 A/B
#                                must show absorbing the serial ops)
#   certificate_agg              ONE half-aggregated quorum check under
#                                --cert-sig-scheme halfagg (whether it
#                                arrives serially via Certificate.verify
#                                or inside a burst batch) — ops count 1
#                                per certificate, which is the ledger
#                                witness for the "2f+1 → 1 verify"
#                                claim of ROADMAP item 2
#
# Per site: `crypto.verify.ops.<site>` (signature checks performed),
# `crypto.verify.seconds.<site>` (wall time per CALL — for the async
# batched path this includes event-loop yields/device round-trip, which
# is exactly the latency the caller pays), and
# `crypto.verify.batch_size.<site>` (ops per call — the serial→batched
# conversion shows up as mass moving to higher buckets).  The async
# batched path additionally records
# `crypto.verify.device_seconds.<site>`: the backend's own compute time
# (host prep + device dispatch + result sync), EXCLUDING event-loop
# yield/executor-queue time — without the split, the single wall
# histogram conflates "crypto is slow" with "the loop was busy", which
# under-credits pipelining in the A/B.
# Instrumentation lives HERE, on the module seam, so both the CPU and
# CUDA backends are covered and backend-internal chunking is not
# double-counted.

_verify_instruments_cache: Dict[str, Tuple] = {}


def _verify_instruments(site: str):
    inst = _verify_instruments_cache.get(site)
    if inst is None:
        inst = _verify_instruments_cache[site] = (
            metrics.counter(f"crypto.verify.ops.{site}"),
            metrics.histogram(f"crypto.verify.seconds.{site}"),
            metrics.histogram(
                f"crypto.verify.batch_size.{site}", metrics.COUNT_BUCKETS
            ),
            metrics.histogram(f"crypto.verify.device_seconds.{site}"),
        )
    return inst


class CpuBackend:
    name = "cpu"

    def verify(self, message: bytes, key: PublicKey, sig: Signature) -> bool:
        return cpu_verify(message, key, sig)

    def verify_batch_mask(
        self,
        messages: Sequence[bytes],
        keys: Sequence[PublicKey],
        sigs: Sequence[Signature],
    ) -> List[bool]:
        return [cpu_verify(m, k, s) for m, k, s in zip(messages, keys, sigs)]

    # Inline chunk size: ~64 OpenSSL verifies ≈ 10 ms — the max the event
    # loop may stall between yields.  A thread handoff per burst was
    # measured strictly worse on core-starved hosts (GIL/scheduler
    # ping-pong, cf. store.py), so big bursts stay on-loop but cooperative.
    AVERIFY_CHUNK = 64

    async def averify_batch_mask(
        self,
        messages: Sequence[bytes],
        keys: Sequence[PublicKey],
        sigs: Sequence[Signature],
    ) -> List[bool]:
        mask, _ = await self.averify_batch_mask_timed(messages, keys, sigs)
        return mask

    async def averify_batch_mask_timed(
        self,
        messages: Sequence[bytes],
        keys: Sequence[PublicKey],
        sigs: Sequence[Signature],
    ) -> Tuple[List[bool], float]:
        """(mask, compute_seconds): compute time sums the synchronous
        verify chunks only — the inter-chunk event-loop yields are wall
        time the CALLER'S latency pays, not crypto cost."""
        n = len(messages)
        t0 = time.perf_counter()
        if n <= self.AVERIFY_CHUNK:
            return (
                self.verify_batch_mask(messages, keys, sigs),
                time.perf_counter() - t0,
            )
        import asyncio

        out: List[bool] = []
        compute = 0.0
        for i in range(0, n, self.AVERIFY_CHUNK):
            j = i + self.AVERIFY_CHUNK
            t0 = time.perf_counter()
            out.extend(self.verify_batch_mask(messages[i:j], keys[i:j], sigs[i:j]))
            compute += time.perf_counter() - t0
            # Yield between chunks so network/timers keep running during a
            # committee-sized burst (tens of ms of crypto at N=20+).
            await asyncio.sleep(0)
        return out, compute


_backend = CpuBackend()

# The batched verifier's name: the port's spelling of the reference's
# "tpu"/"jax" (one hand-written CUDA kernel per batch).
_BATCHED_NAMES = ("cuda",)


def set_backend(
    name: str, strict: Optional[bool] = None, device=None
) -> None:
    """Select the verification backend: "cpu", or "cuda" (the batched
    device verifier) on ``device`` (None means the GPU; "cpu" runs the
    kernel's plain PyTorch twin, for tests).

    A cuda request whose extension fails to build or load is a BOOT
    error, not a first-burst error: with ``strict`` (default: the
    NARWHAL_CRYPTO_BACKEND_STRICT flag, on) the failure raises here, at
    selection time; with strict off it logs the error and falls back to
    the cpu backend — an explicit, logged downgrade.
    """
    global _backend
    if name == "cpu":
        _backend = CpuBackend()
    elif name in _BATCHED_NAMES:
        try:
            from ..ops.ed25519 import CudaBackend

            batched = CudaBackend(device)
        except (ImportError, OSError, RuntimeError) as e:
            if strict is None:
                strict = env_flag("NARWHAL_CRYPTO_BACKEND_STRICT")
            if strict:
                raise RuntimeError(
                    f"crypto backend {name!r} requested but the batched "
                    f"verifier failed to build or load: {e} — fix the "
                    "CUDA toolchain or set NARWHAL_CRYPTO_BACKEND_STRICT=0 "
                    "to fall back to the cpu backend"
                ) from e
            log.error(
                "crypto backend %r unavailable (%s); falling back to cpu "
                "(NARWHAL_CRYPTO_BACKEND_STRICT=0)", name, e,
            )
            _backend = CpuBackend()
            return
        _backend = batched
    else:
        raise ValueError(f"unknown crypto backend {name!r}")


# The reference's names for its batched verifier ("tpu", "jax"), which a
# port node takes as "cuda": one NARWHAL_CRYPTO_BACKEND value, or one
# harness command line, then serves a committee of both packages' nodes.
_REFERENCE_BATCHED_NAMES = ("tpu", "jax")


def set_backend_from_env(cli_choice: Optional[str] = None, device=None) -> str:
    """Boot-time backend selection: the CLI flag wins, then the
    NARWHAL_CRYPTO_BACKEND env knob, then "cpu"; the reference's "tpu"
    and "jax" select "cuda" on ``device``.  Returns the name that was
    requested (the live backend's name differs from it for "tpu" and
    "jax", and under the non-strict fallback)."""
    name = cli_choice or env_str("NARWHAL_CRYPTO_BACKEND") or "cpu"
    batched = _BATCHED_NAMES[0] if name in _REFERENCE_BATCHED_NAMES else name
    set_backend(batched, device=device)
    return name


def get_backend():
    return _backend


def verify_aggregate(
    message: bytes,
    signers: Sequence[PublicKey],
    agg: AggregateSignature,
    site: str = "certificate_agg",
) -> bool:
    """One half-aggregated quorum check: the whole 2f+1 vote set of a
    certificate is ONE op in the crypto ledger (`crypto.verify.ops.
    certificate_agg`).  The multiexp equation runs on the CPU fallback
    for now — a batched device multiexp kernel is the natural follow-up
    once the scheme flips default — so both backends route here."""
    ops, secs, sizes, _dev = _verify_instruments(site)
    t0 = time.perf_counter()
    try:
        return verify_halfagg(bytes(message), signers, bytes(agg))
    finally:
        ops.inc()
        sizes.observe(1)
        secs.observe(time.perf_counter() - t0)


def _split_aggregate_claims(messages, keys, sigs):
    """Partition a mixed claim batch into plain (message, key, sig)
    triples and aggregate (message, signer-tuple, AggregateSignature)
    claims — the shape Certificate.signature_claims emits under
    ``halfagg``.  Returns (plain_positions, plain triples, agg_positions,
    agg claims); plain order is preserved so the backend sees the same
    batch it would without aggregates present."""
    plain_pos: List[int] = []
    pm: List[bytes] = []
    pk: List[PublicKey] = []
    ps: List[Signature] = []
    agg_pos: List[int] = []
    aggs: List[Tuple[bytes, Sequence[PublicKey], AggregateSignature]] = []
    for i, (m, k, s) in enumerate(zip(messages, keys, sigs)):
        if isinstance(s, AggregateSignature):
            agg_pos.append(i)
            aggs.append((m, k, s))
        else:
            plain_pos.append(i)
            pm.append(m)
            pk.append(k)
            ps.append(s)
    return plain_pos, pm, pk, ps, agg_pos, aggs


def verify(
    message: bytes, key: PublicKey, sig: Signature, site: str = "other"
) -> bool:
    ops, secs, sizes, _dev = _verify_instruments(site)
    t0 = time.perf_counter()
    try:
        return _backend.verify(message, key, sig)
    finally:
        ops.inc()
        sizes.observe(1)
        secs.observe(time.perf_counter() - t0)


def verify_batch_mask(
    messages: Sequence[bytes],
    keys: Sequence[PublicKey],
    sigs: Sequence[Signature],
    site: str = "other",
) -> List[bool]:
    """Per-item validity mask for a batch of (message, key, signature).
    Aggregate claims (an AggregateSignature in the sig slot) are split
    out and checked one equation each under the ``certificate_agg``
    site; the plain remainder rides the selected backend unchanged."""
    if not (len(messages) == len(keys) == len(sigs)):
        raise ValueError("verify_batch: length mismatch")
    if not messages:
        return []
    if any(isinstance(s, AggregateSignature) for s in sigs):
        plain_pos, pm, pk, ps, agg_pos, aggs = _split_aggregate_claims(
            messages, keys, sigs
        )
        mask: List[bool] = [False] * len(messages)
        for pos, ok in zip(
            plain_pos, verify_batch_mask(pm, pk, ps, site=site) if pm else []
        ):
            mask[pos] = ok
        for pos, (m, k, s) in zip(agg_pos, aggs):
            mask[pos] = verify_aggregate(m, k, s)
        return mask
    ops, secs, sizes, _dev = _verify_instruments(site)
    t0 = time.perf_counter()
    try:
        return list(_backend.verify_batch_mask(messages, keys, sigs))
    finally:
        ops.inc(len(messages))
        sizes.observe(len(messages))
        secs.observe(time.perf_counter() - t0)


async def averify_batch_mask(
    messages: Sequence[bytes],
    keys: Sequence[PublicKey],
    sigs: Sequence[Signature],
    site: str = "other",
) -> List[bool]:
    """Async verify_batch_mask: the CUDA backend runs the device round trip
    in an executor thread so the node's event loop (networking, proposer
    timers, waiters) keeps running during the dispatch+sync — without this,
    every Core burst would stall the whole primary for the device latency."""
    if not (len(messages) == len(keys) == len(sigs)):
        raise ValueError("verify_batch: length mismatch")
    if not messages:
        return []
    if any(isinstance(s, AggregateSignature) for s in sigs):
        # Mixed burst under halfagg: plain claims (header signatures,
        # votes) keep the async backend path; each aggregate claim is
        # one CPU multiexp with an event-loop yield between equations
        # (the AVERIFY_CHUNK discipline — ~10-30 ms per equation on the
        # pure-Python fallback must not starve timers at N=20 catch-up).
        import asyncio

        plain_pos, pm, pk, ps, agg_pos, aggs = _split_aggregate_claims(
            messages, keys, sigs
        )
        mask: List[bool] = [False] * len(messages)
        if pm:
            plain_mask = await averify_batch_mask(pm, pk, ps, site=site)
            for pos, ok in zip(plain_pos, plain_mask):
                mask[pos] = ok
        for pos, (m, k, s) in zip(agg_pos, aggs):
            mask[pos] = verify_aggregate(m, k, s)
            await asyncio.sleep(0)
        return mask
    ops, secs, sizes, dev = _verify_instruments(site)
    t0 = time.perf_counter()
    try:
        mask, compute_s = await _backend.averify_batch_mask_timed(
            messages, keys, sigs
        )
        # Backend-side compute only (host prep + dispatch + result sync)
        # vs the wall observation below, which additionally carries the
        # event-loop yields / executor-queue wait across the await.
        dev.observe(compute_s)
        return list(mask)
    finally:
        # Wall time across the await: includes event-loop yields and the
        # device round trip — the latency the calling burst actually pays.
        ops.inc(len(messages))
        sizes.observe(len(messages))
        secs.observe(time.perf_counter() - t0)


def verify_batch(
    digest: Digest,
    keys: Sequence[PublicKey],
    sigs: Sequence[Signature],
    site: str = "other",
) -> bool:
    """All-or-nothing batch verification of many signatures over ONE digest —
    the certificate-quorum check (reference primary/src/messages.rs:189-215).
    An empty batch is invalid: a zero-signature certificate must never pass."""
    if not keys:
        return False
    msgs = [bytes(digest)] * len(keys)
    return all(verify_batch_mask(msgs, keys, sigs, site=site))

"""Consensus audit log + golden-oracle replay — the safety-verdict engine.

Every primary can append a per-process **audit segment** (enabled by the
``NARWHAL_CONSENSUS_AUDIT`` env var or the equivalent constructor arg):

    record   := tag(1B) ‖ u32-le length ‖ payload
    'R'      := the checkpoint blob restored at boot ('' for a fresh
                frontier) — always the segment's first record
    'I'      := a certificate entering the commit rule, serialized, in
                arrival order
    'C'      := a committed certificate's 32-byte digest, in commit order

One segment per process incarnation: a crash/restart scenario hands the
restarted node a NEW segment path, so a SIGKILL-torn tail only ever sits
at the end of a segment (the reader stops at the tear instead of
corrupting post-restart records).

:func:`replay_segments` is the machine-checked safety verdict from
arXiv:2407.02167's reusable-invariant playbook, instantiated over the
frozen r06 oracle (``consensus/golden.py``):

- **oracle equivalence** — each segment's 'I' stream replayed through a
  fresh ``GoldenTusk`` (restored from the segment's 'R' blob) must
  reproduce the node's recorded 'C' sequence byte-identically (the
  recorded sequence may be a proper prefix: a crash can lose the tail of
  the last flushed burst, never reorder it);
- **certificate uniqueness** — no digest commits twice within a segment,
  and no two distinct digests commit for one (round, origin) slot across
  the whole run (equivocation must never doubly commit);
- **causal history** — every committed certificate's parents are genesis,
  committed earlier, already below the origin's ROLLING committed
  frontier at the moment the child commits (the walk's ≥-skip may be
  triggered mid-burst by an earlier leader's flush), or GC'd out of the
  window; parents that cannot be resolved against the
  inserted-certificate index are *counted* as unverifiable (a restored
  node legitimately commits above history it never re-synced) rather
  than silently passed.

:func:`cross_node_prefix` is the committee half of the verdict: every
honest node's (re-delivery-deduplicated) commit sequence must be a byte
prefix of the longest one.
"""

from __future__ import annotations

import logging
import os
import struct
from typing import Dict, List, Optional, Tuple

from ..config import Committee
from ..messages import Round
from ..primary.messages import Certificate, genesis
from .golden import GoldenTusk

log = logging.getLogger("narwhal.consensus")


class _CertDecoder:
    """Decode audit certificate payloads, sniffing the RECORDING's wire
    arm and certificate-signature scheme: the nodes that wrote the
    segments may have run the other ``NARWHAL_WIRE_V2`` arm or the
    other ``NARWHAL_CERT_SIG_SCHEME`` than this (harness) process —
    e.g. auditing a halfagg-arm sim workdir after the run bracket
    restored the process scheme.  The live decode path refuses
    cross-scheme frames LOUDLY (SchemeMismatch — the mixed-committee
    guard), but replay judges a FINISHED recording, so that refusal is
    re-read here as arm information: the first payload is tried under
    the process (arm, scheme) and then the flipped combinations;
    whichever decodes is pinned for the rest of the replay (a
    recording is single-arm/single-scheme by construction — both flags
    are committee-wide and process-constant)."""

    __slots__ = ("arm", "scheme")

    def __init__(self) -> None:
        self.arm: Optional[bool] = None  # None = process flags untested
        self.scheme: Optional[str] = None

    @staticmethod
    def _decode(payload: bytes, arm: bool, scheme: str) -> Certificate:
        from ..crypto import aggregate
        from ..network import wirev2

        prev_arm = wirev2.enabled_override()
        prev_scheme = aggregate.scheme_override()
        wirev2.set_enabled(arm)
        aggregate.set_scheme(scheme)
        try:
            return Certificate.deserialize(payload)
        finally:
            wirev2.set_enabled(prev_arm)
            aggregate.set_scheme(prev_scheme)

    def __call__(self, payload: bytes) -> Certificate:
        from ..crypto import aggregate
        from ..network import wirev2

        if self.arm is None:
            proc_arm = wirev2.enabled()
            proc_scheme = aggregate.scheme()
            other_scheme = (
                "halfagg" if proc_scheme == "individual" else "individual"
            )
            last_exc: Optional[Exception] = None
            for arm, scheme in (
                (proc_arm, proc_scheme),
                (proc_arm, other_scheme),
                (not proc_arm, proc_scheme),
                (not proc_arm, other_scheme),
            ):
                try:
                    cert = self._decode(payload, arm, scheme)
                except Exception as exc:
                    last_exc = exc
                    continue
                if (arm, scheme) != (proc_arm, proc_scheme):
                    log.warning(
                        "audit replay: certificates decode under "
                        "NARWHAL_WIRE_V2=%d / cert-sig-scheme %s, not "
                        "this process's arm — the recording ran the "
                        "other configuration; pinning it for this "
                        "replay",
                        1 if arm else 0,
                        scheme,
                    )
                self.arm, self.scheme = arm, scheme
                return cert
            raise last_exc  # type: ignore[misc]
        return self._decode(payload, self.arm, self.scheme)

_LEN = struct.Struct("<I")

TAG_RESTORE = b"R"
TAG_INSERT = b"I"
TAG_COMMIT = b"C"
# Commit-rule marker ('classic' | 'lowdepth' | 'multileader'), written
# immediately after the restore marker.  Segments recorded before the
# marker existed have none and replay under the classic oracle — exactly
# what recorded them.
TAG_RULE = b"M"

_RULE_ORACLES = {"classic": GoldenTusk}


def _oracle_for(rule: str):
    if rule == "lowdepth":
        # Deferred: the classic-only paths never import the other oracles.
        from .golden_lowdepth import GoldenLowDepthTusk

        return GoldenLowDepthTusk
    if rule == "multileader":
        from .golden_multileader import GoldenMultiLeaderTusk

        return GoldenMultiLeaderTusk
    return _RULE_ORACLES[rule]


class AuditWriter:
    """Append-only audit segment (buffered; the Consensus runner flushes
    once per drained burst, so 'I' and 'C' records of one burst always
    land or tear together)."""

    def __init__(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        # One segment per process incarnation is the format's invariant
        # (the restore marker must be the FIRST record).  A fixed
        # NARWHAL_CONSENSUS_AUDIT path reused across restarts (systemd
        # unit, operator script) would append a second 'R' mid-file and
        # turn a perfectly safe run into a false safety FAIL — roll to
        # the first free `<path>.N` instead, keeping the previous
        # incarnation's segment intact and replayable.
        self.path = path
        if os.path.exists(path) and os.path.getsize(path) > 0:
            n = 1
            while (
                os.path.exists(f"{path}.{n}")
                and os.path.getsize(f"{path}.{n}") > 0
            ):
                n += 1
            self.path = f"{path}.{n}"
        self._f = open(self.path, "ab")

    def _record(self, tag: bytes, payload: bytes) -> None:
        self._f.write(tag + _LEN.pack(len(payload)) + payload)

    def restore_marker(self, blob: bytes) -> None:
        self._record(TAG_RESTORE, blob)

    def rule_marker(self, rule: str) -> None:
        self._record(TAG_RULE, rule.encode("ascii"))

    def insert(self, certificate: Certificate) -> None:
        self._record(TAG_INSERT, certificate.serialize())

    def commit(self, certificate: Certificate) -> None:
        self._record(TAG_COMMIT, bytes(certificate.digest()))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        try:
            self._f.flush()
        finally:
            self._f.close()


def read_audit(path: str) -> List[Tuple[bytes, bytes]]:
    """Parse one segment into (tag, payload) records, tolerating a torn
    tail (SIGKILL mid-write) by stopping at the first incomplete record."""
    with open(path, "rb") as f:
        data = f.read()
    out: List[Tuple[bytes, bytes]] = []
    pos, n = 0, len(data)
    while pos + 1 + _LEN.size <= n:
        tag = data[pos : pos + 1]
        if tag not in (TAG_RESTORE, TAG_INSERT, TAG_COMMIT, TAG_RULE):
            break  # corrupt record boundary; treat like a tear
        (length,) = _LEN.unpack_from(data, pos + 1)
        end = pos + 1 + _LEN.size + length
        if end > n:
            break  # torn tail
        out.append((tag, data[pos + 1 + _LEN.size : end]))
        pos = end
    return out


def replay_segments(
    committee: Committee,
    gc_depth: Round,
    segment_paths: List[str],
    fixed_coin: bool = False,
) -> dict:
    """Replay one node's audit segments through the golden oracle and
    check the safety invariants.  Returns a verdict dict (see module
    docstring); ``ok`` is the conjunction of every check.  ``fixed_coin``
    must match the recording node's leader-election mode (live nodes:
    False; golden-test fixtures: True)."""
    # The audit's certificate payloads use the wire-v2 key-index codec
    # when the recording nodes ran v2 (the default): install the same
    # roster in THIS (harness) process before deserializing.
    from ..messages import set_wire_committee

    set_wire_committee(committee)
    decode_cert = _CertDecoder()
    genesis_digests = {c.digest() for c in genesis(committee)}
    violations: List[str] = []
    unverifiable_parents = 0
    recorded_all: List[bytes] = []   # every 'C' digest in record order
    committed_global: set = set()    # deduped across segments
    slot_by_digest: Dict[bytes, Tuple[Round, bytes]] = {}
    slots_committed: Dict[Tuple[Round, bytes], bytes] = {}
    golden_total = 0
    segment_rules: List[str] = []

    for seg_i, path in enumerate(segment_paths):
        records = read_audit(path)
        # Every path through this loop body appends exactly one entry to
        # segment_rules, rejected segments included — the verdict's
        # `rules` list must stay index-aligned with segment order or a
        # consumer joining rules[i] to segment i reads the wrong rule.
        if not records:
            violations.append(f"segment {seg_i}: empty or unreadable")
            segment_rules.append("unreadable")
            continue
        if records[0][0] != TAG_RESTORE:
            violations.append(
                f"segment {seg_i}: does not start with a restore marker"
            )
            segment_rules.append("unreadable")
            continue
        # The rule marker (if present) is the record after the restore
        # marker: each segment replays under the oracle of the rule that
        # RECORDED it — a flag-flip sweep's two arms, or a node restarted
        # under the other rule (new incarnation = new segment), judge
        # themselves without harness plumbing.  Marker-less segments
        # predate the marker and replay classic.
        rule = "classic"
        body = records[1:]
        if body and body[0][0] == TAG_RULE:
            raw = body[0][1].decode("ascii", "replace")
            if raw not in ("classic", "lowdepth", "multileader"):
                violations.append(
                    f"segment {seg_i}: unknown commit-rule marker {raw!r}"
                )
                segment_rules.append(raw)
                continue
            rule = raw
            body = body[1:]
        segment_rules.append(rule)
        golden = _oracle_for(rule)(committee, gc_depth, fixed_coin=fixed_coin)
        blob = records[0][1]
        if blob:
            try:
                golden.state.restore(blob)
            except Exception as exc:
                # Including the cross-rule magic mismatch: a segment whose
                # restore blob was written by the OTHER rule's state is a
                # recording inconsistency the verdict must surface, not
                # crash on.
                violations.append(
                    f"segment {seg_i}: restore blob does not parse under "
                    f"the {rule!r} oracle ({exc!r})"
                )
                continue
        inserts: Dict[bytes, Certificate] = {}
        golden_commits: List[bytes] = []
        golden_committed_set: set = set()
        recorded: List[bytes] = []
        seg_seen: set = set()
        # Rolling committed frontier per origin, updated per EMITTED
        # commit (not per burst): within one multi-leader burst an
        # earlier leader's flush can advance an origin's frontier past a
        # cert the walk then legitimately ≥-skips — a parent excused
        # mid-burst.  A burst-entry snapshot misses that window and
        # flagged byte-identical-to-oracle runs as causal violations
        # (found by the sim sweep's deeper DAGs; the walk itself was
        # correct).
        frontier: Dict[bytes, Round] = dict(golden.state.last_committed)
        for tag, payload in body:
            if tag == TAG_RESTORE:
                violations.append(
                    f"segment {seg_i}: restore marker mid-segment"
                )
                break
            if tag == TAG_RULE:
                violations.append(
                    f"segment {seg_i}: commit-rule marker mid-segment"
                )
                break
            if tag == TAG_COMMIT:
                recorded.append(payload)
                # Within one process lifetime the commit rule must never
                # emit a digest twice (re-delivery across a restart is the
                # allowed at-least-once boundary, NOT within a segment).
                if payload in seg_seen:
                    violations.append(
                        f"segment {seg_i}: digest {payload.hex()[:16]} "
                        "committed twice within one segment"
                    )
                seg_seen.add(payload)
                continue
            try:
                cert = decode_cert(payload)
            except Exception as exc:
                # A complete 'I' record with a garbage payload (disk
                # corruption, writer bug).  The segment's replay can no
                # longer be trusted past this point: record the violation
                # and stop this segment instead of crashing the verdict
                # engine that exists to judge exactly this.
                violations.append(
                    f"segment {seg_i}: undeserializable insert record "
                    f"({exc!r})"
                )
                break
            inserts[bytes(cert.digest())] = cert
            sequence = golden.process_certificate(cert)
            for x in sequence:
                d = bytes(x.digest())
                golden_commits.append(d)
                golden_committed_set.add(d)
                # Causal history: each parent accounted for.
                for parent in x.header.parents:
                    if parent in genesis_digests:
                        continue
                    pb = bytes(parent)
                    if pb in committed_global or pb in golden_committed_set:
                        continue
                    pc = inserts.get(pb)
                    if pc is None:
                        # Not inserted this lifetime: a restored node
                        # commits above history it never re-synced.
                        unverifiable_parents += 1
                        continue
                    if frontier.get(pc.origin, 0) >= pc.round:
                        continue  # excluded by the committed frontier
                    if (
                        pc.round + gc_depth
                        < golden.state.last_committed_round
                    ):
                        continue  # outside the GC window
                    violations.append(
                        f"segment {seg_i}: committed "
                        f"{d.hex()[:16]} (round {x.round}) before its "
                        f"parent {pb.hex()[:16]} (round {pc.round})"
                    )
                # (round, origin) slot uniqueness across the run.
                slot = (x.round, bytes(x.origin))
                prev = slots_committed.get(slot)
                if prev is not None and prev != d:
                    violations.append(
                        f"two certificates committed for slot "
                        f"round={x.round} origin={slot[1].hex()[:16]}"
                    )
                slots_committed[slot] = d
                slot_by_digest[d] = slot
                ob = bytes(x.origin)
                if x.round > frontier.get(ob, 0):
                    frontier[ob] = x.round
        golden_total += len(golden_commits)
        # Oracle equivalence: the node's recorded sequence must be a byte
        # prefix of the oracle's (a crash can lose a flushed burst's tail
        # 'C' records — both channels lose them together — but any
        # REORDER or substitution is a safety violation).
        if recorded != golden_commits[: len(recorded)]:
            div = next(
                (
                    i
                    for i, (a, b) in enumerate(zip(recorded, golden_commits))
                    if a != b
                ),
                min(len(recorded), len(golden_commits)),
            )
            violations.append(
                f"segment {seg_i}: recorded commit sequence diverges from "
                f"the golden oracle at position {div} "
                f"(recorded {len(recorded)}, oracle {len(golden_commits)})"
            )
        recorded_all.extend(recorded)
        for d in recorded:
            committed_global.add(d)

    return {
        "ok": not violations,
        "violations": violations,
        "segments": len(segment_paths),
        "rules": segment_rules,
        "recorded_commits": len(recorded_all),
        "golden_commits": golden_total,
        "unverifiable_parents": unverifiable_parents,
        "commit_digests": [d.hex() for d in _dedupe(recorded_all)],
    }


def _dedupe(digests: List[bytes]) -> List[bytes]:
    """Drop re-deliveries (keep first occurrence): the at-least-once
    restart boundary may repeat a burst; order is otherwise preserved."""
    seen: set = set()
    out = []
    for d in digests:
        if d not in seen:
            seen.add(d)
            out.append(d)
    return out


def cross_node_prefix(per_node: Dict[str, List[str]]) -> dict:
    """Committee-wide safety: every honest node's deduped commit-digest
    sequence (hex strings, from :func:`replay_segments`) must be a byte
    prefix of the longest node's.  Nodes commit at different speeds, so
    prefix — not equality — is the invariant."""
    longest_node = None
    longest: List[str] = []
    for node, seq in per_node.items():
        if len(seq) > len(longest):
            longest, longest_node = seq, node
    violations = []
    for node, seq in sorted(per_node.items()):
        if seq != longest[: len(seq)]:
            div = next(
                (i for i, (a, b) in enumerate(zip(seq, longest)) if a != b),
                min(len(seq), len(longest)),
            )
            violations.append(
                f"{node} diverges from {longest_node} at commit {div}"
            )
    return {
        "ok": not violations,
        "violations": violations,
        "lengths": {n: len(s) for n, s in sorted(per_node.items())},
        "reference_node": longest_node,
    }

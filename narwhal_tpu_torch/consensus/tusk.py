"""Tusk: zero-message asynchronous BFT commit over the shared DAG.

Reference consensus/src/lib.rs (304 LoC).  Every even round r has a leader;
when the leader of round r−2 gathers f+1 stake support among round r−1
certificates, it commits — together with every preceding uncommitted leader
it is linked to, each flattening its causal sub-DAG in deterministic order.
No extra messages: the commit rule is a pure function of the DAG.

The pure state machine (`Tusk.process_certificate`) is separated from the
async runner (`Consensus`) so the commit rule can be golden-tested directly
and swapped for the CUDA window kernels (ops/reachability.py,
csrc/reachability.cu) validated certificate-for-certificate against this
implementation.

Commit-path latency model (rebuilt after a stage breakdown measured
cert→commit at 77% of seal→commit end-to-end latency, and Mysticeti's core
argument is that DAG-consensus latency is won or lost in the commit rule's
reaction time):

- a digest → certificate index rides alongside the round → origin DAG, so
  ``order_dag`` parent resolution and ``linked()`` reachability are O(1)
  per edge instead of a linear scan over a round's certificates per hop;
- leader support accumulates INCREMENTALLY at insert time (a round-(r+1)
  certificate bumps its round-r leader's support counter once), so the
  f+1 gate in ``process_certificate`` is a dict read, not a rescan of the
  whole child round on every odd-round arrival;
- committing updates the frontier per certificate (O(1)) but sweeps the
  DAG window for garbage exactly ONCE per commit burst (``State.gc``) —
  the old per-certificate ``State.update`` full sweep was quadratic in
  burst size;
- the async runner drains its input queue in bursts, processing a backlog
  of queued certificates per wakeup instead of one per task switch.

Every rewrite above is certificate-for-certificate equivalent to the original
dict walk, which is kept frozen as the oracle in
``narwhal_tpu/consensus/golden.py`` and diffed against on recorded
multi-leader / gc-wrap / checkpoint-restore streams
(tests/test_tusk_equivalence.py).
"""

from __future__ import annotations

import asyncio
import hashlib
import logging
import os
import struct
import tempfile
import time
from typing import Callable, Dict, List, Optional, Tuple

from .. import metrics
from ..config import Committee
from ..crypto import Digest, PublicKey
from ..messages import Round
from ..primary.messages import Certificate, genesis
from ..utils.clock import loop_now

log = logging.getLogger("narwhal.consensus")

# dag: Round → {origin → (certificate digest, certificate)}
Dag = Dict[Round, Dict[PublicKey, Tuple[Digest, Certificate]]]

# The selectable commit rules (NARWHAL_COMMIT_RULE / `node run
# --commit-rule`) and the checkpoint magic each writes.  A frontier
# snapshot is only meaningful to the rule that produced it — the rules
# commit at different depths (and multileader anchors different
# authorities entirely), so one rule's frontier restored under another
# would anchor the walk at rounds that rule never decided.  Distinct
# magics turn that operator error into a LOUD boot-time refusal
# (CheckpointRuleMismatch) instead of a silent reinterpretation.
COMMIT_RULES = ("classic", "lowdepth", "multileader")
RULE_MAGICS = {
    "classic": b"NCKPT1",
    "lowdepth": b"NCKLD1",
    "multileader": b"NCKML1",
}

# Leader slots per even round under the multileader rule.  A pure
# constant (not an env knob): the slot schedule feeds the frozen golden
# oracle and the audit replay judge, so a run-time knob would let a
# replay silently judge a recording against a different schedule.
MULTILEADER_SLOTS = 3


def leader_slots(
    sorted_keys: List[PublicKey],
    round_: Round,
    k: Optional[int] = None,
    fixed_coin: bool = False,
) -> List[PublicKey]:
    """The K leader-slot authorities for an even round, in slot order.

    Deterministic pure function of (sorted committee keys, round) — the
    schedule must be identical across processes and restarts because
    every node's commit decisions and the frozen oracle's replay both
    derive it independently.  Slot 0 ROTATES (``(round // 2) % n``), so
    over any ``committee_size`` consecutive even rounds every authority
    holds slot 0 exactly once — no authority monopolizes the anchor
    slot, and none is starved of it for longer than one full rotation.
    The remaining slots are a round-salted rotation of the rest of the
    committee (SHA-256 of the round number), so the backup slots are
    not permanently the rotation's next-in-line either.

    ``fixed_coin`` pins the schedule to the first K sorted authorities —
    the multileader analogue of the reference's ``#[cfg(test)] coin = 0``
    used by the golden tests."""
    n = len(sorted_keys)
    k = min(n, MULTILEADER_SLOTS if k is None else k)
    if fixed_coin:
        return list(sorted_keys[:k])
    base = (round_ // 2) % n
    order = [sorted_keys[(base + j) % n] for j in range(n)]
    head, rest = order[0], order[1:]
    if len(rest) > 1:
        salt = int.from_bytes(
            hashlib.sha256(struct.pack("<Q", round_)).digest()[:8], "little"
        )
        off = salt % len(rest)
        rest = rest[off:] + rest[:off]
    return [head] + rest[: k - 1]


# Checkpoint cert-sig scheme trailer: 4-byte tag + scheme index,
# appended after the frontier entries.  A frontier is only meaningful
# next to a store the running scheme can replay (the boot-time
# _replay_persisted_certificates feeds the DAG between frontier and
# head back into consensus, and cross-scheme certificates refuse to
# decode) — so a checkpoint written under one scheme refuses to restore
# under the other, in both directions, naming both schemes.  A trailer-
# less checkpoint predates the scheme seam and was necessarily written
# under "individual".
_SCHEME_TRAILER_TAG = b"SCHM"
_SCHEME_TRAILER_LEN = len(_SCHEME_TRAILER_TAG) + 1


def _scheme_trailer() -> bytes:
    from ..crypto.aggregate import SCHEMES, scheme

    return _SCHEME_TRAILER_TAG + bytes([SCHEMES.index(scheme())])


def _check_scheme_trailer(blob: bytes, body_len: int) -> None:
    """Validate a checkpoint's scheme trailer against the running
    scheme.  ``body_len`` is the magic+frontier length; raises
    SchemeMismatch (both names) or ValueError on garbage."""
    from ..crypto.aggregate import SCHEMES, SchemeMismatch, scheme

    if len(blob) == body_len:
        written = "individual"  # pre-scheme checkpoint
    elif (
        len(blob) == body_len + _SCHEME_TRAILER_LEN
        and blob[body_len : body_len + 4] == _SCHEME_TRAILER_TAG
        and blob[-1] < len(SCHEMES)
    ):
        written = SCHEMES[blob[-1]]
    else:
        raise ValueError("checkpoint: truncated or oversized blob")
    if written != scheme():
        raise SchemeMismatch(
            f"checkpoint was written under cert-sig scheme {written!r} "
            f"but this node runs {scheme()!r}; refusing to restore — the "
            "persisted store next to it cannot replay across schemes.  "
            "Wipe the checkpoint+store (and accept re-delivery) or run "
            "the matching --cert-sig-scheme"
        )


class CheckpointRuleMismatch(ValueError):
    """A checkpoint written under one commit rule was offered to the
    other.  Deliberately NOT swallowed by the torn-checkpoint tolerance
    in Consensus boot: booting fresh would silently re-commit (and
    re-deliver) everything the other rule already committed — the
    operator flipped the flag on a live store and must be told."""


def resolve_commit_rule(explicit: Optional[str] = None) -> str:
    """Effective commit rule: the explicit (CLI/constructor) value wins,
    else the NARWHAL_COMMIT_RULE env knob, else classic.  Garbage raises
    — a bench arm must never silently measure the wrong rule (the
    NARWHAL_CRYPTO_BACKEND_STRICT precedent)."""
    from ..utils.env import env_str

    rule = explicit if explicit is not None else env_str("NARWHAL_COMMIT_RULE")
    rule = (rule or "classic").strip().lower()
    if rule not in COMMIT_RULES:
        raise ValueError(
            f"unknown commit rule {rule!r}; expected one of {COMMIT_RULES}"
        )
    return rule


class State:
    """Consensus state (reference lib.rs:19-62), indexed.

    Alongside the reference's round-keyed DAG this keeps
    ``digest_index``: digest → certificate for every certificate currently
    in the DAG (genesis included).  The index is maintained by
    :meth:`insert` and pruned by :meth:`gc`, so membership in the index is
    exactly membership in the DAG — ``order_dag``/``linked`` resolve
    parent digests in O(1) instead of scanning a round dict per lookup.
    """

    def __init__(self, genesis_certs: List[Certificate]) -> None:
        gen = {c.origin: (c.digest(), c) for c in genesis_certs}
        self.last_committed_round: Round = 0
        self.last_committed: Dict[PublicKey, Round] = {
            name: cert.round for name, (_, cert) in gen.items()
        }
        self.dag: Dag = {0: gen}
        self.digest_index: Dict[Digest, Certificate] = {
            d: cert for (d, cert) in gen.values()
        }

    _CKPT_MAGIC = b"NCKPT1"
    commit_rule = "classic"

    def snapshot_bytes(self) -> bytes:
        """Canonical encoding of the committed frontier — the part of
        consensus state that crash-recovery needs (the reference marks
        this persisted-state duty as intended-but-unimplemented,
        consensus/src/lib.rs:18-19; here it IS implemented).  The DAG
        itself is not snapshotted: it is rebuilt by the sync machinery,
        and the restored frontier keeps re-synced history out of the
        commit sequence (see order_dag's skip)."""
        out = bytearray(self._CKPT_MAGIC)
        out += struct.pack("<Q", self.last_committed_round)
        items = sorted(self.last_committed.items())
        out += struct.pack("<I", len(items))
        for name, round in items:
            if len(bytes(name)) != 32:
                raise ValueError("checkpoint: authority key must be 32 bytes")
            out += bytes(name) + struct.pack("<Q", round)
        out += _scheme_trailer()
        return bytes(out)

    def restore(self, blob: bytes) -> None:
        """Seed the committed frontier from snapshot_bytes output.
        Validation raises (never asserts — a malformed blob misparsed
        under ``python -O`` would silently wedge the commit rule at a
        garbage frontier), and the WHOLE blob parses before any state
        mutates: a torn checkpoint must leave the fresh frontier intact
        so the caller can fall back to it."""
        if len(blob) >= 6 and blob[:6] != self._CKPT_MAGIC:
            for rule, magic in RULE_MAGICS.items():
                if blob[:6] == magic:
                    raise CheckpointRuleMismatch(
                        f"checkpoint was written by the {rule!r} commit "
                        f"rule but this node runs {self.commit_rule!r}; "
                        "refusing to restore — wipe the checkpoint (and "
                        "accept re-delivery) or run the matching "
                        "--commit-rule"
                    )
        if len(blob) < 18 or blob[:6] != self._CKPT_MAGIC:
            raise ValueError("checkpoint: bad magic")
        (last_round,) = struct.unpack_from("<Q", blob, 6)
        (n,) = struct.unpack_from("<I", blob, 14)
        _check_scheme_trailer(blob, 18 + 40 * n)
        entries = []
        pos = 18
        for _ in range(n):
            name = PublicKey(blob[pos : pos + 32])
            (round,) = struct.unpack_from("<Q", blob, pos + 32)
            entries.append((name, round))
            pos += 40
        self.last_committed_round = last_round
        for name, round in entries:
            self.last_committed[name] = round

    def insert(
        self, certificate: Certificate
    ) -> Tuple[Digest, Optional[Digest]]:
        """Insert into the DAG and digest index.  Returns
        ``(digest, prev_digest)`` where ``prev_digest`` is the digest this
        (round, origin) slot previously held: the same digest for an
        idempotent re-insert (nothing changed), a different digest for an
        equivocation overwrite, or None for a fresh slot — the caller
        (Tusk) uses the distinction to keep its incremental support
        counters exact."""
        d = certificate.digest()
        slot = self.dag.setdefault(certificate.round, {})
        prev = slot.get(certificate.origin)
        if prev is not None and prev[0] == d:
            return d, d
        slot[certificate.origin] = (d, certificate)
        self.digest_index[d] = certificate
        if prev is not None:
            self.digest_index.pop(prev[0], None)
            return d, prev[0]
        return d, None

    def note_committed(self, certificate: Certificate) -> None:
        """O(1) frontier advance for one committed certificate.  The DAG
        sweep is deferred to ONE :meth:`gc` call per commit burst — the
        golden walk's per-certificate full sweep (golden.py
        ``GoldenState.update``) made a K-certificate burst cost K full
        window scans."""
        origin = certificate.origin
        if certificate.round > self.last_committed.get(origin, 0):
            self.last_committed[origin] = certificate.round
        if certificate.round > self.last_committed_round:
            self.last_committed_round = certificate.round

    def gc(self, gc_depth: Round) -> None:
        """One garbage sweep over the window: drop per-authority entries
        strictly below that authority's committed round, whole rounds
        beyond the gc horizon, and empty rounds — pruning the digest
        index in lockstep so index membership stays exactly DAG
        membership.  End-state identical to the golden per-certificate
        sweep (the deferred deletions are all entries the order_dag ≥
        skip already excludes — tests/test_tusk_equivalence.py)."""
        last = self.last_committed_round
        index = self.digest_index
        last_committed = self.last_committed
        for r in list(self.dag):
            authorities = self.dag[r]
            if r + gc_depth < last:
                for d, _ in authorities.values():
                    index.pop(d, None)
                del self.dag[r]
                continue
            dead = [
                name
                for name in authorities
                if r < last_committed.get(name, 0)
            ]
            for name in dead:
                index.pop(authorities[name][0], None)
                del authorities[name]
            if not authorities:
                del self.dag[r]

class LowDepthState(State):
    """State for the lower-depth rule: identical structure, its own
    checkpoint magic (rationale at RULE_MAGICS)."""

    _CKPT_MAGIC = RULE_MAGICS["lowdepth"]
    commit_rule = "lowdepth"


class MultiLeaderState(State):
    """State for the multi-leader rule: identical structure, its own
    checkpoint magic (rationale at RULE_MAGICS)."""

    _CKPT_MAGIC = RULE_MAGICS["multileader"]
    commit_rule = "multileader"


class Tusk:
    """The pure commit rule: feed certificates, get ordered commit batches."""

    STATE_CLS = State
    commit_rule = "classic"

    def __init__(
        self, committee: Committee, gc_depth: Round, fixed_coin: bool = False
    ) -> None:
        self.committee = committee
        self.gc_depth = gc_depth
        # fixed_coin pins the leader to the first authority — the reference's
        # #[cfg(test)] coin = 0 (lib.rs:209-212) used by the golden tests.
        self.fixed_coin = fixed_coin
        self.state = self.STATE_CLS(genesis(committee))
        self._sorted_keys = sorted(committee.authorities.keys())
        # Incremental f+1 support: even leader round → accumulated stake of
        # round+1 certificates citing the leader's digest.  Maintained by
        # insert_certificate; equal at every query point to the golden
        # walk's from-scratch rescan of the child round (the rare
        # equivocation-overwrite path recomputes instead of patching).
        self._support: Dict[Round, int] = {}
        # Optional hook fired from the incremental bump with
        # (leader_round, old_stake, new_stake, supporter) — Consensus
        # attaches its support-arrival-spread and straggler-attribution
        # accounting here (the supporter whose bump crosses the quorum
        # line is the validator that closed it).  Only the hot
        # incremental path fires it: the cold recompute paths
        # (leader-after-supporters, equivocation overwrite) reconstruct
        # stake totals but not arrival ORDER, so they stay silent.
        self.support_observer: Optional[
            Callable[[Round, int, int, PublicKey], None]
        ] = None

    def leader(self, round: Round, dag: Dag) -> Optional[Tuple[Digest, Certificate]]:
        """Round-robin leader (a common coin in the full protocol —
        reference lib.rs:205-221)."""
        return dag.get(round, {}).get(self._leader_name(round))

    def _leader_name(self, round_: Round) -> PublicKey:
        coin = 0 if self.fixed_coin else round_
        return self._sorted_keys[coin % len(self._sorted_keys)]

    def insert_certificate(self, certificate: Certificate) -> None:
        """Insert into the DAG without running the commit rule.  Separate
        seam so KernelTusk can maintain its dense device window
        incrementally, and benchmarks can build large DAG states.  Also
        the single maintenance point for the digest index (via
        State.insert) and the incremental leader-support counters."""
        d, prev = self.state.insert(certificate)
        if prev is not None and prev == d:
            return  # idempotent re-insert: counters already reflect it
        r = certificate.round
        if prev is None:
            # Fresh slot: incremental support accounting.
            if r % 2 == 1 and r >= 3:
                # This certificate may support the leader of round r-1.
                got = self.leader(r - 1, self.state.dag)
                if got is not None and got[0] in certificate.header.parents:
                    old = self._support.get(r - 1, 0)
                    new = old + self.committee.stake(certificate.origin)
                    self._support[r - 1] = new
                    if self.support_observer is not None:
                        self.support_observer(
                            r - 1, old, new, certificate.origin
                        )
            elif (
                r % 2 == 0
                and r >= 2
                and certificate.origin == self._leader_name(r)
            ):
                # The leader itself arrived (possibly after some of its
                # supporters): seed its counter from the children already
                # present — one O(N) scan per leader insert, not per
                # arrival.
                self._recompute_support(r)
        else:
            # Equivocation overwrite (same slot, different digest): the
            # old certificate's contributions are baked into the counters.
            # Rare and adversarial — recompute the affected round exactly.
            if r % 2 == 1 and r >= 3:
                self._recompute_support(r - 1)
            elif (
                r % 2 == 0
                and r >= 2
                and certificate.origin == self._leader_name(r)
            ):
                self._recompute_support(r)

    def _recompute_support(self, leader_round: Round) -> None:
        """From-scratch support for one leader round (the golden rescan,
        used only on the cold paths: leader arriving after supporters, or
        an equivocation overwrite)."""
        got = self.leader(leader_round, self.state.dag)
        if got is None:
            self._support.pop(leader_round, None)
            return
        leader_digest = got[0]
        self._support[leader_round] = sum(
            self.committee.stake(cert.origin)
            for _, cert in self.state.dag.get(leader_round + 1, {}).values()
            if leader_digest in cert.header.parents
        )

    def process_certificate(self, certificate: Certificate) -> List[Certificate]:
        """Insert a certificate; return the newly committed sequence
        (possibly empty).  Reference lib.rs:105-201."""
        state = self.state
        round = certificate.round
        self.insert_certificate(certificate)

        # Order from the highest round with a 2f+1 frontier (needed to
        # reveal the common coin).  Leaders live on even rounds.
        r = round - 1
        if r % 2 != 0 or r < 4:
            return []
        leader_round = r - 2
        if leader_round <= state.last_committed_round:
            return []
        got = self.leader(leader_round, state.dag)
        if got is None:
            return []
        _, leader = got

        # f+1 support among the children (round r-1 certificates) — an
        # O(1) read of the incrementally-accumulated counter.
        if self._support.get(leader_round, 0) < self.committee.validity_threshold():
            log.debug("Leader %r does not have enough support", leader)
            return []

        # Commit every linked uncommitted leader, oldest first, each
        # flattening its causal sub-DAG.  The frontier advances per
        # certificate (order_dag's skip must see it), but the garbage
        # sweep runs ONCE for the whole burst.
        log.debug("Leader %r has enough support", leader)
        sequence: List[Certificate] = []
        for past_leader in reversed(self.order_leaders(leader)):
            for x in self.order_dag(past_leader):
                state.note_committed(x)
                sequence.append(x)
        if sequence:
            state.gc(self.gc_depth)
            # Support for rounds at/below the new frontier can never be
            # queried again (the leader_round <= last_committed_round
            # short-circuit above) — prune so the dict tracks the live
            # window only.
            last = state.last_committed_round
            for lr in [k for k in self._support if k <= last]:
                del self._support[lr]
        return sequence

    def order_leaders(self, leader: Certificate) -> List[Certificate]:
        """The whole linked-leader chain in ONE descending frontier pass
        (reference lib.rs:224-244 walks back two rounds at a time and
        runs a fresh ``linked()`` BFS over the window per earlier leader
        — O(leaders × window)).  The frontier at round r is the causal
        cone of the current chain head; when it reaches the leader of an
        even round, that leader joins the chain and the frontier RESETS
        to it alone — exactly the reference's ``leader = prev_leader``
        rebinding, and exactly the semantics the device kernel's
        ``_chain_scan`` executes (ops/reachability.py), which the
        equivalence suite validated certificate-for-certificate.
        Parent digests resolve through the digest index, so each hop is
        O(frontier edges)."""
        state = self.state
        index = state.digest_index
        to_commit = [leader]
        frontier = [leader]
        for r in range(
            leader.round - 1, state.last_committed_round, -1
        ):
            wanted = set()
            for x in frontier:
                wanted.update(x.header.parents)
            frontier = [
                certificate
                for digest in wanted
                if (certificate := index.get(digest)) is not None
                and certificate.round == r
            ]
            if not frontier:
                # Empty causal cone: nothing deeper can be linked.
                break
            if r % 2 == 0:
                got = self.leader(r, state.dag)
                if got is None:
                    continue
                _, prev_leader = got
                if any(
                    x is prev_leader or x == prev_leader for x in frontier
                ):
                    to_commit.append(prev_leader)
                    frontier = [prev_leader]
        return to_commit

    # NOTE: the reference's per-pair ``linked()`` BFS (lib.rs:247-259) has
    # no standalone counterpart here — its reachability question is
    # answered inside order_leaders' single frontier pass (the TPU kernel
    # re-expresses the same loop as boolean adjacency-matrix products).
    # The frozen oracle keeps the original per-pair form (golden.py).

    def order_dag(self, leader: Certificate) -> List[Certificate]:
        """DFS flatten of the leader's causal history, skipping
        already-committed certificates (reference lib.rs:263-303).
        Parent digests resolve through the digest index in O(1); the
        round check preserves the golden walk's only-look-one-round-down
        discipline (a digest present at any other round is not a DAG
        edge)."""
        state = self.state
        index = state.digest_index
        last_committed = state.last_committed
        ordered: List[Certificate] = []
        already_ordered = set()
        buffer = [leader]
        while buffer:
            x = buffer.pop()
            ordered.append(x)
            # Sorted iteration (the reference's BTreeSet order): a Python
            # set's iteration order depends on insertion history, which
            # differs between the author's in-memory header and decoded
            # copies — unsorted DFS would give each node a different
            # intra-round commit order.
            for parent in sorted(x.header.parents):
                certificate = index.get(parent)
                if certificate is None or certificate.round != x.round - 1:
                    continue  # already ordered or GC'd up to here
                skip = parent in already_ordered
                # ≥, not ==: in-process they are equivalent (the gc sweep
                # deletes every DAG entry strictly below an authority's
                # last-committed round, so only the boundary round can
                # still be encountered — the reference's equality check,
                # lib.rs:263-303, relies on exactly that), but after a
                # checkpoint restore the DAG is rebuilt by sync from
                # BEFORE the committed frontier and older rounds reappear;
                # ≥ keeps them out of the sequence.
                skip |= (
                    last_committed.get(certificate.origin, -1)
                    >= certificate.round
                )
                if not skip:
                    buffer.append(certificate)
                    already_ordered.add(parent)
        # Never commit garbage-collected certificates.
        ordered = [
            x
            for x in ordered
            if x.round + self.gc_depth >= state.last_committed_round
        ]
        ordered.sort(key=lambda x: x.round)  # stable: prettier sequence
        return ordered


class LowDepthTusk(Tusk):
    """Mysticeti-style lower-depth commit rule (arXiv:2310.14821),
    layered on the indexed incremental state.

    The classic rule commits the round-L leader when a round-(L+3)
    certificate arrives and f+1 round-(L+1) certificates cite the leader
    — commit depth 3.  This rule commits the leader the moment its
    DIRECT support (round-(L+1) certificates citing it) reaches 2f+1
    stake, i.e. on the odd-round arrival that crosses the threshold (or
    on the leader's own late arrival once its children already carry the
    quorum) — commit depth 1 on the leader itself and ~2 averaged over
    the flattened window, which is where the cert→commit cadence cut
    comes from (97-98% of that latency is commit depth × round period,
    per the commit-path attribution).

    Why the stronger 2f+1 gate makes the lower depth safe: once 2f+1
    stake of round-(L+1) certificates cite the leader, ANY certificate
    at round ≥ L+2 has 2f+1 parents at the round below whose
    intersection with the support set carries f+1 stake — so every later
    anchor is provably linked to this leader, and a node that never ran
    the direct path (it committed a later anchor first) orders this
    leader at exactly the same position through the INDIRECT path: the
    inherited ``order_leaders`` chain walk, whose linked/skip decisions
    are a pure function of the DAG because Core only delivers causally
    complete certificates.  Skipped leaders (support forever < 2f+1 and
    unlinked) stay skipped on every node for the same reason.

    Commit sequences DIFFER from Tusk by design, so this rule is judged
    against its own frozen oracle (``consensus/golden_lowdepth.py``),
    never against GoldenTusk; checkpoints carry the ``NCKLD1`` magic and
    refuse a cross-rule restore.  The support counters, index, GC and
    flatten are all the inherited commit-path machinery — only the decision
    gate and the trigger shape differ."""

    STATE_CLS = LowDepthState
    commit_rule = "lowdepth"

    def process_certificate(self, certificate: Certificate) -> List[Certificate]:
        state = self.state
        round = certificate.round
        self.insert_certificate(certificate)

        # Which leader can this arrival have affected?  Odd-round
        # certificates add direct support for their round-(r-1) leader
        # (insert_certificate just bumped the counter); the round-r
        # leader itself arriving makes already-present support countable
        # (the counter was just seeded).  Anything else cannot change a
        # direct-commit decision and returns without walking.
        if round % 2 == 1:
            leader_round = round - 1
        elif certificate.origin == self._leader_name(round):
            leader_round = round
        else:
            return []
        if leader_round < 2 or leader_round <= state.last_committed_round:
            return []
        got = self.leader(leader_round, state.dag)
        if got is None:
            return []
        _, leader = got

        # DIRECT gate: 2f+1 support — an O(1) read of the same
        # incrementally-accumulated counter the classic rule reads at
        # f+1 (class docstring for why the stronger quorum is what buys
        # the lower depth).
        if self._support.get(leader_round, 0) < self.committee.quorum_threshold():
            return []

        log.debug("Leader %r has direct 2f+1 support", leader)
        sequence: List[Certificate] = []
        for past_leader in reversed(self.order_leaders(leader)):
            for x in self.order_dag(past_leader):
                state.note_committed(x)
                sequence.append(x)
        if sequence:
            state.gc(self.gc_depth)
            last = state.last_committed_round
            for lr in [k for k in self._support if k <= last]:
                del self._support[lr]
        return sequence


class MultiLeaderTusk(Tusk):
    """Mysticeti-style multi-leader commit rule (arXiv:2310.14821 §4,
    "multiple leaders per round"), layered on the indexed state.

    One leader per even round leaves the commit cadence hostage to one
    validator's support-arrival luck: the lowdepth rule's 2.05× win at
    N=4 collapses to ~1.0–1.3× at N=10/20 because a header's parents
    are exactly the FIRST 2f+1 certificates of the round (the
    round-advance quorum), so each round-(L+1) certificate cites the
    round-L leader with probability ≈ 2/3 and the leader's direct
    support hovers AT the quorum line (artifacts/commit_rule_ab_r20.json
    caveat).  This rule gives every even round K = ``MULTILEADER_SLOTS``
    leader slots (schedule: :func:`leader_slots`) so any supported slot
    can anchor the round's commit, and pairs with the Proposer's
    ``header_linger_ms`` knob, which widens parent sets past the bare
    quorum so slot support stops being borderline.

    Decision rules (all pure functions of the DAG, which is what makes
    the commit sequence a cross-node-consistent prefix — the same
    property the other two rules lean on):

    - **direct support**: stake of round-(L+1) certificates citing slot
      s's leader digest, accumulated INCREMENTALLY per (round, slot) at
      insert time — the per-leader counters of the classic rule,
      extended per-slot.
    - **dead slot**: ≥ 2f+1 stake of round-(L+1) certificates exist
      that do NOT cite the slot leader.  Final and view-independent: at
      most f stake of child certificates remain unseen, so the slot's
      support can never reach 2f+1 anywhere.
    - **direct anchor**: the commit scan walks slots 0..K-1 in order
      and anchors on the LOWEST slot whose support reaches 2f+1, but
      only if every lower slot is dead — a lower slot that is merely
      *undecided* (neither 2f+1 support nor 2f+1 non-support yet) could
      still anchor on another node, so acting past it would fork the
      sequence.  Two nodes that direct-anchor the same round therefore
      anchor the SAME slot: slot s anchoring here means every lower
      slot has ≤ f support, while slot t < s anchoring elsewhere would
      need 2f+1 — impossible in one 3f+1-stake child round.
    - **indirect (chain walk)**: while descending the committed chain,
      the member for even round r is the first slot whose leader has
      f+1 stake of supporters INSIDE the walk frontier (the causal cone
      of the nearest committed anchor above — Mysticeti's "indirect
      decision via the first committed anchor", which is what makes it
      identical on every node).  A direct-anchored slot always
      re-derives: its 2f+1 supporters intersect the ≥ 2f+1-stake cone
      at every round in f+1 stake, while dead lower slots (≤ f global
      support) can never reach f+1 cone support.

    The anchor's causal sub-DAG is ordered exactly as today: the
    inherited ``order_dag`` flatten, ``note_committed`` frontier
    advance, and one ``State.gc`` sweep per burst.  Commit sequences
    DIFFER from both other rules by design, so this rule is judged
    against its own frozen oracle (``consensus/golden_multileader.py``);
    checkpoints carry the ``NCKML1`` magic and refuse a cross-rule
    restore."""

    STATE_CLS = MultiLeaderState
    commit_rule = "multileader"

    def __init__(
        self, committee: Committee, gc_depth: Round, fixed_coin: bool = False
    ) -> None:
        super().__init__(committee, gc_depth, fixed_coin=fixed_coin)
        # (even leader round, slot) → accumulated stake of round+1
        # certificates citing that slot leader's digest.  The base
        # class's single-leader ``_support`` dict stays empty (this
        # class overrides both maintenance points).
        self._slot_support: Dict[Tuple[Round, int], int] = {}
        # even leader round → accumulated stake of round+1 certificates
        # present at all (the denominator of the dead-slot rule).
        self._child_stake: Dict[Round, int] = {}
        # round → slot schedule; rebuilt on demand, pruned with the
        # counters (one SHA-256 per round otherwise recomputed per
        # child-certificate insert).
        self._slot_cache: Dict[Round, List[PublicKey]] = {}
        # (leader_round, anchor_slot) of the most recent direct anchor —
        # the runner annotates the commit flight event with it so a
        # missed-slot round is readable on the Perfetto timeline.
        self.last_anchor: Optional[Tuple[Round, int]] = None

    def _slots(self, round_: Round) -> List[PublicKey]:
        slots = self._slot_cache.get(round_)
        if slots is None:
            slots = leader_slots(
                self._sorted_keys, round_, fixed_coin=self.fixed_coin
            )
            self._slot_cache[round_] = slots
        return slots

    def insert_certificate(self, certificate: Certificate) -> None:
        d, prev = self.state.insert(certificate)
        if prev is not None and prev == d:
            return  # idempotent re-insert: counters already reflect it
        r = certificate.round
        dag = self.state.dag
        if prev is None:
            if r % 2 == 1 and r >= 3:
                # Fresh child certificate: count it once toward the
                # round's child stake, and toward every slot leader it
                # cites — the classic incremental bump, per slot.
                stake = self.committee.stake(certificate.origin)
                self._child_stake[r - 1] = (
                    self._child_stake.get(r - 1, 0) + stake
                )
                slot_row = dag.get(r - 1, {})
                parents = certificate.header.parents
                for s, name in enumerate(self._slots(r - 1)):
                    got = slot_row.get(name)
                    if got is not None and got[0] in parents:
                        old = self._slot_support.get((r - 1, s), 0)
                        new = old + stake
                        self._slot_support[(r - 1, s)] = new
                        if s == 0 and self.support_observer is not None:
                            # Slot 0 is the round's primary anchor slot:
                            # its quorum spread is what
                            # consensus.support_arrival_ms prices, same
                            # clock and semantics as the other rules.
                            self.support_observer(
                                r - 1, old, new, certificate.origin
                            )
            elif r % 2 == 0 and r >= 2 and certificate.origin in set(
                self._slots(r)
            ):
                # A slot leader arrived (possibly after some of its
                # supporters): seed its counter from the children
                # already present.
                self._recompute_slot_support(r)
        else:
            # Equivocation overwrite: recompute the affected round
            # exactly (rare and adversarial, same policy as the base).
            if r % 2 == 1 and r >= 3:
                self._recompute_slot_support(r - 1)
            elif r % 2 == 0 and r >= 2 and certificate.origin in set(
                self._slots(r)
            ):
                self._recompute_slot_support(r)

    def _recompute_slot_support(self, leader_round: Round) -> None:
        """From-scratch per-slot support and child stake for one leader
        round (cold paths only: a slot leader arriving after supporters,
        or an equivocation overwrite)."""
        dag = self.state.dag
        slot_row = dag.get(leader_round, {})
        children = dag.get(leader_round + 1, {}).values()
        stakes = [
            (self.committee.stake(cert.origin), cert.header.parents)
            for _, cert in children
        ]
        self._child_stake[leader_round] = sum(s for s, _ in stakes)
        for s, name in enumerate(self._slots(leader_round)):
            got = slot_row.get(name)
            if got is None:
                self._slot_support.pop((leader_round, s), None)
                continue
            digest = got[0]
            self._slot_support[(leader_round, s)] = sum(
                stake for stake, parents in stakes if digest in parents
            )

    def _direct_anchor(
        self, leader_round: Round
    ) -> Optional[Tuple[Certificate, int]]:
        """Slot-ordered anchor scan: the lowest slot with 2f+1 direct
        support, provided every lower slot is provably dead (class
        docstring).  Returns (anchor certificate, slot) or None."""
        quorum = self.committee.quorum_threshold()
        child_stake = self._child_stake.get(leader_round, 0)
        slot_row = self.state.dag.get(leader_round, {})
        for s, name in enumerate(self._slots(leader_round)):
            support = self._slot_support.get((leader_round, s), 0)
            if support >= quorum:
                got = slot_row.get(name)
                if got is None:
                    # Supporters cite a digest this DAG no longer holds
                    # (equivocation overwrite race) — not anchorable.
                    return None
                return got[1], s
            if child_stake - support < quorum:
                # Undecided slot: it may still reach quorum, so no
                # higher slot may anchor past it yet.
                return None
            # Dead slot (≤ f stake can ever cite it): scan on.
        return None

    def _cone_member(
        self, leader_round: Round, frontier: List[Certificate]
    ) -> Optional[Certificate]:
        """Chain member for an even round during the descent: the first
        slot whose leader has f+1 stake of supporters among the frontier
        (= the causal cone of the nearest committed anchor above, at
        round leader_round+1) — the indirect decision, identical on
        every node because the cone is a pure function of the DAG."""
        validity = self.committee.validity_threshold()
        slot_row = self.state.dag.get(leader_round, {})
        for name in self._slots(leader_round):
            got = slot_row.get(name)
            if got is None:
                continue
            digest = got[0]
            support = sum(
                self.committee.stake(x.origin)
                for x in frontier
                if digest in x.header.parents
            )
            if support >= validity:
                return got[1]
        return None

    def order_leaders(self, leader: Certificate) -> List[Certificate]:
        """Same single descending frontier pass as the base walk, but
        the even-round membership test is the per-slot cone decision
        (``_cone_member``) instead of the fixed single-leader lookup."""
        state = self.state
        index = state.digest_index
        to_commit = [leader]
        frontier = [leader]
        fr = leader.round
        while fr - 1 > state.last_committed_round:
            wanted = set()
            for x in frontier:
                wanted.update(x.header.parents)
            nxt = [
                certificate
                for digest in wanted
                if (certificate := index.get(digest)) is not None
                and certificate.round == fr - 1
            ]
            if not nxt:
                # Empty causal cone: nothing deeper can be linked.
                break
            frontier = nxt
            fr -= 1
            if fr % 2 == 1 and fr - 1 > state.last_committed_round:
                # The frontier sits at the child round of even round
                # fr-1: decide that round's chain member inside it.
                member = self._cone_member(fr - 1, frontier)
                if member is not None:
                    to_commit.append(member)
                    frontier = [member]
                    fr -= 1
        return to_commit

    def process_certificate(self, certificate: Certificate) -> List[Certificate]:
        state = self.state
        round = certificate.round
        self.insert_certificate(certificate)

        # Which leader round can this arrival have affected?  Odd-round
        # certificates change slot support / child stake for round r-1
        # (both the quorum and the dead-slot side of the scan); a slot
        # leader's own arrival makes already-present support countable.
        if round % 2 == 1:
            leader_round = round - 1
        elif certificate.origin in set(self._slots(round)):
            leader_round = round
        else:
            return []
        if leader_round < 2 or leader_round <= state.last_committed_round:
            return []

        anchor = self._direct_anchor(leader_round)
        if anchor is None:
            return []
        leader, slot = anchor
        self.last_anchor = (leader_round, slot)

        log.debug(
            "Slot %d leader %r has direct 2f+1 support", slot, leader
        )
        sequence: List[Certificate] = []
        for past_leader in reversed(self.order_leaders(leader)):
            for x in self.order_dag(past_leader):
                state.note_committed(x)
                sequence.append(x)
        if sequence:
            state.gc(self.gc_depth)
            last = state.last_committed_round
            for key in [k for k in self._slot_support if k[0] <= last]:
                del self._slot_support[key]
            for lr in [k for k in self._child_stake if k <= last]:
                del self._child_stake[lr]
            for lr in [k for k in self._slot_cache if k <= last]:
                del self._slot_cache[lr]
        return sequence


def _sweep_checkpoint_tmps(checkpoint_path: str) -> None:
    """Unlink `<basename>.tmp.*` leftovers beside the checkpoint (boot
    only; see the call site in Consensus.__init__)."""
    directory = os.path.dirname(checkpoint_path) or "."
    prefix = os.path.basename(checkpoint_path) + ".tmp."
    try:
        entries = os.listdir(directory)
    except OSError:
        return  # directory missing: the writer will report it per burst
    for name in entries:
        if name.startswith(prefix):
            try:
                os.unlink(os.path.join(directory, name))
            except OSError:
                pass


class Consensus:
    """Async runner: certificates in from the primary, ordered certificates
    out to the application and back to the primary for GC."""

    # Upper bound on certificates drained per wakeup: keeps one flood from
    # monopolizing the loop while still collapsing a backlog into one
    # scheduling slice.
    MAX_DRAIN = 256

    def __init__(
        self,
        committee: Committee,
        gc_depth: Round,
        rx_primary: asyncio.Queue,
        tx_primary: asyncio.Queue,
        tx_output: asyncio.Queue,
        benchmark: bool = False,
        fixed_coin: bool = False,
        use_kernel: bool = False,
        checkpoint_path: Optional[str] = None,
        audit_path: Optional[str] = None,
        commit_rule: Optional[str] = None,
        device=None,
    ) -> None:
        # Commit-rule selection (constructor arg > NARWHAL_COMMIT_RULE >
        # classic) happens HERE so every harness that builds a Consensus
        # rides the same resolution the node CLI does.
        rule = resolve_commit_rule(commit_rule)
        self.commit_rule = rule
        if use_kernel:
            if rule != "classic":
                raise ValueError(
                    "--experimental-consensus-kernel implements the "
                    "classic walk only; it cannot run commit rule "
                    f"{rule!r}"
                )
            # Deferred: the pure-CPU node path must not pay the torch import.
            from ..ops.reachability import KernelTusk

            self.tusk = KernelTusk(
                committee, gc_depth, fixed_coin=fixed_coin, device=device
            )
        elif rule == "lowdepth":
            self.tusk = LowDepthTusk(committee, gc_depth, fixed_coin=fixed_coin)
        elif rule == "multileader":
            self.tusk = MultiLeaderTusk(
                committee, gc_depth, fixed_coin=fixed_coin
            )
        else:
            self.tusk = Tusk(committee, gc_depth, fixed_coin=fixed_coin)
        self.rx_primary = rx_primary
        self.tx_primary = tx_primary
        self.tx_output = tx_output
        self.benchmark = benchmark
        self._m_certs_in = metrics.counter("consensus.certificates_in")
        self._m_commits = metrics.counter("consensus.committed_certificates")
        self._m_batches = metrics.counter("consensus.committed_batch_digests")
        self._m_commit_batch = metrics.histogram(
            "consensus.commit_batch_size", metrics.COUNT_BUCKETS
        )
        # Commit-path attribution: how long one triggering
        # process_certificate call takes (insert + chain walk + flatten),
        # and how many queued certificates each runner wakeup drains.
        self._m_walk = metrics.histogram("consensus.commit_walk_seconds")
        self._m_drain = metrics.histogram(
            "consensus.drain_batch_size", metrics.COUNT_BUCKETS
        )
        # Per-certificate insert→commit latency on the LOOP clock
        # (``loop_now``): wall-identical to the trace sub-legs on a live
        # node, but VIRTUAL under the simulation — which is what lets a
        # sim flag-flip sweep price a commit-rule latency claim in
        # protocol time before any socketed run.  The timestamp map is
        # pure metrics bookkeeping, so it is skipped entirely when the
        # registry is disabled.
        self._m_c2c = metrics.histogram("consensus.cert_to_commit_seconds")
        self._c2c_on = metrics.registry().enabled
        self._insert_ts: Dict[bytes, Tuple[Round, float]] = {}
        self._insert_head: Round = 0
        # Sweep trigger for the timestamp map: twice the steady-state
        # ceiling (one cert per (round, authority) inside the GC window).
        # Under it, commits pop entries and the sweep never runs; a
        # stalled-but-receiving node crosses it and gets pruned back.
        self._c2c_cap = 2 * gc_depth * len(committee.authorities)
        self._m_round = metrics.gauge("consensus.last_committed_round")
        self._m_lag = metrics.gauge("consensus.commit_lag_rounds")
        self._mtrace = metrics.trace()
        # Support-arrival spread: per leader round, the loop-clock span
        # from the FIRST direct supporter landing to the arrival that
        # crossed the 2f+1 quorum line — how long a lower-depth commit
        # rule would wait past first contact (the multi-leader flip's
        # before-number).  Driven from Tusk's incremental support bump,
        # so it measures arrival ORDER on the same clock cert_to_commit
        # uses: wall time on a live node, virtual time under the sim.
        self._m_support_arrival = metrics.histogram(
            "consensus.support_arrival_ms", metrics.LATENCY_MS_BUCKETS
        )
        self._support_first: Dict[Round, float] = {}
        # Support-quorum straggler attribution: the validator whose
        # direct-support bump crossed the 2f+1 line CLOSED that leader's
        # support quorum — count it by primary address, so metrics_check
        # can rank "which validator's luck gates the lowdepth rule"
        # committee-wide (the gap itself is support_arrival_ms above).
        self._m_support_straggler = {
            n: metrics.counter(
                f"consensus.support_straggler."
                f"{a.primary.primary_to_primary}"
            )
            for n, a in committee.authorities.items()
        }
        # Multileader anchor-slot distribution: which slot index anchored
        # each direct commit.  Slot 0 dominating means the primary slot
        # is healthy; weight on higher slots means the backup slots are
        # earning their keep (a dead/undecided slot 0 was skipped).
        self._m_anchor_slot = (
            {
                s: metrics.counter(f"consensus.anchor_slot.{s}")
                for s in range(MULTILEADER_SLOTS)
            }
            if rule == "multileader"
            else {}
        )
        if self._c2c_on:
            _quorum = committee.quorum_threshold()

            def _observe_support(
                leader_round: Round,
                old_stake: int,
                new_stake: int,
                supporter: PublicKey,
            ) -> None:
                now = loop_now()
                first = self._support_first.setdefault(leader_round, now)
                if old_stake < _quorum <= new_stake:
                    self._m_support_arrival.observe(1000.0 * (now - first))
                    counter = self._m_support_straggler.get(supporter)
                    if counter is not None:
                        counter.inc()

            self.tusk.support_observer = _observe_support
        # Crash-recovery of the committed frontier (beyond reference
        # parity — it leaves consensus state unpersisted,
        # consensus/src/lib.rs:18-19).  The checkpoint is its own small
        # file rewritten atomically (write-temp + os.replace), NOT a
        # record in the append-only store log — only the latest frontier
        # is live, so appending one per commit batch would grow the log
        # and every boot-time replay without bound.  What it buys a
        # restarted node: order_leaders and the GC filter anchor at the
        # true frontier instead of round 0, and pre-crash certificates
        # replayed INTO consensus (a lagging peer's catch-up flood routed
        # through the Core) stay out of the commit sequence (order_dag's
        # ≥ skip) — demonstrated directly in tests/test_consensus.py::
        # test_checkpoint_restore_resumes_without_redelivery.  (On a
        # store-preserving restart with healthy peers, history doesn't
        # reach consensus at all — the persisted header/cert store
        # satisfies dependency checks without replay — so the checkpoint
        # is the backstop for the paths where it does.)
        self.checkpoint_path = checkpoint_path
        if checkpoint_path is not None:
            # Sweep tmp files stranded by a crash between mkstemp and
            # os.replace (unique names are what make concurrent writers
            # safe, but uniqueness also means nothing reuses a stranded
            # one — without this, a crash-looping node grows one stale
            # tmp per incarnation forever).  Only OUR basename's tmps;
            # a concurrently-running sibling instance would have to be
            # mid-write on the same path to lose one, which the unique
            # names exist to make harmless anyway (it retries next
            # burst).
            _sweep_checkpoint_tmps(checkpoint_path)
        restored_blob = b""
        if checkpoint_path is not None and os.path.exists(checkpoint_path):
            try:
                with open(checkpoint_path, "rb") as f:
                    blob = f.read()
                self.tusk.state.restore(blob)
                restored_blob = blob
            except CheckpointRuleMismatch:
                # The ONE restore failure that must not fall back to a
                # fresh frontier: the file is a healthy checkpoint from
                # the OTHER commit rule (operator flipped the flag on a
                # live store).  Booting fresh would silently replay and
                # re-commit everything the other rule already delivered
                # — refuse instead, naming the fix.
                log.exception(
                    "Checkpoint %s belongs to the other commit rule; "
                    "REFUSING to boot (this node runs %r)",
                    checkpoint_path, rule,
                )
                raise
            except Exception:
                # A torn/corrupt checkpoint must not crash-loop the node:
                # the file is a recovery OPTIMIZATION (restore validates
                # before mutating, so the fresh frontier below is intact).
                # Booting fresh is always safe — at worst already-committed
                # certificates re-deliver, dedupable downstream by digest.
                log.exception(
                    "Checkpoint %s is corrupt or torn; IGNORING it and "
                    "booting from a fresh consensus frontier",
                    checkpoint_path,
                )
            else:
                if hasattr(self.tusk, "_win_shift"):
                    # Realign the kernel's dense window to the restored
                    # frontier (slot 0 == last_committed_round).
                    self.tusk._win_shift()
                log.info(
                    "Restored consensus frontier at round %d",
                    self.tusk.state.last_committed_round,
                )
        # Fault-suite audit segment (consensus/replay.py): every inserted
        # certificate and every committed digest, for golden-oracle replay
        # — the safety verdict's raw material.  One segment per process
        # incarnation; the restore marker anchors the oracle at the same
        # frontier this instance booted with.
        self._audit = None
        if audit_path:
            from .replay import AuditWriter

            self._audit = AuditWriter(audit_path)
            self._audit.restore_marker(restored_blob)
            # The rule marker makes every segment self-describing: the
            # replay judge picks the matching frozen oracle per segment
            # (GoldenTusk / GoldenLowDepthTusk / GoldenMultiLeaderTusk)
            # instead of assuming a process-wide flag — a flag-flip
            # sweep's arms then judge themselves correctly with no
            # harness plumbing.
            self._audit.rule_marker(rule)
            self._audit.flush()

    async def run(self) -> None:
        while True:
            # Burst-drain: one wakeup processes the whole backlog (a sync
            # release, a slow scheduling slice on a shared core, or a
            # catch-up flood queues many certificates), instead of paying
            # one task switch per certificate.
            batch = [await self.rx_primary.get()]
            while len(batch) < self.MAX_DRAIN:
                try:
                    batch.append(self.rx_primary.get_nowait())
                except asyncio.QueueEmpty:
                    break
            self._m_drain.observe(len(batch))
            committed_any = False
            loop_ts = loop_now()
            for certificate in batch:
                self._m_certs_in.inc()
                if self._c2c_on:
                    self._insert_ts.setdefault(
                        bytes(certificate.digest()),
                        (certificate.round, loop_ts),
                    )
                    if certificate.round > self._insert_head:
                        self._insert_head = certificate.round
                if self._audit is not None:
                    self._audit.insert(certificate)
                # cert_inserted: the certificate's payload entered the
                # commit rule's state — the start of the cert→commit
                # sub-span attribution.
                if certificate.header.payload:
                    now = time.time()
                    for digest in certificate.header.payload:
                        self._mtrace.mark(
                            bytes(digest).hex(), "cert_inserted", ts=now
                        )
                t0 = time.time()
                sequence = self.tusk.process_certificate(certificate)
                t_walk = time.time()
                state = self.tusk.state
                # Committed-certificate lag: how far the DAG head has run
                # ahead of the committed frontier.  A steadily growing lag
                # means the commit rule is starved (missing leader
                # support) while certificates keep arriving.
                self._m_lag.set(
                    max(0, certificate.round - state.last_committed_round)
                )
                self._m_round.set(state.last_committed_round)
                if sequence:
                    committed_any = True
                    self._m_commits.inc(len(sequence))
                    self._m_commit_batch.observe(len(sequence))
                    self._m_walk.observe(t_walk - t0)
                    # Flight-ring landmark: one event per commit burst
                    # (not per cert — bursts are the protocol unit and
                    # the ring is bounded).  Under the multileader rule
                    # the burst also carries its anchor (leader round +
                    # slot index) and that round's slot schedule, so the
                    # Perfetto export can show which slot anchored and
                    # which slots were passed over.
                    extra = {}
                    anchor = getattr(self.tusk, "last_anchor", None)
                    if anchor is not None:
                        anchor_round, anchor_slot = anchor
                        extra = {
                            "anchor_round": anchor_round,
                            "anchor_slot": anchor_slot,
                            "slots": ",".join(
                                bytes(name).hex()[:8]
                                for name in self.tusk._slots(anchor_round)
                            ),
                        }
                        counter = self._m_anchor_slot.get(anchor_slot)
                        if counter is not None:
                            counter.inc()
                    metrics.flight_event(
                        "commit",
                        certs=len(sequence),
                        batches=sum(
                            len(c.header.payload) for c in sequence
                        ),
                        round=state.last_committed_round,
                        walk_ms=round(1000 * (t_walk - t0), 2),
                        **extra,
                    )
                if sequence:
                    commit_ts = loop_now()
                    for committed in sequence:
                        entry = self._insert_ts.pop(
                            bytes(committed.digest()), None
                        )
                        if entry is not None:
                            self._m_c2c.observe(commit_ts - entry[1])
                for committed in sequence:
                    if self._audit is not None:
                        self._audit.commit(committed)
                    header = committed.header
                    self._m_batches.inc(len(header.payload))
                    # commit: the certificate's Committed line, read once
                    # before it is logged and so before the downstream
                    # puts below, whose waits are backpressure, not the
                    # commit a client waits for.
                    now = time.time()
                    for digest in header.payload:
                        h = bytes(digest).hex()
                        # commit_trigger: the arrival that fired the
                        # commit rule (cadence boundary); walk_done: the
                        # chain walk + flatten finished (walk cost).
                        self._mtrace.mark(h, "commit_trigger", ts=t0)
                        self._mtrace.mark(h, "walk_done", ts=t_walk)
                        self._mtrace.mark(h, "commit", ts=now)
                    if self.benchmark and header.payload:
                        for digest in header.payload:
                            # Parsed by the benchmark log parser (reference
                            # lib.rs:185-189).
                            log.info(
                                "Committed B%d(%r) -> %r",
                                header.round,
                                header.id,
                                digest,
                            )
                    else:
                        log.info("Committed B%d(%r)", header.round, header.id)
                    await self.tx_primary.put(committed)
                    await self.tx_output.put(committed)
            if self._c2c_on and len(self._insert_ts) > self._c2c_cap:
                # Prune timestamps the DAG head has outrun — keyed on the
                # HEAD round, not the committed frontier, so the map
                # stays bounded even on a node whose commit rule is
                # stalled (partitioned minority, leader-support drought)
                # while certificates keep arriving.  A pruned certificate
                # that later commits just loses its latency sample (the
                # pop above tolerates a miss).
                horizon = self._insert_head - self.tusk.gc_depth
                if horizon > 0:
                    for d in [
                        d
                        for d, (r, _) in self._insert_ts.items()
                        if r < horizon
                    ]:
                        del self._insert_ts[d]
            if self._c2c_on and len(self._support_first) > self._c2c_cap:
                # Same horizon logic as _insert_ts: first-arrival stamps
                # for leader rounds the DAG head has outrun can never
                # see another supporter (those inserts are GC-dropped).
                horizon = self._insert_head - self.tusk.gc_depth
                if horizon > 0:
                    for lr in [
                        lr for lr in self._support_first if lr < horizon
                    ]:
                        del self._support_first[lr]
            if self._audit is not None:
                # One flush per drained burst: the burst's 'I' and 'C'
                # records land (or tear) together, which is what lets the
                # replayer treat a torn tail as a clean prefix.
                self._audit.flush()
            if committed_any and self.checkpoint_path is not None:
                # One atomic rewrite per drained burst, AFTER delivery: a
                # crash in the window re-delivers at most this burst on
                # restart (at-least-once at the boundary, dedupable by
                # certificate digest downstream) instead of silently
                # LOSING it, which nothing downstream could repair.
                # The write+fsync runs in the default executor: an fsync
                # on the event loop blocked the ENTIRE primary process
                # (proposer, core) for the disk's flush latency per
                # commit burst — commit-path work slowing round cadence
                # itself.  Awaiting here still serializes rewrites within
                # this task (no torn interleavings), and the checkpoint's
                # crash-recovery semantics tolerate the added staleness
                # (it is an optimization; at worst one more burst
                # re-delivers).
                blob = self.tusk.state.snapshot_bytes()
                try:
                    await asyncio.get_running_loop().run_in_executor(
                        None, self._write_checkpoint, blob
                    )
                except OSError:
                    # The checkpoint is a recovery OPTIMIZATION: a failed
                    # rewrite (ENOSPC clearing, a tmp-dir hiccup, a
                    # racing writer) costs one burst of at-least-once
                    # re-delivery on the next restart — an unhandled
                    # exception here killed the ENTIRE commit pipeline
                    # instead, silently wedging the node while certs
                    # kept queueing.  Found by the narwhal-race
                    # deterministic harness: a restart
                    # overlap made the pre-crash incarnation's in-flight
                    # executor write race this one's and the loser's
                    # os.replace raised FileNotFoundError straight into
                    # Consensus.run.
                    log.exception(
                        "consensus checkpoint rewrite to %s failed; "
                        "continuing without it (next burst retries)",
                        self.checkpoint_path,
                    )

    def _write_checkpoint(self, blob: bytes) -> None:
        # Unique tmp per write (NOT a fixed `<path>.tmp`): two writers
        # sharing one checkpoint path — an in-process restart whose
        # previous incarnation's executor write is still in flight, or
        # two instances pointed at one file — would open the same tmp
        # and the loser's os.replace would find it already renamed away.
        # With unique tmps, concurrent writers are safe: os.replace is
        # atomic, last-completed-writer wins, and the file under the
        # final name is always a complete snapshot.
        fd, tmp = tempfile.mkstemp(
            dir=os.path.dirname(self.checkpoint_path) or ".",
            prefix=os.path.basename(self.checkpoint_path) + ".tmp.",
        )
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(blob)
                # fsync BEFORE the rename: os.replace is atomic against
                # process crash, but on power loss the rename can become
                # durable before the data, leaving a torn file under the
                # final name.
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.checkpoint_path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

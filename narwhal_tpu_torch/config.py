"""Committee, stakes, addresses, tunable parameters, key files.

Mirrors the reference `config` crate (config/src/lib.rs, 271 LoC):
stake-weighted `Committee` with 2f+1 / f+1 thresholds (lines 168-181), five
listen addresses per authority (112-128), `Parameters` with defaults (61-96),
and JSON import/export (28-56).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from .crypto import KeyPair, PublicKey

Stake = int
WorkerId = int


class ConfigError(Exception):
    pass


@dataclass(frozen=True)
class PrimaryAddresses:
    # Address to receive messages from other primaries (WAN).
    primary_to_primary: str
    # Address to receive messages from our workers (LAN).
    worker_to_primary: str


@dataclass(frozen=True)
class WorkerAddresses:
    # Address to receive client transactions (WAN).
    transactions: str
    # Address to receive messages from other workers (WAN).
    worker_to_worker: str
    # Address to receive messages from our primary (LAN).
    primary_to_worker: str


@dataclass
class Authority:
    stake: Stake
    primary: PrimaryAddresses
    workers: Dict[WorkerId, WorkerAddresses] = field(default_factory=dict)


class Committee:
    """The static validator set.  Reference config/src/lib.rs:130-246."""

    def __init__(self, authorities: Dict[PublicKey, Authority]) -> None:
        self.authorities = authorities

    def size(self) -> int:
        return len(self.authorities)

    def stake(self, name: PublicKey) -> Stake:
        auth = self.authorities.get(name)
        return auth.stake if auth is not None else 0

    def total_stake(self) -> Stake:
        return sum(a.stake for a in self.authorities.values())

    def quorum_threshold(self) -> Stake:
        """2f+1 votes of stake (any two quorums intersect in an honest node).
        Reference config/src/lib.rs:168-173."""
        total = self.total_stake()
        return 2 * total // 3 + 1

    def validity_threshold(self) -> Stake:
        """f+1 votes of stake (at least one honest node).
        Reference config/src/lib.rs:176-181."""
        total = self.total_stake()
        return (total + 2) // 3

    # --- address lookups (reference config/src/lib.rs:184-246) ---

    def primary(self, name: PublicKey) -> PrimaryAddresses:
        try:
            return self.authorities[name].primary
        except KeyError:
            raise ConfigError(f"unknown authority {name!r}")

    def others_primaries(self, myself: PublicKey) -> List[Tuple[PublicKey, PrimaryAddresses]]:
        return [
            (name, a.primary)
            for name, a in self.authorities.items()
            if name != myself
        ]

    def worker(self, name: PublicKey, worker_id: WorkerId) -> WorkerAddresses:
        try:
            auth = self.authorities[name]
        except KeyError:
            raise ConfigError(f"unknown authority {name!r}")
        try:
            return auth.workers[worker_id]
        except KeyError:
            raise ConfigError(f"authority {name!r} has no worker {worker_id}")

    def our_workers(self, myself: PublicKey) -> List[WorkerAddresses]:
        try:
            return list(self.authorities[myself].workers.values())
        except KeyError:
            raise ConfigError(f"unknown authority {myself!r}")

    def others_workers(
        self, myself: PublicKey, worker_id: WorkerId
    ) -> List[Tuple[PublicKey, WorkerAddresses]]:
        """Same-id workers of every other authority — the payload-sharding
        pairing (reference config/src/lib.rs:230-246)."""
        out = []
        for name, auth in self.authorities.items():
            if name == myself:
                continue
            addrs = auth.workers.get(worker_id)
            if addrs is not None:
                out.append((name, addrs))
        return out

    # --- JSON import/export ---

    def to_json(self) -> dict:
        return {
            "authorities": {
                name.encode_base64(): {
                    "stake": a.stake,
                    "primary": {
                        "primary_to_primary": a.primary.primary_to_primary,
                        "worker_to_primary": a.primary.worker_to_primary,
                    },
                    "workers": {
                        str(wid): {
                            "transactions": w.transactions,
                            "worker_to_worker": w.worker_to_worker,
                            "primary_to_worker": w.primary_to_worker,
                        }
                        for wid, w in a.workers.items()
                    },
                }
                for name, a in self.authorities.items()
            }
        }

    @classmethod
    def from_json(cls, obj: dict) -> "Committee":
        authorities: Dict[PublicKey, Authority] = {}
        for name_b64, a in obj["authorities"].items():
            name = PublicKey.decode_base64(name_b64)
            authorities[name] = Authority(
                stake=int(a["stake"]),
                primary=PrimaryAddresses(
                    primary_to_primary=a["primary"]["primary_to_primary"],
                    worker_to_primary=a["primary"]["worker_to_primary"],
                ),
                workers={
                    int(wid): WorkerAddresses(
                        transactions=w["transactions"],
                        worker_to_worker=w["worker_to_worker"],
                        primary_to_worker=w["primary_to_worker"],
                    )
                    for wid, w in a.get("workers", {}).items()
                },
            )
        return cls(authorities)

    def export(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)

    @classmethod
    def load(cls, path: str) -> "Committee":
        with open(path) as f:
            return cls.from_json(json.load(f))


@dataclass
class Parameters:
    """Tunables with the reference defaults (config/src/lib.rs:61-96).
    All delays in milliseconds, sizes in bytes."""

    # The preferred header size: the primary creates a header when it has
    # enough digests, or when max_header_delay passes.
    header_size: int = 1_000
    max_header_delay: int = 100
    # Sui-style round-cadence floor: when > 0, a proposer holding a parent
    # quorum proposes as soon as (a) min_header_delay has elapsed since its
    # last header AND (b) it has ANY payload — instead of riding
    # max_header_delay waiting for header_size bytes of digests.  Empty
    # rounds still wait for max_header_delay (an idle committee must not
    # spin headers at wire speed).  0 (the default) disables the fast
    # cadence and keeps the reference behavior bit-for-bit.
    min_header_delay: int = 0
    # Parent-linger window: when > 0, a proposer whose round just advanced
    # holds the next header open for this many milliseconds so parent
    # certificates arriving AFTER the round-advance quorum still get cited
    # (the Core forwards post-quorum certificates while the window is
    # open).  Without it a header's parents are exactly the FIRST 2f+1
    # certificates of the round, which leaves commit-rule slot support
    # sitting at the quorum borderline (the multileader rule's motivating
    # measurement — see consensus/tusk.py::MultiLeaderTusk).  Price it off
    # the measured consensus.support_arrival_ms headroom: a linger of
    # roughly that spread converts borderline support rounds into direct
    # commits.  max_header_delay still caps every round; 0 (the default)
    # disables the window and keeps the reference behavior bit-for-bit.
    header_linger: int = 0
    # Depth of garbage collection, in rounds.
    gc_depth: int = 50
    # Delay before retrying a sync request, and fan-out of the retry.
    sync_retry_delay: int = 5_000
    sync_retry_nodes: int = 3
    # The preferred batch size and the batch-seal timeout.
    batch_size: int = 500_000
    max_batch_delay: int = 100

    def log(self, logger) -> None:
        """Echo config at boot; the benchmark harness parses these lines back
        (reference config/src/lib.rs:100-110, benchmark logs.py:109-131)."""
        logger.info("Header size set to %s B", self.header_size)
        logger.info("Max header delay set to %s ms", self.max_header_delay)
        logger.info("Min header delay set to %s ms", self.min_header_delay)
        logger.info("Header linger set to %s ms", self.header_linger)
        logger.info("Garbage collection depth set to %s rounds", self.gc_depth)
        logger.info("Sync retry delay set to %s ms", self.sync_retry_delay)
        logger.info("Sync retry nodes set to %s nodes", self.sync_retry_nodes)
        logger.info("Batch size set to %s B", self.batch_size)
        logger.info("Max batch delay set to %s ms", self.max_batch_delay)

    def to_json(self) -> dict:
        return {
            "header_size": self.header_size,
            "max_header_delay": self.max_header_delay,
            "min_header_delay": self.min_header_delay,
            "header_linger": self.header_linger,
            "gc_depth": self.gc_depth,
            "sync_retry_delay": self.sync_retry_delay,
            "sync_retry_nodes": self.sync_retry_nodes,
            "batch_size": self.batch_size,
            "max_batch_delay": self.max_batch_delay,
        }

    @classmethod
    def from_json(cls, obj: dict) -> "Parameters":
        fields = cls().to_json().keys()
        unknown = set(obj) - set(fields)
        if unknown:
            raise ConfigError(f"unknown parameter(s): {sorted(unknown)}")
        vals = {}
        for k, v in obj.items():
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                raise ConfigError(f"parameter {k!r} must be a non-negative integer, got {v!r}")
            vals[k] = v
        return cls(**vals)

    def export(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)

    @classmethod
    def load(cls, path: str) -> "Parameters":
        with open(path) as f:
            return cls.from_json(json.load(f))


def export_keypair(kp: KeyPair, path: str) -> None:
    with open(path, "w") as f:
        json.dump(kp.to_json(), f, indent=2)


def load_keypair(path: str) -> KeyPair:
    with open(path) as f:
        return KeyPair.from_json(json.load(f))

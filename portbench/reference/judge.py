"""The comparison that decides ``correct``: everything worked out again
from the stores and logs a run left, in plain Python.

The judged set is the live set: ``RunFiles`` lists the stores, logs and
exit codes of the nodes that ran, and none of an authority crashed from
the start (the configuration's ``faults``), which left none.  ``keys`` is
the whole committee all the same, so every quorum below (2f+1, with
``batch_unheld``'s) is held against all ``n`` authorities, as the live
nodes themselves count it.

Each number below is compared with its limit (``LIMITS``: 0 for every
exact comparison; PERF.md gives the readings each was set from):

- ``order_mismatch``: positions at which a primary's logged commit
  sequence differs from Tusk's (``tusk.py``) over the certificates of its
  own store, fed in the order it stored them (summed over primaries);
- ``prefix_disagree``: pairs of primaries whose logged sequences differ
  on their common prefix;
- ``bad_certificates``: of a sample of stored certificates drawn from the
  seed, those whose header id, header signature, vote signatures or 2f+1
  stake quorum does not hold;
- ``batch_unheld``: committed batches held, with bytes that hash to their
  digest, by fewer than 2f+1 workers;
- ``sample_mismatch``: samples due in the window whose batch (as the
  worker logged it) does not hold them with the bytes the load
  generator sent;
- ``uncommitted_pct``: the share of the samples due in the window whose
  batch never committed (%).  Tusk commits a certificate only through a
  leader's causal history, so a certificate that no later header cites
  leaves its batches uncommitted.  With the configurations'
  ``header_linger`` a header also cites the certificates that land after
  its round's quorum, and sound runs lose at most a few certificates a
  run; its limit lies between the highest share they lost and the lowest
  the same committee loses with the linger off, which cites only the
  first 2f+1 (a consensus that stops committing reads 100);
- ``tx_count_mismatch``: transactions in the batches first committed in
  the window, counted from the stored bytes, less the harness's count
  from the logs (absolute);
- ``node_errors``: nodes that exited non-zero or logged an error.

``control="quorum"`` judges the certificates as a committee that forms
them at 2f votes would have stored them (the last vote dropped): the
control that breaks the configuration's 2f+1 quorum guarantee.
"""

from __future__ import annotations

import hashlib
import random
import re
import struct
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from . import ed25519, tusk, wire

LIMITS = {
    "order_mismatch": 0,
    "prefix_disagree": 0,
    "bad_certificates": 0,
    "batch_unheld": 0,
    "sample_mismatch": 0,
    "uncommitted_pct": 2.5,
    "tx_count_mismatch": 0,
    "node_errors": 0,
}
CERT_SAMPLE = 24

_TS = r"(\d{4}-\d{2}-\d{2}T\d{2}:\d{2}:\d{2}\.\d{3})Z"
_COMMIT = re.compile(_TS + r" \S+ \S+ Committed B(\d+)\((\S+?)\)(?: -> (\S+))?")
_SAMPLE = re.compile(r"Batch (\S+) contains sample tx (\d+)")
_CREATED = re.compile(r"Created B\d+\((\S+?)\) -> (\S+)")
_ERROR = re.compile(r"\b(ERROR|CRITICAL|Traceback|panicked)\b")


def log_time(stamp: str) -> float:
    """A node log stamp (local time, milliseconds; the Z is cosmetic)."""
    import datetime

    return datetime.datetime.strptime(stamp, "%Y-%m-%dT%H:%M:%S.%f").timestamp()


def sample_tx(seed: int, sid: int, size: int) -> bytes:
    """The bytes of sample transaction ``sid`` under ``seed``: byte 0 is 0,
    then the id as u64, then bytes drawn from SHA-512 of the seed and id."""
    head = b"\x00" + sid.to_bytes(8, "little")
    pad, block = bytearray(), 0
    while len(pad) < size - 9:
        pad += hashlib.sha512(seed.to_bytes(16, "little", signed=True)
                              + sid.to_bytes(8, "little")
                              + block.to_bytes(4, "little")).digest()
        block += 1
    return head + bytes(pad[:size - 9])


@dataclass
class RunFiles:
    """What the judge reads: the whole committee's keys, and each live
    node's store, log and exit code."""

    keys: List[bytes]
    gc_depth: int
    tx_size: int
    seed: int
    primary_stores: List[str]
    primary_logs: List[str]
    worker_stores: List[str]
    worker_logs: List[str]
    exit_codes: Dict[str, Optional[int]]
    window: Tuple[float, float]
    window_samples: List[int]
    committed_txs: int  # the harness's count from the logs


def commit_lines(text: str):
    """(time, round, header repr, batch repr or None) per commit line."""
    for m in _COMMIT.finditer(text):
        yield log_time(m.group(1)), int(m.group(2)), m.group(3), m.group(4)


def logged_sequence(text: str) -> List[Tuple[int, str]]:
    """A primary's committed headers in order (one line per payload
    digest, so consecutive repeats are one header)."""
    seq = []
    for _, rnd, header, _ in commit_lines(text):
        if not seq or seq[-1] != (rnd, header):
            seq.append((rnd, header))
    return seq


def _scan_store(path: str):
    """(key, value as a memoryview) of every record of a store log."""
    with open(path, "rb") as f:
        data = memoryview(f.read())
    pos, size = 0, len(data)
    while pos + 8 <= size:
        klen, vlen = struct.unpack_from("<II", data, pos)
        end = pos + 8 + klen + vlen
        if end > size:
            break
        yield bytes(data[pos + 8:pos + 8 + klen]), data[pos + 8 + klen:end]
        pos = end


def _certificate_faults(cert: wire.Cert, keys, quorum: int) -> int:
    if cert.computed_header_id() != cert.header_id:
        return 1
    if not ed25519.verify(cert.author, cert.header_id, cert.header_sig):
        return 1
    voters = [name for name, _ in cert.votes]
    if len(set(voters)) != len(voters) or not set(voters) <= set(keys):
        return 1
    if len(voters) < quorum:
        return 1
    digest = cert.digest()
    return int(not all(ed25519.verify(name, digest, sig) for name, sig in cert.votes))


def judge(run: RunFiles, control: Optional[str] = None,
          diag: Optional[dict] = None) -> Dict[str, int]:
    """The numbers compared.  ``diag``, where given, receives why the
    window's uncommitted samples were lost: their batch in no header
    (``unproposed``), its header never certified (``uncertified``), its
    certificate cited by no stored certificate (``uncited``), or cited
    and still uncommitted (``cited``); and ``orphans``, the authority
    and round of each certificate of the last two kinds."""
    keys = sorted(run.keys)
    n = len(keys)
    quorum = 2 * n // 3 + 1
    genesis = wire.genesis(keys)
    out = dict.fromkeys(LIMITS, 0)

    texts = {"primary": [], "worker": []}
    for role, paths in (("primary", run.primary_logs), ("worker", run.worker_logs)):
        for p in paths:
            with open(p, errors="replace") as f:
                texts[role].append(f.read())
    out["node_errors"] = sum(1 for code in run.exit_codes.values() if code != 0) + sum(
        1 for t in texts["primary"] + texts["worker"] if _ERROR.search(t))

    # The committed order of every primary, held to Tusk over its store.
    certs_by_primary = [wire.stored_certificates(p, keys) for p in run.primary_stores]
    logged = [logged_sequence(t) for t in texts["primary"]]
    for certs, seq in zip(certs_by_primary, logged):
        want = [(r, wire.short(h)) for r, h in
                tusk.commit_sequence(keys, genesis, certs, run.gc_depth)]
        out["order_mismatch"] += sum(
            1 for i, item in enumerate(seq) if i >= len(want) or want[i] != item)
    for i in range(len(logged)):
        for j in range(i + 1, len(logged)):
            k = min(len(logged[i]), len(logged[j]))
            out["prefix_disagree"] += logged[i][:k] != logged[j][:k]

    # A sample of the stored certificates, drawn from the seed.
    pool = {c.digest(): c for certs in certs_by_primary for c in certs}
    rng = random.Random(run.seed)
    chosen = rng.sample(sorted(pool), min(CERT_SAMPLE, len(pool)))
    for d in chosen:
        cert = pool[d]
        if control == "quorum":
            cert = wire.Cert(cert.author, cert.round, cert.payload, cert.parents,
                             cert.header_id, cert.header_sig, cert.votes[:quorum - 1])
        out["bad_certificates"] += _certificate_faults(cert, keys, quorum)

    # Each commit's first time, from every primary's log.
    first_commit: Dict[str, float] = {}
    for t in texts["primary"]:
        for ts, _, _, batch in commit_lines(t):
            if batch is not None and ts < first_commit.get(batch, float("inf")):
                first_commit[batch] = ts

    # Every worker's copies: which batches it holds with honest bytes.
    holders: Dict[str, int] = {}
    counts: Dict[str, int] = {}
    window_batches = {}
    sample_batch: Dict[int, str] = {}
    for t in texts["worker"]:
        for m in _SAMPLE.finditer(t):
            sample_batch.setdefault(int(m.group(2)), m.group(1))
    wanted = {sample_batch.get(s) for s in run.window_samples} - {None}
    for path in run.worker_stores:
        for key, value in _scan_store(path):
            if len(key) != 32 or value[:1] != b"\x00":
                continue
            name = wire.short(key)
            if name not in first_commit and name not in wanted:
                continue
            if hashlib.sha256(value).digest() != key:
                continue
            holders[name] = holders.get(name, 0) + 1
            if name not in counts:
                (count,) = struct.unpack_from("<I", value, 1)
                if len(value) == 5 + count * (4 + run.tx_size):
                    counts[name] = count
            if name in wanted and name not in window_batches:
                window_batches[name] = bytes(value)
    out["batch_unheld"] = sum(1 for b in first_commit if holders.get(b, 0) < quorum)

    lo, hi = run.window
    stored_txs = sum(counts.get(b, 0) for b, ts in first_commit.items() if lo <= ts < hi)
    out["tx_count_mismatch"] = abs(stored_txs - run.committed_txs) + sum(
        1 for b, ts in first_commit.items() if lo <= ts < hi and b not in counts)

    # Every window sample: in the batch its worker named, with the bytes
    # that were sent, and that batch committed.
    txs_of, uncommitted = {}, 0
    for s in run.window_samples:
        b = sample_batch.get(s)
        if b is None or b not in first_commit:
            uncommitted += 1
            continue
        if b not in txs_of:
            try:
                txs_of[b] = {wire.sample_id(tx): tx
                             for tx in wire.decode_batch(window_batches.get(b, b""))}
            except (ValueError, struct.error):
                txs_of[b] = {}
        if txs_of[b].get(s) != sample_tx(run.seed, s, run.tx_size):
            out["sample_mismatch"] += 1
    out["uncommitted_pct"] = 100.0 * uncommitted / max(1, len(run.window_samples))
    if diag is not None:
        diag.update(_loss_causes(run, texts, certs_by_primary, sample_batch, first_commit))
    return out


def _loss_causes(run, texts, certs_by_primary, sample_batch, first_commit) -> Dict[str, int]:
    header_of = {}
    for t in texts["primary"]:
        for m in _CREATED.finditer(t):
            header_of.setdefault(m.group(2), m.group(1))
    certified, origin = {}, {}
    cited = set()
    author = {k: i for i, k in enumerate(run.keys)}
    for certs in certs_by_primary:
        for c in certs:
            certified[wire.short(c.header_id)] = c.digest()
            origin[c.digest()] = (author.get(c.author, -1), c.round)
            cited.update(c.parents)
    out = dict.fromkeys(("unproposed", "uncertified", "uncited", "cited"), 0)
    orphans: Dict[Tuple[int, int], int] = {}
    for s in run.window_samples:
        b = sample_batch.get(s)
        if b is not None and b in first_commit:
            continue
        h = header_of.get(b)
        if h is None:
            out["unproposed"] += 1
        elif h not in certified:
            out["uncertified"] += 1
        else:
            out["uncited" if certified[h] not in cited else "cited"] += 1
            where = origin[certified[h]]
            orphans[where] = orphans.get(where, 0) + 1
    # (authority, round, window samples) of each certificate lost with them
    out["orphans"] = [[a, r, k] for (a, r), k in sorted(orphans.items())]
    return out


def verdict(numbers: Dict[str, int]) -> bool:
    return all(numbers[k] <= LIMITS[k] for k in LIMITS)

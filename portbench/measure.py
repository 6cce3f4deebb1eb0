"""The benchmark's arithmetic: logs to end-to-end numbers, percentiles,
the knee rule and the disk reckoning.

The log join is the reference benchmark's (its LogParser): a worker logs
``Batch <digest> contains sample tx <id>`` and ``Batch <digest> contains
<n> B`` when it seals a batch, and a primary logs ``Committed B<round>
(<header>) -> <digest>`` for each batch its consensus commits; a batch's
commit time is the earliest such line over the primaries.  Unlike the
reference's means, a sample's latency runs from the time its burst was
due (not sent).

A sample whose batch never committed counts as failed.  Tusk commits a
certificate only through a later leader's causal history, so one that no
later header cites is never committed, and neither are its batches.  The
percentiles are taken over every sample due in the window, a lost one
sorting after every committed one (``inf``), so a change that loses more
raises them, and a percentile that falls on a lost sample is ``inf``.
"""

from __future__ import annotations

import math
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .reference.judge import log_time

_TS = r"(\d{4}-\d{2}-\d{2}T\d{2}:\d{2}:\d{2}\.\d{3})Z"
_COMMIT = re.compile(_TS + r" \S+ \S+ Committed B\d+\(\S+?\) -> (\S+)")
_SAMPLE = re.compile(r"Batch (\S+) contains sample tx (\d+)")
_BYTES = re.compile(r"Batch (\S+) contains (\d+) B")


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (``q`` in 0..100) over every value given;
    ``inf`` stands for a sample never committed."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


class LogTail:
    """Reads a growing log from where it left off, whole lines only."""

    def __init__(self, path: str) -> None:
        self.path, self.pos, self.rest = path, 0, b""

    def read(self) -> str:
        try:
            with open(self.path, "rb") as f:
                f.seek(self.pos)
                data = f.read()
        except FileNotFoundError:
            return ""
        self.pos += len(data)
        data = self.rest + data
        cut = data.rfind(b"\n") + 1
        self.rest = data[cut:]
        return data[:cut].decode(errors="replace")


class Join:
    """The running join of worker and primary logs."""

    def __init__(self, worker_logs: Iterable[str], primary_logs: Iterable[str]) -> None:
        self.workers = [LogTail(p) for p in worker_logs]
        self.primaries = [LogTail(p) for p in primary_logs]
        self.sample_batch: Dict[int, str] = {}
        self.batch_bytes: Dict[str, int] = {}
        self.committed: Dict[str, float] = {}

    def update(self) -> None:
        for tail in self.workers:
            text = tail.read()
            for m in _SAMPLE.finditer(text):
                self.sample_batch.setdefault(int(m.group(2)), m.group(1))
            for m in _BYTES.finditer(text):
                self.batch_bytes.setdefault(m.group(1), int(m.group(2)))
        for tail in self.primaries:
            for m in _COMMIT.finditer(tail.read()):
                t = log_time(m.group(1))
                if t < self.committed.get(m.group(2), math.inf):
                    self.committed[m.group(2)] = t

    def commit_time(self, sample: int) -> Optional[float]:
        batch = self.sample_batch.get(sample)
        return None if batch is None else self.committed.get(batch)

    def pending(self, samples: Iterable[int]) -> int:
        return sum(1 for s in samples if self.commit_time(s) is None)


def latencies_ms(due: Dict[int, float], join: Join) -> List[float]:
    """Each sample's latency from its due time, ``inf`` if never committed."""
    out = []
    for sid, t in due.items():
        c = join.commit_time(sid)
        out.append(math.inf if c is None else 1000.0 * (c - t))
    return out


def committed_txs(join: Join, window: Tuple[float, float], tx_size: int) -> int:
    """Transactions in the batches first committed inside the window."""
    lo, hi = window
    return sum(join.batch_bytes.get(b, 0) for b, t in join.committed.items()
               if lo <= t < hi) // tx_size


def end_to_end(due: Dict[int, float], join: Join, window: Tuple[float, float],
               tx_size: int) -> dict:
    """``latency_p50_ms`` and ``latency_p95_ms`` over every sample: ``inf``
    once half (a twentieth) of them are lost."""
    lat = latencies_ms(due, join)
    done = [x for x in lat if math.isfinite(x)]
    txs = committed_txs(join, window, tx_size)
    return dict(
        committed_tps=txs / (window[1] - window[0]),
        committed_txs=txs,
        latency_p50_ms=percentile(lat, 50) if lat else math.inf,
        latency_p95_ms=percentile(lat, 95) if lat else math.inf,
        attempted=len(lat),
        failed=len(lat) - len(done),
    )


def thirds_ms(due: Dict[int, float], join: Join, window: Tuple[float, float]) -> List[float]:
    """Median latency of the committed samples due in each third of the
    window."""
    lo, hi = window
    parts: List[List[float]] = [[], [], []]
    for sid, t in due.items():
        c = join.commit_time(sid)
        if c is not None:
            parts[min(2, int(3 * (t - lo) / (hi - lo)))].append(1000.0 * (c - t))
    return [percentile(p, 50) if p else math.inf for p in parts]


SLACK = 0.05  # committed share below the lowest rate's: a rate falls behind
GROWTH = 0.10  # last third's median latency over the first third's: a backlog


def keeps_up(runs: Sequence[Tuple[float, float, Sequence[float]]], base: float,
             slack: float = SLACK, growth: float = GROWTH) -> bool:
    """The knee rule for one rate, over its runs (offered, committed,
    thirds): the mean committed share of the offered rate no more than
    ``slack`` below ``base`` (the mean share at the sweep's lowest rate:
    the committee loses a share of its transactions at any load, and that
    share swings by several points from run to run), and in every run the
    last third's median latency no more than ``growth`` above the first
    third's (no growing backlog)."""
    share = sum(c / r for r, c, _ in runs) / len(runs)
    return share >= base - slack and all(th[2] <= (1 + growth) * th[0] for _, _, th in runs)


def knee(rows: Sequence[Tuple[float, float, Sequence[float]]]) -> Optional[float]:
    """The highest offered rate of a sweep, (offered, committed, thirds) a
    run, below the lowest rate that does not keep up: a rate above one
    that failed never counts.  ``None`` where the lowest rate fails."""
    by_rate: Dict[float, list] = {}
    for row in rows:
        by_rate.setdefault(row[0], []).append(row)
    if not by_rate:
        return None
    rates = sorted(by_rate)
    low = by_rate[rates[0]]
    base = sum(c / r for r, c, _ in low) / len(low)
    best = None
    for r in rates:
        if not keeps_up(by_rate[r], base):
            break
        best = r
    return best


def disk_bytes(workers: int, rate: float, tx_size: int, load_s: float) -> float:
    """Batch bytes a run stores: every worker stores every batch."""
    return workers * rate * tx_size * load_s


def tree_bytes(path: str) -> int:
    """Bytes of every file under ``path``."""
    total = 0
    for dirpath, _, files in os.walk(path):
        for name in files:
            try:
                total += os.path.getsize(os.path.join(dirpath, name))
            except OSError:
                pass
    return total

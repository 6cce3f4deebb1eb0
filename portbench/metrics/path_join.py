"""Each window sample's path through the program, read from the stage
trace that every node's final snapshot holds (``trace``: batch digest →
{stage: ``time.time()`` stamp, ...}); the ``path.*`` readers share it.

The join, a window sample at a time (its id is ``(worker << 32) |
burst``, as ``loadgen.sample_id`` makes it):

- its batch is the worker trace entry whose ``samples`` holds the id;
  ``seal`` and ``quorum`` come from that worker;
- ``digest_at_primary``, ``header`` and ``cert`` come from the same
  authority's primary;
- the committing primary is the primary with the earliest ``commit``
  stamp for the batch (the latency's first ``Committed`` line, any
  primary); ``cert_inserted``, ``commit_trigger``, ``walk_done`` and
  ``commit`` come from its table.

A sample is traced when all of these stamps exist and none is earlier
than the one before it, its due time first.  One that never committed,
whose entry a node may have evicted (``metrics.trace_evictions`` > 0 on
a node that lacks the batch), or whose stamps are out of order, is not.

The seven legs are the differences of consecutive stamps, so they add up
to the sample's total, ``commit`` less its due time.  A leg's value is
its mean over the traced samples whose total lies between the 25th and
the 75th percentile of the totals: the legs add up to that band's mean
total, which sits at the median, and a paused run's long tail does not
move it.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from portbench.measure import percentile

MIN_TRACED = 100
WORKER_STAGES = ("seal", "quorum")
PRIMARY_STAGES = ("digest_at_primary", "header", "cert")
CONSENSUS_STAGES = ("cert_inserted", "commit_trigger", "walk_done", "commit")
ORDER = ("due",) + WORKER_STAGES + PRIMARY_STAGES + CONSENSUS_STAGES
# (leg, from stamp, to stamp); they tile ORDER from due to commit
LEGS = (
    ("seal", "due", "seal"),
    ("quorum", "seal", "quorum"),
    ("header", "quorum", "header"),
    ("certify", "header", "cert"),
    ("to_consensus", "cert", "cert_inserted"),
    ("cadence", "cert_inserted", "commit_trigger"),
    ("commit", "commit_trigger", "commit"),
)


def _tables(obs, role: str) -> Dict[str, dict]:
    return {n: s.get("trace") or {} for n, s in obs.final.items() if n.startswith(role)}


def paths(obs) -> Optional[List[Optional[Dict[str, float]]]]:
    """Each window sample's stamps by stage (``due`` too), or ``None`` for
    a sample that is not traced, in the order of ``obs.samples``.
    ``None`` in place of the list where no worker's seal marks carry
    sample ids (a program that does not record them)."""
    workers = _tables(obs, "worker")
    batch_of: Dict[int, tuple] = {}
    carries = False
    for node, table in workers.items():
        for digest, entry in table.items():
            ids = entry.get("samples")
            if ids is None:
                continue
            carries = True
            for sid in ids:
                batch_of[int(sid)] = (node, digest)
    if not carries:
        return None
    primaries = _tables(obs, "primary")
    evicted = {n for n in primaries
               if (obs.final[n].get("gauges") or {}).get("metrics.trace_evictions") or 0}
    return [_path((int(w) << 32) | int(burst), due, batch_of, workers, primaries, evicted)
            for w, burst, due, _ in obs.samples]


def _path(sid, due, batch_of, workers, primaries, evicted) -> Optional[Dict[str, float]]:
    found = batch_of.get(sid)
    if found is None:
        return None
    worker, digest = found
    stamps = {"due": due}
    stamps.update((s, workers[worker][digest].get(s)) for s in WORKER_STAGES)
    own = primaries.get("primary" + worker[len("worker"):], {}).get(digest, {})
    stamps.update((s, own.get(s)) for s in PRIMARY_STAGES)
    if any(digest not in primaries[n] for n in evicted):
        return None  # the earliest commit may be the one evicted
    commits = [(t[digest]["commit"], n) for n, t in primaries.items()
               if "commit" in t.get(digest, {})]
    if not commits:
        return None
    first = primaries[min(commits)[1]][digest]
    stamps.update((s, first.get(s)) for s in CONSENSUS_STAGES)
    values = [stamps[s] for s in ORDER]
    if any(v is None for v in values) or any(b < a for a, b in zip(values, values[1:])):
        return None
    return stamps


def legs(obs) -> Optional[Dict[str, float]]:
    """Each leg's mean over the middle band of totals, in ms; ``None``
    under ``MIN_TRACED`` traced samples."""
    got = paths(obs)
    traced = [p for p in got or () if p is not None]
    if len(traced) < MIN_TRACED:
        return None
    totals = [p["commit"] - p["due"] for p in traced]
    lo, hi = percentile(totals, 25), percentile(totals, 75)
    band = [p for p, t in zip(traced, totals) if lo <= t <= hi]
    return {leg: 1000.0 * sum(p[b] - p[a] for p in band) / len(band) for leg, a, b in LEGS}


def leg(obs, name: str) -> Optional[float]:
    got = legs(obs)
    return None if got is None else got[name]


def traced_pct(obs) -> Optional[float]:
    """The share of window samples traced, in %."""
    got = paths(obs)
    if got is None or not got:
        return None
    return 100.0 * sum(p is not None for p in got) / len(got)

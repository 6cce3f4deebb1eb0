"""Tusk's commit rule over plain certificate records.

A frozen copy, in the yardstick's own terms, of the port's dict-walk
oracle (``consensus/golden.py``, itself the reference's commit rule as
it was golden-tested): an even round's leader is ``sorted_keys[round %
n]``; it commits once the certificates of the next round that cite it
carry f+1 of stake; committing it first commits every earlier
uncommitted leader it links to, oldest first; each leader's causal
history is flattened depth first and sorted by round, and the DAG is
collected ``gc_depth`` rounds behind the last commit.

``support`` is the stake that makes a leader commit: f+1 by the rule.
The benchmark's control runs the same walk with a lower one.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .wire import Cert


class Tusk:
    def __init__(self, keys: List[bytes], genesis: List[Cert], gc_depth: int,
                 support: Optional[int] = None) -> None:
        self.keys = sorted(keys)
        n = len(self.keys)
        self.support = (n + 2) // 3 if support is None else support
        self.gc_depth = gc_depth
        self.dag: Dict[int, Dict[bytes, Tuple[bytes, Cert]]] = {
            0: {c.author: (c.digest(), c) for c in genesis}}
        self.last_committed = {k: 0 for k in self.keys}
        self.last_committed_round = 0

    def _leader(self, rnd: int):
        return self.dag.get(rnd, {}).get(self.keys[rnd % len(self.keys)])

    def _update(self, cert: Cert) -> None:
        self.last_committed[cert.author] = max(
            self.last_committed.get(cert.author, 0), cert.round)
        self.last_committed_round = max(self.last_committed.values())
        last = self.last_committed_round
        for name, rnd in self.last_committed.items():
            for r in list(self.dag):
                row = self.dag[r]
                if name in row and r < rnd:
                    del row[name]
                if not row or r + self.gc_depth < last:
                    del self.dag[r]

    def process(self, cert: Cert) -> List[Cert]:
        """Add one certificate; returns the certificates it commits."""
        self.dag.setdefault(cert.round, {})[cert.author] = (cert.digest(), cert)
        r = cert.round - 1
        if r % 2 or r < 4:
            return []
        leader_round = r - 2
        if leader_round <= self.last_committed_round:
            return []
        got = self._leader(leader_round)
        if got is None:
            return []
        digest, leader = got
        stake = sum(1 for _, c in self.dag.get(r - 1, {}).values()
                    if digest in c.parents)
        if stake < self.support:
            return []
        out = []
        for past in reversed(self._order_leaders(leader)):
            for x in self._order_dag(past):
                self._update(x)
                out.append(x)
        return out

    def _order_leaders(self, leader: Cert) -> List[Cert]:
        chain = [leader]
        for r in range(leader.round - 2, self.last_committed_round + 1, -2):
            got = self._leader(r)
            if got is not None and self._linked(leader, got[1]):
                chain.append(got[1])
                leader = got[1]
        return chain

    def _linked(self, leader: Cert, prev: Cert) -> bool:
        level = [leader]
        for r in range(leader.round - 1, prev.round - 1, -1):
            level = [c for d, c in self.dag.get(r, {}).values()
                     if any(d in x.parents for x in level)]
        return any(x is prev for x in level)

    def _order_dag(self, leader: Cert) -> List[Cert]:
        ordered, seen, todo = [], set(), [leader]
        while todo:
            x = todo.pop()
            ordered.append(x)
            for parent in sorted(x.parents):
                found = next(((d, c) for d, c in self.dag.get(x.round - 1, {}).values()
                              if d == parent), None)
                if found is None:
                    continue
                d, c = found
                if d in seen or self.last_committed.get(c.author, -1) >= c.round:
                    continue
                todo.append(c)
                seen.add(d)
        ordered = [x for x in ordered
                   if x.round + self.gc_depth >= self.last_committed_round]
        ordered.sort(key=lambda x: x.round)
        return ordered


def commit_sequence(keys, genesis, certs: List[Cert], gc_depth: int,
                    support: Optional[int] = None) -> List[Tuple[int, bytes]]:
    """(round, header id) of every certificate committed, in order, when
    ``certs`` arrive in the order given."""
    tusk = Tusk(keys, genesis, gc_depth, support)
    return [(c.round, c.header_id) for cert in certs for c in tusk.process(cert)]

"""Even leader rounds that Tusk's commits passed over in the window
(``consensus.leaders_skipped``: rounds strictly between two committed
leaders whose own leader is absent or unlinked, so it never commits),
the gain over the window, the largest over the live primaries.  The live
primaries commit one chain, but each window's edges fall on its own
commits, so their gains differ by a round or so; the largest also shows
a primary that passed over more than the rest.  A dead authority leads
every n-th even round; in a committee with every validator up, a nonzero
reading is a leader lost to lateness."""

NAME = "consensus.leaders_skipped"


def read(obs):
    gains = [b["counters"][NAME] - a["counters"].get(NAME, 0)
             for a, b in (obs.snapshots[n] for n in obs.nodes("primary"))
             if NAME in b["counters"]]
    return float(max(gains)) if gains else None

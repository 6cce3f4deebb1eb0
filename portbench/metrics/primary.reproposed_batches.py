"""Batches whose header could no longer commit and that its primary put
into a later header (``primary.proposer.reproposed_batches``, counted as
a primary learns that a certificate of its own above the dead header
committed), the gain over the window, all primaries; 0.0 where no header
died.  Each is a batch that would otherwise have been certified, or
proposed, and never committed."""

NAME = "primary.proposer.reproposed_batches"


def read(obs):
    if not any(NAME in s["counters"] for n in obs.nodes("primary") for s in obs.snapshots[n]):
        return None
    return obs.counter("primary", NAME)

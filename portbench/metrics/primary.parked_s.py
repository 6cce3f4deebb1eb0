"""Seconds that parked headers waited for missing batches or parents
(``primary.header_waiter.parked_seconds``, observed as each resumes or is
collected), the sum gained over the window, all primaries; 0.0 when none
parked.  A stall behind ``sync_retry_delay`` shows here."""

NAME = "primary.header_waiter.parked_seconds"


def read(obs):
    if not any(NAME in s["histograms"] for n in obs.nodes("primary") for s in obs.snapshots[n]):
        return None
    return obs.hist("primary", NAME)[1]

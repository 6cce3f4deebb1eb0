"""How late the load generator sent its bursts: the 99th percentile, over
the samples due in the window, of send time less due time (ms)."""

from portbench.measure import percentile


def read(obs):
    late = [1000.0 * (sent - due) for _, _, due, sent in obs.samples]
    return percentile(late, 99) if late else None

"""The share of window samples (%) whose path the stage trace holds whole:
every stamp from the seal to the commit present and in order
(``path_join``).  A sample never committed, evicted from a node's trace
or with a stamp out of order counts as untraced."""

from portbench.metrics.path_join import traced_pct


def read(obs):
    return traced_pct(obs)

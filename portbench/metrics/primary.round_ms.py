"""A primary's round (``primary.round_advance_seconds``), mean ms over the
window, all primaries."""

from portbench.layers import mean_ms


def read(obs):
    return mean_ms(*obs.hist("primary", "primary.round_advance_seconds"))

"""A certificate's wait from its arrival at consensus to its commit
(``consensus.cert_to_commit_seconds``), mean ms over the window, all
primaries."""

from portbench.layers import mean_ms


def read(obs):
    return mean_ms(*obs.hist("primary", "consensus.cert_to_commit_seconds"))

"""A window sample's leg from ``header`` to ``cert`` (ms): the header's
broadcast, the peers' verify and votes, and the vote quorum.  The mean over
the samples whose total lies between the 25th and 75th percentiles
(``path_join``); the seven ``path.*`` legs add up to that band's mean total."""

from portbench.metrics.path_join import leg


def read(obs):
    return leg(obs, "certify")

"""A window sample's leg from ``quorum`` to ``header`` (ms): the digest's way
to its primary and the proposer's wait for its next header.  The mean over
the samples whose total lies between the 25th and 75th percentiles
(``path_join``); the seven ``path.*`` legs add up to that band's mean total."""

from portbench.metrics.path_join import leg


def read(obs):
    return leg(obs, "header")

"""A window sample's leg from ``seal`` to ``quorum`` (ms): the batch's
broadcast to the other workers and their 2f+1 acknowledgements.  The mean
over the samples whose total lies between the 25th and 75th percentiles
(``path_join``); the seven ``path.*`` legs add up to that band's mean total."""

from portbench.metrics.path_join import leg


def read(obs):
    return leg(obs, "quorum")

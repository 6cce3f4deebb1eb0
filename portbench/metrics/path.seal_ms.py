"""A window sample's leg from ``due`` to ``seal`` (ms): the load generator's
lateness, the ingress and the wait for its batch to fill (or its batch delay to pass).  The
mean over the samples whose total lies between the 25th and 75th percentiles
(``path_join``); the seven ``path.*`` legs add up to that band's mean total."""

from portbench.metrics.path_join import leg


def read(obs):
    return leg(obs, "seal")

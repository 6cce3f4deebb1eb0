"""A window sample's leg from ``cert_inserted`` to ``commit_trigger`` (ms): the
rounds until a leader with f+1 support commits the certificate.  The mean
over the samples whose total lies between the 25th and 75th percentiles
(``path_join``); the seven ``path.*`` legs add up to that band's mean total."""

from portbench.metrics.path_join import leg


def read(obs):
    return leg(obs, "cadence")

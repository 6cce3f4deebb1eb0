"""A window sample's leg from ``cert`` to ``cert_inserted`` (ms): the
certificate's hop to the committing primary, that primary's sanitize and
verify burst, and its consensus queue.  The mean over the samples whose
total lies between the 25th and 75th percentiles (``path_join``); the seven
``path.*`` legs add up to that band's mean total."""

from portbench.metrics.path_join import leg


def read(obs):
    return leg(obs, "to_consensus")

"""A window sample's leg from ``commit_trigger`` to ``commit`` (ms): the commit
step on the card, the causal flatten and the logging up to the certificate's
``Committed`` line.  The mean over the samples whose total lies between the
25th and 75th percentiles (``path_join``); the seven ``path.*`` legs add up
to that band's mean total."""

from portbench.metrics.path_join import leg


def read(obs):
    return leg(obs, "commit")

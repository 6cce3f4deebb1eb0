"""The share of the window's samples (%) whose batch was certified and
then never committed: its certificate cited by no stored certificate, or
only by such orphans (``lost``'s ``uncited`` and ``cited``).  A header
cites the certificates of the round before that its primary holds when
it is made (the first 2f+1, and with ``header_linger`` those that land
before the header), so a certificate that lands after every peer's next
header is orphaned with its batches; below the knee this is what
``committed_tps`` lacks of the offered rate."""


def read(obs):
    if not obs.samples or not obs.lost:
        return None
    return 100.0 * (obs.lost.get("uncited", 0) + obs.lost.get("cited", 0)) / len(obs.samples)

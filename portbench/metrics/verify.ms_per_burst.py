"""A Core burst's verify on the card's dispatch thread, host prep, copies
and kernel together (``crypto.verify.device_seconds.batch_burst``), mean
ms over the window, all primaries."""

from portbench.layers import mean_ms


def read(obs):
    return mean_ms(*obs.hist("primary", "crypto.verify.device_seconds.batch_burst"))

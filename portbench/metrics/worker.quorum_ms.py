"""A sealed batch's wait for its 2f+1 acknowledgements
(``worker.quorum_latency_seconds``), mean ms over the window, all workers."""

from portbench.layers import mean_ms


def read(obs):
    return mean_ms(*obs.hist("worker", "worker.quorum_latency_seconds"))

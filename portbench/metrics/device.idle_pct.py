"""The card's idle share over the window (%): 100 less the mean of
``nvidia-smi``'s ``utilization.gpu`` (the share of each sample period in
which a kernel ran), sampled every 200 ms by the harness."""


def read(obs):
    rows = obs.window_nvml()
    if not rows:
        return None
    return 100.0 - sum(u for _, u, _ in rows) / len(rows)

"""The verify kernel's share of its roofline (%): the signatures verified
on the card over the window (``crypto.verify.ops.*``, every verify site;
on the cuda backend each of them is a kernel launch's claims) times the
multiply-adds one verification needs, over the H100's INT32 multiply-add
peak, over the kernel's own time by CUDA events
(``crypto.verify.kernel_seconds``, every launch).  The count is of the
work, not of padded rows.  Ten CUDA contexts time-slice the card, so one
process's events also hold other processes' kernels: the share reads low."""

from portbench.layers import INT32_MADS_PER_S, MADS_PER_VERIFY


def read(obs):
    claims = sum(v for k, v in obs.counters_like("primary", "crypto.verify.ops.").items()
                 if k != "crypto.verify.ops.certificate_agg")
    count, seconds = obs.hist("primary", "crypto.verify.kernel_seconds")
    if count <= 0 or seconds <= 0 or claims <= 0:
        return None
    return 100.0 * claims * MADS_PER_VERIFY / INT32_MADS_PER_S / seconds

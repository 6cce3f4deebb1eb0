"""Per-peer clock-offset estimation from ReliableSender ACK round-trips.

Every reliable send already buys a round-trip: the peer validates the
frame and writes an ACK back (worker/primary receiver handlers).  By
stamping the ACK with the responder's wall clock and keeping the
sender's own send/receive wall stamps, each ACK yields one NTP-style
sample of the peer's clock offset:

    offset = t_peer - (t_send + t_recv) / 2      (peer_clock - my_clock)
    rtt    = t_recv - t_send

with worst-case error rtt/2 (the peer's stamp can sit anywhere inside
the round-trip).  Samples ride piggyback on protocol traffic — no probe
messages, no extra frames — and the per-peer estimator below filters
them by RTT (a queued or retransmitted exchange produces a fat RTT and
a correspondingly untrustworthy midpoint) and smooths the survivors.

The estimates are exported as gauges:

- ``clock.offset_ms.<addr>``             — smoothed (peer - self), ms;
- ``clock.offset_uncertainty_ms.<addr>`` — smoothed rtt/2 bound, ms;

and reconciled committee-wide at join time (benchmark/metrics_check
``snapshot_offsets_ms``): pairwise offsets only fix clock DIFFERENCES,
so the reconciliation anchors the committee mean to zero and assigns
each node the offset that makes its peer vector consistent — every
snapshot carries enough to place its own clock without any address→node
identity mapping.

Wire compatibility: a stamped ACK is ``b"Ack"`` + 8 little-endian
float64 bytes.  ``parse_ack`` accepts the legacy bare ``b"Ack"`` (and
any other payload) as "no stamp", so mixed-version committees degrade
to RTT-only instrumentation instead of failing.  ACK bytes are not part
of the wire ledger, so stamping does not perturb the goodput A/B.
"""

from __future__ import annotations

import struct
from typing import Dict, Optional, Tuple

from .. import metrics
from ..utils.clock import wall_now

_ACK_MAGIC = b"Ack"
_STAMP = struct.Struct("<d")
_STAMPED_LEN = len(_ACK_MAGIC) + _STAMP.size

# Clock-filter knobs (module constants, not env: the estimator must be
# bit-reproducible under sim, and nothing about them is deployment-
# shaped).  A sample is trusted when its RTT is within _RTT_GATE of the
# best RTT seen — fatter round-trips put the midpoint anywhere.
_RTT_GATE = 2.0
_EWMA_ALPHA = 0.2


def stamp_ack() -> bytes:
    """The ACK payload a receiver handler writes: magic + responder's
    wall clock at validation time."""
    return _ACK_MAGIC + _STAMP.pack(wall_now())


def parse_ack(payload: bytes) -> Optional[float]:
    """The responder's wall stamp, or None for a legacy/foreign ACK."""
    if len(payload) == _STAMPED_LEN and payload.startswith(_ACK_MAGIC):
        return _STAMP.unpack_from(payload, len(_ACK_MAGIC))[0]
    return None


class OffsetEstimator:
    """Smoothed (peer_clock - my_clock) from RTT-filtered ACK samples."""

    __slots__ = ("offset_s", "uncertainty_s", "min_rtt_s", "samples")

    def __init__(self) -> None:
        self.offset_s: Optional[float] = None
        self.uncertainty_s: Optional[float] = None
        self.min_rtt_s: Optional[float] = None
        self.samples = 0

    def add(self, offset_s: float, rtt_s: float) -> bool:
        """Fold in one sample; True if it passed the RTT gate."""
        rtt_s = max(0.0, rtt_s)
        if self.min_rtt_s is None or rtt_s < self.min_rtt_s:
            self.min_rtt_s = rtt_s
        elif rtt_s > self.min_rtt_s * _RTT_GATE + 1e-4:
            # Fat round-trip: queueing/retransmission noise dominates the
            # midpoint.  (The +1e-4 floor keeps the gate permissive when
            # min RTT is ~0, e.g. loopback and the sim's 1 ms grid.)
            return False
        bound = rtt_s / 2.0
        if self.offset_s is None:
            self.offset_s = offset_s
            self.uncertainty_s = bound
        else:
            a = _EWMA_ALPHA
            self.offset_s += a * (offset_s - self.offset_s)
            self.uncertainty_s += a * (bound - self.uncertainty_s)
        self.samples += 1
        return True


# Per-peer estimators, keyed by (source label, peer address) like the
# per-peer RTT instruments (network/reliable_sender._peer_instruments).
# In production the source label is "" — one process IS one node, every
# sender talking to the same peer feeds the same estimate, and the
# gauges above are exported.  The simulation runs the whole committee in
# ONE process against ONE registry, so its channels pass their node
# label as ``src``: estimates stay per-(src, dst) — never mixed across
# differently-skewed virtual nodes — and are read back through
# :func:`offsets_by_source` instead of gauges.
_ESTIMATORS: Dict[Tuple[str, str], Tuple[OffsetEstimator, object, object]] = {}


def _peer_clock(src: str, address: str):
    entry = _ESTIMATORS.get((src, address))
    if entry is None:
        entry = (
            OffsetEstimator(),
            metrics.gauge(f"clock.offset_ms.{address}") if not src else None,
            metrics.gauge(f"clock.offset_uncertainty_ms.{address}")
            if not src
            else None,
        )
        _ESTIMATORS[(src, address)] = entry
    return entry


def record_ack_sample(
    address: str,
    t_send: float,
    t_recv: float,
    t_peer: float,
    src: str = "",
) -> None:
    """Fold one stamped ACK exchange into ``address``'s offset estimate
    and refresh its gauges.  All stamps are ``wall_now()`` readings:
    ``t_send``/``t_recv`` on our clock, ``t_peer`` on the responder's."""
    est, g_off, g_unc = _peer_clock(src, address)
    offset = t_peer - (t_send + t_recv) / 2.0
    if est.add(offset, t_recv - t_send) and g_off is not None:
        g_off.set(round(est.offset_s * 1000.0, 3))
        g_unc.set(round(est.uncertainty_s * 1000.0, 3))


def peer_offset_ms(address: str, src: str = "") -> Optional[float]:
    """Current smoothed offset for ``address`` in ms, if estimated."""
    entry = _ESTIMATORS.get((src, address))
    if entry is None or entry[0].offset_s is None:
        return None
    return entry[0].offset_s * 1000.0


def offsets_by_source() -> Dict[str, Dict[str, Dict[str, float]]]:
    """Every current estimate, grouped by source label — the sim
    harness's read path (its shared registry cannot carry per-node
    gauges): ``{src: {addr: {offset_ms, uncertainty_ms, samples}}}``."""
    out: Dict[str, Dict[str, Dict[str, float]]] = {}
    for (src, addr), (est, _, _) in _ESTIMATORS.items():
        if est.offset_s is None:
            continue
        out.setdefault(src, {})[addr] = {
            "offset_ms": round(est.offset_s * 1000.0, 3),
            "uncertainty_ms": round((est.uncertainty_s or 0.0) * 1000.0, 3),
            "samples": est.samples,
        }
    return out


def reconcile_zero_mean(
    peer_offsets_ms: Dict[str, Dict[str, float]]
) -> Dict[str, float]:
    """Committee-wide reconciliation: pairwise estimates only fix clock
    DIFFERENCES, so anchor the committee mean to zero and give node ``n``
    (with ``k`` measured peers) the correction

        c_n = -(k / (k+1)) * mean_p(offset_ms[n][p])

    With a full peer vector (k = N-1) this is exactly ``skew_n -
    mean(skew)``: each peer offset estimates ``skew_p - skew_n``, so the
    mean is ``(S - skew_n)/(N-1) - skew_n`` and the scaling recovers the
    deviation from the committee mean.  Corrected stamp = raw - c_n/1000.
    Each node's correction needs only its OWN peer vector — every
    snapshot is self-sufficient, no address→node identity map required.
    """
    out: Dict[str, float] = {}
    for node, peers in peer_offsets_ms.items():
        vals = [v for v in peers.values() if v is not None]
        if not vals:
            out[node] = 0.0
            continue
        k = len(vals)
        out[node] = -(k / (k + 1.0)) * (sum(vals) / k)
    return out


def reset_estimators() -> None:
    """Drop all per-peer state (sim cross-run isolation: the registry's
    ``clock.*`` gauges are deleted between runs, and a retained smoothed
    estimate would leak the previous run's committee into this one)."""
    _ESTIMATORS.clear()

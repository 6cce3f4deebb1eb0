"""The NARWHAL_* environment-variable registry and its typed accessors.

Every env knob the port reads is DECLARED here — name, type, documented
default, one doc line — and read through the typed accessors below; an
undeclared name raises at the read.  The port declares only the knobs
its own modules read: the reference's registry
(``narwhal_tpu/utils/env.py``) holds the rest, and each comes across
with the slice that first reads it.

Parsing behavior shared by every accessor: accept a valid override, fall
back LOUDLY on garbage, and warn once per (name, raw value) rather than
at call-site frequency.  Flags parse uniformly: unset → the declared
default; set → false only for ``0``/empty/``false``/``no``/``off``
(case-insensitive), true otherwise.
"""

from __future__ import annotations

import functools
import logging
import os
from dataclasses import dataclass
from typing import Dict, Mapping, Optional

log = logging.getLogger("narwhal.config")

_UNSET = object()


@dataclass(frozen=True)
class EnvVar:
    """One declared knob.  ``default`` is the value the accessors fall
    back to when the variable is unset (``None`` = no value / feature
    off)."""

    name: str
    kind: str  # "flag" | "int" | "str"
    default: object
    doc: str


_VARS = [
    # -- protocol and wire ----------------------------------------------------
    EnvVar(
        "NARWHAL_WIRE_V2", "flag", True,
        "Wire-format v2 master switch (per-peer frame coalescing, "
        "per-connection digest-reference compression, compact varint/"
        "key-index encodings, residual deflate). `0` is the byte-"
        "identical legacy arm the paired wire A/B runs against; the "
        "flag is committee-wide — mixed-version committees are not "
        "supported.",
    ),
    EnvVar(
        "NARWHAL_COMMIT_RULE", "str", "classic",
        "Commit rule (equivalent of `node run --commit-rule`): `classic` "
        "(Tusk — leader commits at depth 3 on f+1 support), `lowdepth` "
        "(Mysticeti-style — leader commits the moment 2f+1 round-(L+1) "
        "certificates cite it), or `multileader` (Mysticeti multi-slot "
        "— 3 round-salted leader slots per even round, the commit "
        "anchors on the lowest 2f+1-supported slot); each non-classic "
        "rule is judged against its own frozen oracle. Committee-wide: "
        "mixed-rule committees diverge by design and fail the safety "
        "replay; checkpoints refuse a cross-rule restore.",
    ),
    EnvVar(
        "NARWHAL_CERT_SIG_SCHEME", "str", "individual",
        "Certificate signature scheme (equivalent of `node run "
        "--cert-sig-scheme`): `individual` (2f+1 ed25519 vote "
        "signatures per certificate) or `halfagg` (ed25519 "
        "half-aggregation — the vote quorum folds into one 32*(q+1)-"
        "byte blob at assembly and sanitization verifies ONE multiexp "
        "equation per certificate, at the `certificate_agg` crypto "
        "site). Committee-wide: a certificate frame from the other "
        "scheme refuses at decode (counted into "
        "primary.invalid_signatures) and a consensus checkpoint "
        "written under one scheme refuses to restore under the other. "
        "Default individual — the flip is gated on the "
        "measurement ladder (benchmark/trajectory_gate.json).",
    ),
    # -- observability --------------------------------------------------------
    EnvVar(
        "NARWHAL_METRICS", "flag", True,
        "`0` swaps the per-process instrument registry for no-ops "
        "(instrumented code needs no enabled-checks).",
    ),
    EnvVar(
        "NARWHAL_TRACE_CAP", "int", 32_768,
        "Stage-trace table capacity before eviction "
        "(`metrics.trace_evictions` counts overflow).",
    ),
    EnvVar(
        "NARWHAL_FLIGHT", "flag", True,
        "`0` stubs the flight recorder's event ring without touching "
        "the rest of the metrics plane.",
    ),
    EnvVar(
        "NARWHAL_FLIGHT_CAP", "int", 512,
        "Flight-recorder ring capacity (events kept; oldest evicted).",
    ),
    # -- crypto backend -------------------------------------------------------
    EnvVar(
        "NARWHAL_CRYPTO_BACKEND", "str", "cpu",
        "Signature-verification backend selected at node boot (equivalent "
        "of `node run --crypto-backend`): `cpu` (serial OpenSSL / "
        "pure-Python fallback) or `cuda` (the batched verifier in "
        "ops/ed25519.py, one hand-written CUDA kernel launch per batch).",
    ),
    EnvVar(
        "NARWHAL_CRYPTO_BACKEND_STRICT", "flag", True,
        "`1` (default): a requested cuda backend that fails to build or "
        "load raises at boot with the error. `0`: log the error and "
        "fall back to the cpu backend — an explicit choice, never a "
        "silent downgrade mid-burst.",
    ),
    EnvVar(
        "NARWHAL_VERIFY_MESH", "flag", False,
        "EXPERIMENTAL: split the batched verify across every visible "
        "CUDA device (one equal shard of the padded batch per card, each "
        "launched on its card before any is awaited) so crypto "
        "throughput scales with cards; single-card hosts run the "
        "single-launch kernel.",
    ),
]

REGISTRY: Dict[str, EnvVar] = {v.name: v for v in _VARS}
assert len(REGISTRY) == len(_VARS), "duplicate EnvVar declaration"


def declared(name: str) -> EnvVar:
    """The declaration for ``name``; raises on an undeclared knob."""
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"{name} is not declared in narwhal_tpu_torch/utils/env.py REGISTRY "
            "— declare it (name, type, default, doc) before reading it"
        ) from None


def env_raw(
    name: str, env: Optional[Mapping[str, str]] = None
) -> Optional[str]:
    """The raw string value (or None), with the declaration check.
    ``env`` overrides ``os.environ`` for injectable call sites."""
    declared(name)
    return (os.environ if env is None else env).get(name)


_FALSE = {"", "0", "false", "no", "off"}


def env_flag(
    name: str,
    default: object = _UNSET,
    env: Optional[Mapping[str, str]] = None,
) -> bool:
    raw = env_raw(name, env)
    if raw is None:
        d = REGISTRY[name].default if default is _UNSET else default
        return bool(d)
    return raw.strip().lower() not in _FALSE


def env_str(
    name: str,
    default: object = _UNSET,
    env: Optional[Mapping[str, str]] = None,
):
    raw = env_raw(name, env)
    if raw is not None:
        return raw
    return REGISTRY[name].default if default is _UNSET else default


@functools.lru_cache(maxsize=128)
def _parse_number(name: str, raw: str, caster, fallback) -> object:
    # Memoized per raw value: misconfiguration must warn once, not at
    # call-site frequency.
    try:
        return caster(raw)
    except (TypeError, ValueError):
        log.warning(
            "%s=%r is not a valid %s; using %r",
            name, raw, caster.__name__, fallback,
        )
        return fallback


def env_int(
    name: str,
    default: object = _UNSET,
    env: Optional[Mapping[str, str]] = None,
):
    raw = env_raw(name, env)
    d = REGISTRY[name].default if default is _UNSET else default
    if raw is None:
        return d
    if not isinstance(raw, str):  # injected mapping may carry parsed values
        return int(raw)
    return _parse_number(name, raw, int, d)


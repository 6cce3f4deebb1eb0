"""Identity layer: digests, ed25519 keys/signatures, signature service.

Mirrors the capability surface of the reference `crypto` crate
(reference crypto/src/lib.rs): a 32-byte `Digest` newtype, a `Hash` seam
(here: objects expose `.digest()`), ed25519 keypairs, single `verify` and
batched `verify_batch`, and a `SignatureService` that serializes signing.

This module is also the backend seam for GPU execution: `set_backend("cuda")`
routes `verify_batch` through the batched CUDA verification kernel in
`narwhal_tpu_torch.ops.ed25519` (reference's per-certificate
`Signature::verify_batch`, crypto/src/lib.rs:206-219, is the #1 crypto hot
loop per SURVEY.md §3.3).
"""

from .digest import Digest, digest32
from .keys import KeyPair, PublicKey, SecretKey, Signature
from .aggregate import (
    AggregateSignature,
    SchemeMismatch,
    aggregate_votes,
)
from .service import SignatureService
from .backend import (
    set_backend,
    get_backend,
    verify,
    verify_aggregate,
    verify_batch,
    verify_batch_mask,
)

__all__ = [
    "AggregateSignature",
    "Digest",
    "digest32",
    "KeyPair",
    "PublicKey",
    "SchemeMismatch",
    "SecretKey",
    "Signature",
    "SignatureService",
    "aggregate_votes",
    "set_backend",
    "get_backend",
    "verify",
    "verify_aggregate",
    "verify_batch",
    "verify_batch_mask",
]

from .tusk import (
    COMMIT_RULES,
    CheckpointRuleMismatch,
    Consensus,
    LowDepthTusk,
    MultiLeaderTusk,
    State,
    Tusk,
    leader_slots,
    resolve_commit_rule,
)

__all__ = [
    "COMMIT_RULES",
    "CheckpointRuleMismatch",
    "Consensus",
    "LowDepthTusk",
    "MultiLeaderTusk",
    "State",
    "Tusk",
    "leader_slots",
    "resolve_commit_rule",
]

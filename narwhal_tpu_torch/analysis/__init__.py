"""narwhal-lint: the codebase-specific invariant linter (+ runtime
loop-stall watchdog in :mod:`.watchdog`).

Static rules live in :mod:`.rules`, the framework (file loading,
pragmas, findings, overlays) in :mod:`.linter`.  Entry points:

    python -m narwhal_tpu.analysis              # lint, exit 1 on findings
    python -m narwhal_tpu.analysis --env-table  # README env-var table
    make lint                                   # compile + flake8 + this

Kept import-light (stdlib + narwhal_tpu.utils.env only): the lint CI job
runs without jax.
"""

from .linter import Finding, load_project, run_lint  # noqa: F401

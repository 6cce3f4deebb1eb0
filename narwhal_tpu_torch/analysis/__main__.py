"""CLI of the invariant linter.

    python -m narwhal_tpu_torch.analysis [--root DIR] [--report out.json]
    python -m narwhal_tpu_torch.analysis --env-table

Exit status: 0 = clean tree, 1 = findings (CI gates on this), 2 = bad
invocation.  ``--report`` additionally writes the findings as JSON for
the CI artifact upload.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .linter import run_lint


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="narwhal-lint")
    ap.add_argument(
        "--root",
        default=None,
        help="Repository root (default: auto-detected from this package)",
    )
    ap.add_argument(
        "--report",
        default=None,
        help="Also write findings as a JSON report to this path",
    )
    ap.add_argument(
        "--env-table",
        action="store_true",
        help="Print the generated README env-var table and exit",
    )
    args = ap.parse_args(argv)

    if args.env_table:
        from ..utils.env import TABLE_BEGIN, TABLE_END, render_table

        print(TABLE_BEGIN)
        print(render_table())
        print(TABLE_END)
        return 0

    root = args.root or os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    if not os.path.isdir(os.path.join(root, "narwhal_tpu_torch")):
        print(f"--root {root!r} does not contain narwhal_tpu_torch/", file=sys.stderr)
        return 2

    findings = run_lint(root)
    if args.report:
        os.makedirs(os.path.dirname(args.report) or ".", exist_ok=True)
        with open(args.report, "w", encoding="utf-8") as f:
            json.dump(
                {
                    "root": root,
                    "findings": [x.as_dict() for x in findings],
                    "count": len(findings),
                },
                f,
                indent=1,
            )
    for finding in findings:
        print(finding.render())
    if findings:
        print(
            f"\nnarwhal-lint: {len(findings)} finding(s). Fix them or "
            "suppress per-site with `# lint: allow-<rule>(reason)` "
            "(see README 'Static analysis').",
            file=sys.stderr,
        )
        return 1
    print("narwhal-lint: clean")
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:
        # stdout piped into a pager/head that closed early; not an error.
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        sys.exit(0)

"""The knee sweep: one cell at a few offered rates, ``--repeat`` runs each,
and the knee (``measure.knee``): the highest rate below the lowest one
that does not keep up.  A rate keeps up (``measure.keeps_up``) where its
runs' mean committed share of the offered rate is no more than 5 points
below the lowest rate's, and in each of its runs the median latency of
the window's last third is no more than 10 % above its first third's.

    python3 -m portbench.sweep --workload local4-steady --seed 5 \
        --seconds 20 --rates 20480,25600,32000 --repeat 2

Prints one JSON line a run and a last line with the knee.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

from . import measure


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--repeat", type=int, default=1)
    args = p.parse_args(argv)
    rows = []
    seed = args.seed
    for rate in (int(r) for r in args.rates.split(",")):
        for _ in range(args.repeat):
            out = subprocess.run(
                [sys.executable, "-m", "portbench.run", "--workload", args.workload,
                 "--seed", str(seed), "--seconds", str(args.seconds), "--trace", "0",
                 "--rate", str(rate)], capture_output=True, text=True)
            seed += 1
            notes = next((json.loads(line.split("notes ", 1)[1])
                          for line in out.stderr.splitlines()
                          if line.startswith("portbench: notes ")), None)
            result = json.loads(out.stdout.strip().splitlines()[-1]) if out.returncode == 0 else None
            row = {"rate": rate, "rc": out.returncode, "notes": notes,
                   "metrics": result and {k: v["value"] for k, v in result["metrics"].items()},
                   "checks": result and {k: v["value"] for k, v in result["checks"].items()},
                   "correct": result and result["correct"]}
            if out.returncode != 0:
                row["stderr"] = out.stderr[-1500:]
            print(json.dumps(row), flush=True)
            if notes:
                rows.append((rate, notes["committed_tps"], notes["thirds_ms"]))
    print(json.dumps({"knee": measure.knee(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

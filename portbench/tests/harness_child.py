"""A small harness for the supervisor tests: starts children through a
:class:`~portbench.supervisor.Supervisor` as one scenario asks, tears
down as a run does, and prints one JSON line: every pid the scenario
made, the processes the teardown killed, and what a last walk of
``/proc`` found.

    python3 -m portbench.tests.harness_child <scenario> <pid file>

Each child and grandchild appends its pid to ``<pid file>``.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import time

from portbench.supervisor import Interrupted, Supervisor, descendants, signals_raise

_NOTE = "import os; open({f!r}, 'a').write(f'{{os.getpid()}}\\n')"

SCENARIOS = {
    # a child that ignores SIGTERM
    "ignores_term": "import signal, time; {note}; signal.signal(signal.SIGTERM, signal.SIG_IGN); time.sleep(120)",
    # a child that forks a grandchild and exits
    "forks_and_exits": "import os, time; {note}\nif os.fork() == 0:\n    {note}; time.sleep(120)\nos._exit(0)",
    # a grandchild that calls setsid
    "setsid_grandchild": "import os, time; {note}\nif os.fork() == 0:\n    os.setsid(); {note}; time.sleep(120)\ntime.sleep(120)",
    # children that only sleep (the harness is SIGKILLed meanwhile)
    "sleepers": "import time; {note}; time.sleep(120)",
}


def main() -> int:
    scenario, pid_file = sys.argv[1], sys.argv[2]
    code = SCENARIOS[scenario].format(note=_NOTE.format(f=pid_file))
    sup = Supervisor()
    out = {}
    try:
        with signals_raise(60.0):
            for i in range(2):
                sup.start(f"child-{i}", [sys.executable, "-c", code],
                          os.path.join(os.path.dirname(pid_file), f"child-{i}.log"))
            expect = {"forks_and_exits": 4, "setsid_grandchild": 4}.get(scenario, 2)
            end = time.monotonic() + 20
            while time.monotonic() < end:
                with open(pid_file) if os.path.exists(pid_file) else open(os.devnull) as f:
                    if len(f.read().split()) >= expect:
                        break
                time.sleep(0.05)
            print("ready", flush=True)
            if scenario == "sleepers":
                time.sleep(120)
    except Interrupted:
        pass
    finally:
        out["term_codes"] = sup.stop(list(sup.procs), signal.SIGTERM, 1.0)
        out["killed"] = sup.reap_all()
        out["left"] = descendants(os.getpid())
    with open(pid_file) as f:
        out["pids"] = [int(x) for x in f.read().split()]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

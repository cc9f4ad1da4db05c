"""Time `chip_smoke.py` of several trees of the repo, one after another,
on the same card: the way to compare two commits' smokes, whose times move
with the host from one machine to the next.

Unpack each tree first, into a directory that .gitignore lists:

    git archive <commit> | tar -x -C build/trees/<name>

then run, on the machine with the card, from the repo's root:

    python3 tools/time_smoke_torch.py --limit 800 build/trees/a build/trees/b ...

Each tree's smoke runs from its own directory in a process group of its
own, killed at `--limit` seconds (rc 124). Its output goes to
chiprun_out/smoke_<i>_<name>.log; each run's exit code and seconds are
printed as a JSON line and, all together, written to
chiprun_out/smoke_times.json.
"""

import argparse
import json
import os
import signal
import subprocess
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="+", help="directories holding a tree of the repo, run in this order")
    ap.add_argument("--limit", type=float, default=800.0, help="seconds a smoke may take")
    args = ap.parse_args(argv)
    out = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chiprun_out")
    os.makedirs(out, exist_ok=True)
    summary = []
    for i, tree in enumerate(args.trees):
        name = os.path.basename(os.path.normpath(tree))
        log = os.path.join(out, f"smoke_{i}_{name}.log")
        t0 = time.perf_counter()
        with open(log, "w") as f:
            proc = subprocess.Popen([sys.executable, "chip_smoke.py"], cwd=tree, stdout=f, stderr=subprocess.STDOUT,
                                    start_new_session=True)
            try:
                rc = proc.wait(timeout=args.limit)
            except subprocess.TimeoutExpired:
                rc = 124
            try:  # the smoke's children too
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()
        summary.append({"run": i, "tree": name, "rc": rc, "seconds": time.perf_counter() - t0})
        print(json.dumps(summary[-1]), flush=True)
    with open(os.path.join(out, "smoke_times.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return 0 if all(r["rc"] == 0 for r in summary) else 1


if __name__ == "__main__":
    sys.exit(main())

"""The spread of each end-to-end metric over a set of runs, from which a
bound is set: the distance between the first and third quartiles as a
share of the median (window.spread).

    python3 benchmark/spreads.py RUN.out [RUN.out ...]

Each file holds a run's output, its result the last line.  Prints, per
cell and metric, the runs' values, their median and spread, and whether
every run was correct.
"""

import json
import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import window  # noqa: E402


def main(argv=None) -> int:
    rows = {}
    correct = True
    for path in argv if argv is not None else sys.argv[1:]:
        with open(path) as f:
            lines = f.read().strip().splitlines()
        res = json.loads(lines[-1]) if lines else {}
        correct = correct and bool(res.get("correct"))
        for name, m in res.get("metrics", {}).items():
            rows.setdefault(name, []).append(m["value"])
    for name, vals in sorted(rows.items()):
        out = {"metric": name, "runs": len(vals),
               "median": statistics.median(vals), "values": vals}
        if len(vals) >= 2:
            out["spread"] = window.spread(vals)
        print(json.dumps(out))
    print(json.dumps({"all_correct": correct}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

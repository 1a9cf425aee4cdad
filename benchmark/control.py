"""Readings for the limits of a cell's compared numbers: the program's
sound runs and the control, on many seeds in one process, at the cell's
own size and load (a short window each).

    python3 benchmark/control.py --workload ai_faster_d416.file \
        --seconds 8 --seeds 11 12 13

For each seed: one run of the cell through the harness (the program's
numbers, the lower readings), then the same kept outputs judged with the
control in the program's place (the upper readings): the reference's
plan computed in bfloat16, the nearest precision below the float32 that
the configuration's planning states.
Prints a JSON line a seed; the limits are set from them by hand
(limits/<cell>.json).  The benchmark's own runs never run the control.
"""

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_numbers(run) -> dict:
    """The control's numbers for the plans that `run` kept."""
    from benchmark import check
    shift = run.cfg["internal_bit_depth"] - run.cfg["input_bit_depth"]
    out = check.judge_plans(run.probes.plans,
                            [p[0] for p in run.driver_pictures], shift,
                            run.plan_sample, control=True)
    out["plans_missing"] = len(run.plan_sample) - out["plans_judged"]
    return out


def readings(workload, seeds, seconds, device="cuda"):
    from benchmark import check, spec
    from benchmark.harness import Run, run_cell
    bench = spec.load_benchmark()
    for seed in seeds:
        run = Run(bench, workload, seed, seconds, False, device=device)
        out = run_cell(run, time.time())
        prog = {n: v for n, v, _ in out["checks"]}
        ctl = control_numbers(run)
        ok, _ = check.verdict(ctl, {k: v for k, v in run.limits.items()
                                    if k in ctl})
        yield {"seed": seed, "correct": out["correct"], "program": prog,
               "control": ctl, "control_correct": ok,
               "info": out["info"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    for row in readings(args.workload, args.seeds, args.seconds,
                        args.device):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""A cell's control: the plain reference put in the program's place with
one guarantee of the configuration broken (the configuration's
``control``, reference/controls.py), judged by the comparison a run makes.
Every seed must fail a run's limits (``mismatched_lines`` 0).

    python3 -m mrbench.control --workload <name> --seeds 1,2,3 --jobs <n>

from the root of a checkout. For each seed it makes the pool a run with
that seed makes and takes the first ``n`` jobs of the window's order (pass
as many as a run's window completes), on the cards the cell asks for. One
JSON line per seed. The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

from mrbench import chip, harness, pool as pool_mod
from mrbench.reference.controls import CONTROLS


def control_checks(cell: harness.Cell, pool, jobs: int) -> tuple[dict, int]:
    """The numbers a run compares, for the control's answers to the
    window's first ``jobs`` jobs, and how many of those jobs it got wrong."""
    ref = importlib.import_module(f"mrbench.reference.{cell.config['app']}")
    control = CONTROLS[cell.config["control"]]
    program = cell.config["program"]
    reduce_n = int(program["reduce_n"])
    bad, bad_jobs = 0, 0
    for k in range(jobs):
        f = pool.file_for(k)
        ids, counts = pool.truth[f]
        want = ref.expected(pool.words, pool.parts, ids, counts, reduce_n)
        lines = control(pool.words, pool.parts, ids, counts, reduce_n, pool.files[f],
                        program)
        n = ref.mismatched_lines([b"".join(x + b"\n" for x in p) for p in lines], want)
        bad += n
        bad_jobs += int(n > 0)
    return ({"mismatched_lines": {"value": bad, "limit": 0},
             "jobs_checked": {"value": jobs, "min": 1}}, bad_jobs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m mrbench.control",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--jobs", type=int, required=True)
    args = ap.parse_args(argv)
    cell = harness.load_cell(os.getcwd(), args.workload)
    try:
        card = chip.open_card(cell.chips)
    except chip.NoCard as e:
        print(f"mrbench.control: {e}", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        pool = pool_mod.build(cell.config, cell.traffic, seed, card.generator_device,
                              int(cell.config["program"]["reduce_n"]))
        try:
            checks, failed = control_checks(cell, pool, args.jobs)
            print(json.dumps({"workload": cell.name, "seed": seed,
                              "control": cell.config["control"],
                              "correct": harness.passed(checks) and failed == 0,
                              "failed": failed, "checks": checks, "kind": card.kind,
                              "seconds": time.perf_counter() - t0}), flush=True)
        finally:
            pool.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

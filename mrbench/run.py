"""Run one cell of ``BENCHMARK.json`` and print its result as the last line
of standard output:

    python3 -m mrbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. With ``--trace 0`` the line carries the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, the device's
busy and window seconds and a breakdown. The numbers compared with the
reference, each with its limit, are the line's last key (``checks``) and
the last lines of standard error. Exits non-zero and prints no result
without the cards the cell asks for, or if JAX or the JAX package was
loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from mrbench import chip, harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m mrbench.run",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        cell = harness.load_cell(os.getcwd(), args.workload)
        card = chip.open_card(cell.chips)
        result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                                  T_START, card)
    except (harness.Refused, chip.NoCard) as e:
        print(f"mrbench: {e}", file=sys.stderr)
        return 2
    leaked = harness.leaked_modules()
    if leaked:
        print(f"mrbench: the run loaded {', '.join(leaked)}; no result", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        bound = f"limit {c['limit']}" if "limit" in c else f"min {c['min']}"
        print(f"check {name} {c['value']} {bound}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Read the check's numbers of one cell on many seeds in one process.

    python3 portbench/readings.py --workload frame-eval-h5 --seconds 3 --seeds 1 2 3 [--control default]

Each seed is a whole run of the cell (set-up, a short window, the check) as
``run.py`` makes it, without a process and a CUDA context of its own; one
line a seed: the seed, ``correct`` and each number compared.  The limits in
``workloads/<cell>.json`` are set from these readings: the program's on a
dozen seeds or more, the control's (``--control``) on three or more.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    from portbench import run

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", choices=("default", "bf16"), default=None)
    args = p.parse_args(argv)
    for seed in args.seeds:
        res = run.run_cell(args.workload, seed, args.seconds, False, control=args.control,
                           log=lambda s: None, readings=True)
        print(json.dumps({"seed": seed, "control": args.control, "correct": res["correct"],
                          **res["readings"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

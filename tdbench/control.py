"""Run the controls of ``reference/control.py`` in the port's place.

    python3 tdbench/control.py --workload <cell> --seeds 1,2,3 \\
        --seconds 20 [--control misses_as_bytes --control ...]

For each control and seed: a run of the cell at its own sizes (its
configuration and traffic from the seed), with the control answering every
call of a window of ``--seconds`` and every call checked against the
reference as ``run.py`` checks the port's. Prints one JSON line each with
the compared numbers; a control must come out as not correct. The
benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parent.parent)

from tdbench import run  # noqa: E402
from tdbench.reference.control import CONTROLS, program  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--control", action="append", choices=sorted(CONTROLS))
    args = ap.parse_args(argv)
    _, _, _, mix = run.load_cell(args.workload)
    mix = dict(mix, check_share=1.0)
    for name in args.control or sorted(CONTROLS):
        for seed in (int(s) for s in args.seeds.split(",")):
            t = time.perf_counter()
            result, compared = run.run_cell(
                args.workload, seed, args.seconds, False, device="cpu",
                mix=mix, program=program(name), t0=t)
            print(json.dumps({
                "workload": args.workload, "control": name, "seed": seed,
                "correct": result["correct"], "calls": result["attempted"],
                "check": {n: v for n, v, _, _ in compared},
                "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

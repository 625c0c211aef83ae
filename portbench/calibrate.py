"""Readings that the correctness limits are set from, on the card:

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,3 \\
        --seconds 10

One run of the cell a seed, all in this process (the kernels are built
once): set-up, a window of ``--seconds``, and the numbers compared for the
program and for the control (the reference with fp8 activations at the
same positions, :mod:`.reference.compare`), each judged by
:func:`.run.judge` against ``limits/<cell>.json``: the control in the
program's place has to come out not correct. One JSON line a seed:
``{"seed", "correct", "checks", "control_correct", "control_checks",
"numbers", "control", "metrics"}``, where ``numbers`` and ``control`` hold
every number the comparison reads, compared or not. The benchmark's own
runs never run the control.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from . import run, spec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    run.set_environment(run.ROOT)
    import torch
    if not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload, run.ROOT)
    torch.set_num_threads(run.THREADS)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        r = run.run_cell(cell, seed, args.seconds, False, "cuda", t,
                         control=True)
        print(json.dumps({"seed": seed, "correct": r["correct"],
                          "checks": r["checks"],
                          "control_correct": r["control_correct"],
                          "control_checks": r["control_checks"],
                          "numbers": r["numbers"], "control": r["control"],
                          "metrics": r["metrics"],
                          "setup_parts": r["setup_parts"],
                          "wall_s": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

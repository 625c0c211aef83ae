#!/usr/bin/env python3
"""Seconds each phase of ``chip_smoke.py`` takes, for one or more checkouts
run one after the other on the same machine.

    python3 tools/torch_phase_times.py parent=chip_check/parent change=.
    python3 tools/torch_phase_times.py --summary chiprun_out/stamp_*.log

Each ``LABEL=ROOT`` runs ``ROOT/chip_smoke.py`` from ``ROOT`` and writes its
standard output (errors merged), each line prefixed by the seconds since
that run began, to ``chiprun_out/stamp_LABEL.log``. A phase's time is the
time from the line before its first line to its last line, summed over the
places where it appears; ``--summary`` prints that table for stamped logs,
one column a log. The exit code is the largest of the runs'.
"""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def phase_seconds(lines):
    """``{phase: seconds}`` and the last stamp from stamped lines."""
    out, last, prev = {}, 0.0, 0.0
    for line in lines:
        stamp, _, rest = line.partition(" ")
        last = float(stamp)
        try:
            phase = json.loads(rest).get("phase")
        except (ValueError, AttributeError):
            continue
        if phase is not None:
            out[phase] = out.get(phase, 0.0) + last - prev
            prev = last
    return out, last


def summary(paths):
    cols = []
    for path in paths:
        with open(path) as f:
            cols.append(phase_seconds(f))
    names = [os.path.basename(p) for p in paths]
    print("phase " + " ".join(names))
    order = []
    for seconds, _ in cols:
        order += [p for p in seconds if p not in order]
    for phase in order:
        print(phase + " " + " ".join(f"{s.get(phase, 0.0):.1f}"
                                     for s, _ in cols))
    print("last_line_s " + " ".join(f"{last:.1f}" for _, last in cols))


def run(specs, out_dir):
    os.makedirs(out_dir, exist_ok=True)
    rcs, paths = [], []
    for spec in specs:
        label, root = spec.split("=", 1)
        path = os.path.join(out_dir, f"stamp_{label}.log")
        t0 = time.perf_counter()
        p = subprocess.Popen([sys.executable, "chip_smoke.py"], cwd=root,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
        with open(path, "w") as f:
            for line in p.stdout:
                f.write(f"{time.perf_counter() - t0:.3f} {line}")
        rcs.append(p.wait())
        paths.append(path)
        print(f"{label}: rc {rcs[-1]}", flush=True)
    summary(paths)
    return max(rcs)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("runs", nargs="+", help="LABEL=ROOT, or stamped logs "
                                            "with --summary")
    ap.add_argument("--summary", action="store_true")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out"))
    args = ap.parse_args()
    if args.summary:
        summary(args.runs)
        return 0
    return run(args.runs, args.out)


if __name__ == "__main__":
    sys.exit(main())

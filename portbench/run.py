"""Run one cell of ``BENCHMARK.json`` once, from the root of a checkout:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The traffic's ``kind`` picks the driver (``drivers/<kind>.py``). Set-up
(counted in ``setup_s``, from the process's start): the port's kernels
built or found built (``build_s``, reported apart under ``setup_parts``),
the weights drawn from the seed on the card and built into the port's
packed and fused tree, the engine and every prefill bucket of the traffic
warmed through the engine's own calls, and a closed loop's first wave
admitted (or one window scored). Then the window: ``--seconds`` of the
timed path, which ends at the first call that ends past it. With
``--trace 1`` the last ``trace_seconds`` of the traffic's window run under
``torch.profiler``, and the per-layer metrics are printed instead of the
end-to-end ones.

After the window: the peak of device memory is read, the program is freed,
and the plain reference judges a sample of what the window produced
(:mod:`.reference.compare`) against ``limits/<cell>.json`` by
:func:`judge`. The last lines on standard error give each number compared
beside its limit; the last line on standard output is one JSON object.

Exit codes: 2 without a CUDA device (or with fewer than the cell asks
for), 3 when ``jax``, ``jaxlib``, ``flax`` or the JAX package is loaded
after the window, 4 when the port cannot be imported; none prints a result.
"""
from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# top-level module names that may not be loaded in the measured process
FORBIDDEN = ("jax", "jaxlib", "flax", "any4_tpu")
THREADS = 2


def set_environment(root: str) -> None:
    """Caches inside the checkout at fixed paths, and no JAX backend for
    a library that would load one."""
    cache = os.path.join(root, ".portbench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    for key in ("USE_FLAX", "USE_JAX", "USE_TF"):
        os.environ[key] = "0"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def judge(numbers: dict, limits: dict, failed: int):
    """``(correct, compared)``: each number of ``limits`` beside its limit,
    and whether every one has a finite value within it with no request or
    window ``failed``."""
    compared = {}
    for name, limit in limits.items():
        v = numbers.get(name)        # None: nothing to compare, or no number
        compared[name] = {"value": v if v is not None and math.isfinite(v)
                          else None, "limit": limit["limit"]}
    correct = (failed == 0 and bool(compared) and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in compared.values()))
    return correct, compared


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, control: bool = False) -> dict:
    """One run of ``cell`` (a :class:`~.spec.Cell`) on ``device``: the
    result object, with the numbers compared under ``checks``."""
    import torch

    from . import drivers, measure, spec, trace as tracing
    from .record import Run
    device = torch.device(device)
    info, checks = drivers.load(cell.traffic["kind"]).run(
        cell, seed, seconds, trace, device, t_start, control)
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": info["peak"]}
    if device.type == "cuda":
        dev["power_limit_w"] = measure.power_limit()
        dev["clocks_after_window"] = info["clocks"]
    metrics, out = {}, {}
    if trace:
        record = Run(cell.config, cell.traffic,
                     spec.kernel_families(cell.root), info["steps"],
                     info["window"], info["trace"])
        for m in cell.per_layer:
            v = spec.metric_reader(m["name"], cell.root)(record)
            if v is not None and math.isfinite(v):
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if info["trace"] is not None:
            dev["busy_s"] = info["trace"].busy_s
            dev["window_s"] = info["trace"].window_s
            out["breakdown"] = tracing.breakdown(info["trace"])
    else:
        for m in cell.end_to_end:
            v = info["e2e"].get(m["name"])
            if v is not None and math.isfinite(v):
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    correct, compared = judge(checks, cell.limits, info["failed"])
    result = {"correct": correct, "attempted": info["attempted"],
              "failed": info["failed"], "metrics": metrics, "device": dev}
    result.update(out)
    # set-up's parts: a checkout's first run builds the kernels
    result["setup_parts"] = {"build_s": info["build_s"]}
    if control:
        # the control in the program's place, judged by the same limits
        ctl = {k[len("control_"):]: v for k, v in checks.items()
               if k.startswith("control_")}
        result["numbers"] = {k: v for k, v in checks.items()
                             if not k.startswith("control_")}
        result["control"] = ctl
        (result["control_correct"],
         result["control_checks"]) = judge(ctl, cell.limits, 0)
    result["checks"] = compared         # the key that comes last
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_environment(ROOT)
    from . import spec
    cell = spec.load_cell(args.workload, ROOT)
    import torch
    # the host's part of every step is Python and launches: few threads
    torch.set_num_threads(THREADS)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s), "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        import any4_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"portbench: the port does not import: {e}", file=sys.stderr)
        return 4
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", _T0)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded in the measured process: {bad}",
              file=sys.stderr)
        return 3
    sys.stdout.flush()
    clocks = result["device"].get("clocks_after_window")
    print(f"portbench setup: build_s {result['setup_parts']['build_s']!r}; "
          f"clocks after the window {clocks!r}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"portbench check {name}: {c['value']!r} limit "
              f"{c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

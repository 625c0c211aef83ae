"""Shared utilities: timing, tolerant comparison, memory accounting
(counterpart of ``any4_tpu/utils.py``).

Timing takes the device from what the timed function returns: on a CUDA
tensor every call is timed by its own pair of CUDA events after the L2
cache is emptied (:class:`Timer`); on a CPU tensor by the host clock. Any
other output raises: no timing falls back from one clock to the other.
"""
from __future__ import annotations

import statistics
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

# cycles the device spins before a timed window, so that the host queues
# every launch of the window before the first one runs (about 50 ms on an
# H100)
SPIN_CYCLES = 100_000_000


class Timer:
    """Device times of functions, each launch timed by its own pair of CUDA
    events after the 50 MB L2 cache is emptied by reading a 128 MB buffer
    (``dirty=True``: by writing it, which leaves dirty lines that the timed
    kernel's misses must write back first). The device first spins for
    ``SPIN_CYCLES``, so the host queues every launch before the first one
    runs and the events see no host time."""

    def __init__(self, dirty: bool = False, device="cuda"):
        buf = torch.zeros(32 << 20, dtype=torch.float32, device=device)
        self.flush = buf.zero_ if dirty else buf.amax

    def times(self, fns: Dict[str, Callable], reps: int) -> Dict[str, list]:
        """``reps`` device ms of each of ``fns`` (no warm-up), all queued
        behind one spin, each function's launches in a row."""
        events = {name: [(torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                         for _ in range(reps)] for name in fns}
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES)
        for name, fn in fns.items():
            for start, end in events[name]:
                self.flush()
                start.record()
                fn()
                end.record()
        torch.cuda.synchronize()
        return {name: [s.elapsed_time(e) for s, e in ev]
                for name, ev in events.items()}

    def __call__(self, fn: Callable, reps: int = 20, warmup: int = 3) -> float:
        """Median device ms of ``fn`` over ``reps`` launches after
        ``warmup`` untimed calls."""
        for _ in range(warmup):
            fn()
        return statistics.median(self.times({"fn": fn}, reps)["fn"])


def _first_tensor(out) -> Optional[torch.Tensor]:
    """The first tensor in ``out`` (a tensor, or a tuple, list or dict
    holding one), or None."""
    if isinstance(out, torch.Tensor):
        return out
    items = out.values() if isinstance(out, dict) else \
        out if isinstance(out, (tuple, list)) else ()
    for item in items:
        t = _first_tensor(item)
        if t is not None:
            return t
    return None


def _clock(outs) -> Optional[torch.device]:
    """The CUDA device of the outputs, or None for CPU outputs; raises
    unless every output holds a tensor and all are of one kind."""
    devices = [getattr(_first_tensor(r), "device", None) for r in outs]
    kinds = {getattr(d, "type", None) for d in devices}
    if len(kinds) != 1 or not kinds <= {"cuda", "cpu"}:
        raise ValueError(f"timing needs functions that return CUDA tensors "
                         f"or CPU tensors, one kind; got "
                         f"{sorted(map(str, kinds))}")
    return devices[0] if kinds == {"cuda"} else None


def benchmark_in_ms(f: Callable, *args, warmup: int = 3, iters: int = 20,
                    **kwargs) -> float:
    """Median time per call in ms: ``warmup`` untimed calls (the last one's
    output says the device), then ``iters`` timed ones."""
    if warmup < 1:
        raise ValueError("benchmark_in_ms needs warmup >= 1: the warm-up's "
                         "output says which clock to use")
    for _ in range(warmup):
        r = f(*args, **kwargs)
    device = _clock([r])
    if device is not None:
        return statistics.median(Timer(device=device).times(
            {"f": lambda: f(*args, **kwargs)}, iters)["f"])
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        f(*args, **kwargs)
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def best_in_ms(fns: Dict[str, Callable], iters: int = 20, rounds: int = 8,
               timer: Optional[Timer] = None) -> Dict[str, float]:
    """Best-window mean ms per call of each function: each is called once
    untimed, then ``rounds`` windows of ``iters`` calls, the functions'
    windows interleaved round by round, and the best window kept. On CUDA
    every call is timed by its own events after the L2 is emptied (one
    spin a round: ``timer`` or a new :class:`Timer`); on the CPU a window
    is timed by the host clock."""
    outs = {name: fn() for name, fn in fns.items()}
    best = {name: float("inf") for name in fns}
    device = _clock(outs.values())
    if device is not None:
        timer = timer or Timer(device=device)
        for _ in range(rounds):
            for name, ts in timer.times(fns, iters).items():
                best[name] = min(best[name], sum(ts) / iters)
        return best
    for _ in range(rounds):
        for name, fn in fns.items():
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            best[name] = min(best[name],
                             (time.perf_counter() - t0) * 1e3 / iters)
    return best


def benchmark_best_in_ms(f: Callable, *args, iters: int = 20,
                         rounds: int = 8, **kwargs) -> float:
    """Best-window mean ms per call of ``f(*args, **kwargs)``: one untimed
    call, then ``rounds`` windows of ``iters`` calls (:func:`best_in_ms`)."""
    return best_in_ms({"f": lambda: f(*args, **kwargs)}, iters, rounds)["f"]


def assert_close(actual, expected, rtol: float = 1e-2, atol: float = 1e-2,
                 allowed_violations: int = 0, factor: float = 10.0):
    """Tolerance check allowing a bounded number of larger outliers: up to
    ``allowed_violations`` elements may exceed (rtol, atol) as long as they
    stay within ``factor`` times the tolerance. Tensors (any device) or
    arrays, compared in float32."""
    a, e = (x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32) for x in (actual, expected))
    if a.shape != e.shape:
        raise AssertionError(f"shape {a.shape} != {e.shape}")
    err = np.abs(a - e)
    tol = atol + rtol * np.abs(e)
    bad = err > tol
    nbad = int(bad.sum())
    if nbad == 0:
        return
    if nbad > allowed_violations:
        raise AssertionError(
            f"{nbad} violations (> {allowed_violations} allowed); "
            f"max err {err.max():.5f} at tol {tol.flat[np.argmax(err)]:.5f}")
    if not (err[bad] <= factor * tol[bad]).all():
        raise AssertionError(
            f"violations exceed {factor}x tolerance: max ratio "
            f"{(err[bad] / tol[bad]).max():.1f}")


def get_model_size(params) -> int:
    """Total parameter bytes, quantized weights by their fields."""
    from .quant.api import model_size_bytes
    return model_size_bytes(params)


def device_memory_stats(device="cuda") -> Optional[dict]:
    """``torch.cuda.memory_stats`` of a CUDA device; None for the CPU,
    which keeps none (as the JAX package gives for a backend without
    them). Raises for a CUDA device on a machine without one."""
    device = torch.device(device)
    if device.type == "cpu":
        return None
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"no memory statistics for device {device}")
    return dict(torch.cuda.memory_stats(device))
